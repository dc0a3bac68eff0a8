"""Where a GPT-2-small serve spends its time on the card.

    python -m paddle_tpu_torch.tools.serve_profile
        [--kv-quant int8] [--serve-weights int8] [--ragged] [--legacy]
        [--spec-k K [--drafter prompt_lookup|draft_model|self]]
        [--eager] [--runs N] [--no-profile] [--serve-mesh mp=N]
        [--out chiprun_out/serve_profile.json]

Serves the workload of ``chip_smoke.py``'s serve phase
(`gpt2_small_serve`: GPT-2-small at full width, random weights from seed
0, 8 slots, 64-token pages, 16 prompts of 64-512 tokens, half sharing a
128-token prefix, 64 new tokens each; int8 KV pages and int8 weights with
the switches, default off; every step through the unified ragged step with
``--ragged``; speculative decoding of K tokens a round with ``--spec-k``,
drafted by prompt lookup, by a ``draft_config()`` model with random
weights from seed 1, or by GPT-2-small itself; the legacy one-shot prefill
with ``--legacy``; tensor-parallel over N ranks with ``--serve-mesh mp=N``,
which implies the ragged step) twice: once plain, for the wall time, and once under
``torch.profiler`` for the breakdown (``--runs N``: the plain serve N
times, each on a fresh engine, with every run's tokens/s and host seconds
a step; ``--no-profile``: no profiled serve). The steps run as the engine
runs them, one captured CUDA graph per step signature (each engine
captures at its first step of each shape); ``--eager`` runs both serves
under ``disable_capture()`` instead. Prints, and writes to ``--out``: the
wall time of each run; the device's busy time (the sum of every kernel's
and copy's time, one stream so nothing overlaps) and idle share over the
profiled run; the kernels and the PyTorch operators that took the most
device time; the host seconds a step (the serve's wall over its engine
steps) and the host time in each kind of step. Needs a CUDA card; raises
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..inference.serving import DecodeEngine, disable_capture
from ..inference.speculative import DraftModelDrafter
from ..models.gpt import GPT, GPTConfig
from ..device import default_device
from ._device_time import breakdown, card_line

SEED = 0
NEW_TOKENS = 64


def make_prompts(vocab: int, n: int, seed: int, shared_len: int = 128):
    """``n`` prompts of 64-512 tokens; the even ones open with one shared
    ``shared_len``-token prefix and run past it."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, shared_len)
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            tail = rng.randint(0, vocab,
                               rng.randint(shared_len + 1, 513) - shared_len)
            prompts.append(np.concatenate([shared, tail]).tolist())
        else:
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(64, 513)).tolist())
    return prompts


def gpt2_small_serve(device, kv_quant="off", serve_weights="off",
                     ragged_step=False, spec_decode_k=0,
                     drafter="prompt_lookup", chunked_prefill=True):
    """The GPT-2-small serve of ``chip_smoke.py`` and of this profile.

    Returns ``(model, prompts, new_engine)``: GPT-2-small at full width
    (the ``bench.py`` config) with random f32 weights from `SEED`, its 16
    prompts, and a factory of fresh ``DecodeEngine(max_batch_size=8,
    page_size=64, kv_quant=..., serve_weights=..., ragged_step=...,
    spec_decode_k=..., chunked_prefill=...)`` engines, the other flags
    at their defaults (keywords given to the factory override these).
    ``drafter`` (with ``spec_decode_k``) is "prompt_lookup", "draft_model"
    (`GPTConfig.draft_config` with random weights from ``SEED + 1``) or
    "self" (the model drafts for itself); each engine gets a drafter of
    its own.  One engine has already served two prompts at those shapes,
    so cuBLAS's handles and the first load of each kernel the steps
    launch stay out of any timing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024)
    model = GPT.random(cfg, seed=SEED, device=device, dtype=torch.float32)
    prompts = make_prompts(cfg.vocab_size, 16, SEED)
    if drafter not in ("prompt_lookup", "draft_model", "self"):
        raise ValueError(f"unknown drafter {drafter!r}")
    draft = None  # the draft model, if any
    if spec_decode_k and drafter == "self":
        draft = model
    elif spec_decode_k and drafter == "draft_model":
        draft = GPT.random(cfg.draft_config(), seed=SEED + 1, device=device)

    def new_engine(**kw):
        kw = dict(dict(
            max_batch_size=8, page_size=64, kv_quant=kv_quant,
            serve_weights=serve_weights, ragged_step=ragged_step,
            spec_decode_k=spec_decode_k,
            drafter=None if draft is None else DraftModelDrafter(draft),
            chunked_prefill=chunked_prefill, device=device), **kw)
        return DecodeEngine(model, **kw)

    new_engine().generate(prompts[:2], max_new_tokens=4)
    torch.cuda.synchronize()
    return model, prompts, new_engine


def _serve(new_engine, prompts):
    eng = new_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, eng.decode_stats()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv-quant", choices=("off", "int8"), default="off")
    ap.add_argument("--serve-weights", choices=("off", "int8"),
                    default="off")
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--legacy", action="store_true",
                    help="chunked_prefill=False: the one-shot prefill")
    ap.add_argument("--eager", action="store_true",
                    help="run every step eagerly (disable_capture)")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--drafter", default="prompt_lookup",
                    choices=("prompt_lookup", "draft_model", "self"))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--serve-mesh", default="",
                    help="'mp=N': serve tensor-parallel over N ranks")
    ap.add_argument("--out", default="chiprun_out/serve_profile.json")
    args = ap.parse_args(argv)

    with disable_capture() if args.eager else contextlib.nullcontext():
        _, prompts, new_engine = gpt2_small_serve(
            default_device(), args.kv_quant, args.serve_weights,
            args.ragged or bool(args.serve_mesh), args.spec_k, args.drafter,
            not args.legacy)
        if args.serve_mesh:
            unsharded = new_engine

            def new_engine(**kw):
                return unsharded(serve_mesh=args.serve_mesh, **kw)

        walls = [_serve(new_engine, prompts) for _ in range(args.runs)]
        wall_plain, st = walls[0]
        profiled = {}
        if not args.no_profile:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                wall_prof, _ = _serve(new_engine, prompts)
            profiled = dict(
                profiled_host_s_per_step=wall_prof / st["steps"],
                profiled_wall_s=wall_prof, **breakdown(prof, wall_prof))

    decode_steps = st["steps"] - st["mixed_steps"]
    result = dict(
        device=torch.cuda.get_device_name(0), card=card_line(),
        kv_quant=args.kv_quant, serve_weights=args.serve_weights,
        ragged_step=args.ragged or bool(args.serve_mesh),
        serve_mesh=args.serve_mesh, spec_decode_k=args.spec_k,
        drafter=args.drafter if args.spec_k else None,
        chunked_prefill=not args.legacy, captured=not args.eager,
        requests=len(prompts), new_tokens=st["tokens"],
        steps=st["steps"], mixed_steps=st["mixed_steps"],
        wall_s=wall_plain, tokens_per_s=st["tokens"] / wall_plain,
        host_s_per_step=wall_plain / st["steps"],
        tokens_per_s_runs=[s["tokens"] / w for w, s in walls],
        host_s_per_step_runs=[w / s["steps"] for w, s in walls],
        mean_mixed_step_ms=st["mixed_step_s"] / max(st["mixed_steps"], 1)
        * 1e3,
        mean_decode_step_ms=st["decode_step_s"] / max(decode_steps, 1) * 1e3,
        **{k: st[k] for k in ("ragged_steps", "spec_steps",
                              "acceptance_rate", "mean_accepted_per_step",
                              "draft_time_s", "verify_time_s")},
        **profiled)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
