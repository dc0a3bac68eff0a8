"""Where a GPT-2-small serve spends its time on the card.

    python -m paddle_tpu_torch.tools.serve_profile
        [--kv-quant int8] [--serve-weights int8]
        [--out chiprun_out/serve_profile.json]

Serves the workload of ``chip_smoke.py``'s serve phase (`gpt2_small_serve`:
GPT-2-small at full width, random weights from seed 0, 8 slots, 64-token
pages, 16 prompts of 64-512 tokens, half sharing a 128-token prefix, 64
new tokens each; int8 KV pages and int8 weights with the switches, default
off) twice: once plain, for the wall time, and once under
``torch.profiler`` for the breakdown.  Prints, and writes to ``--out``:
the wall time of each run; the device's busy time (the sum of every
kernel's and copy's time, one stream so nothing overlaps) and idle share
over the profiled run; the kernels and the PyTorch operators that took
the most device time; and the host time per step.  Needs a CUDA card;
raises without one.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..inference.serving import DecodeEngine
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


def gpt2_small_serve(device, kv_quant="off", serve_weights="off"):
    """The GPT-2-small serve of ``chip_smoke.py`` and of this profile.

    Returns ``(model, prompts, new_engine)``: GPT-2-small at full width
    (the ``bench.py`` config) with random f32 weights from `SEED`, its 16
    prompts, and a factory of fresh ``DecodeEngine(max_batch_size=8,
    page_size=64, kv_quant=..., serve_weights=...)`` engines, the other
    flags at their defaults.  One engine has already served two prompts
    at those shapes, so cuBLAS's handles and the first load of each
    kernel the steps launch stay out of any timing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024)
    model = GPT.random(cfg, seed=SEED, device=device, dtype=torch.float32)
    prompts = make_prompts(cfg.vocab_size, 16, SEED)

    def new_engine():
        return DecodeEngine(model, max_batch_size=8, page_size=64,
                            kv_quant=kv_quant, serve_weights=serve_weights,
                            device=device)

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
    ap.add_argument("--out", default="chiprun_out/serve_profile.json")
    args = ap.parse_args(argv)

    _, prompts, new_engine = gpt2_small_serve(
        default_device(), args.kv_quant, args.serve_weights)
    wall_plain, st = _serve(new_engine, prompts)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, _ = _serve(new_engine, prompts)

    decode_steps = st["steps"] - st["mixed_steps"]
    result = dict(
        device=torch.cuda.get_device_name(0), card=card_line(),
        kv_quant=args.kv_quant, serve_weights=args.serve_weights,
        requests=len(prompts), new_tokens=st["tokens"],
        steps=st["steps"], mixed_steps=st["mixed_steps"],
        wall_s=wall_plain, tokens_per_s=st["tokens"] / wall_plain,
        mean_mixed_step_ms=st["mixed_step_s"] / max(st["mixed_steps"], 1)
        * 1e3,
        mean_decode_step_ms=st["decode_step_s"] / max(decode_steps, 1) * 1e3,
        profiled_wall_s=wall_prof, **breakdown(prof, wall_prof))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
