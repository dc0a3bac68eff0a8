#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero:

1. card   — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build  — compile every kernel under paddle_tpu_torch/ops/csrc with
   nvcc for sm_90a;
3. kernel — hold kernel K1 (ragged paged attention) against its plain
   PyTorch version on the card, f32 and bf16, at the serving path's
   decode and mixed-step shapes and at a GQA shape, and time the
   kernel, the plain version and one PyTorch library call;
4. serve  — serve GPT-2-small at full width (random weights from a
   seed) through `DecodeEngine` at default flags: 16 requests, prompts
   of 64-512 tokens, half sharing a 128-token prefix, 64 new tokens
   each; check the drain, the prefix cache and that every step's
   attention went through K1; then hold a recorded mixed step's and
   decode step's attention outputs against the plain version, and one
   short request's greedy tokens against the CPU engine;
5. flash  — hold kernels K3 (flash-attention forward) and K4 (its
   backward: dkv and dq) against their plain versions on the card at
   the train path's shape (B=16, H=12, S=1024, D=64, causal; f32 and
   bf16), non-causal, at a ragged S=1000, and at B=2, H=16, S=2048,
   D=128 (bf16), and time each kernel, the plain versions and
   PyTorch's ``scaled_dot_product_attention`` forward and backward;
6. train  — train GPT-2-small at full width with ``bench.py``'s bf16
   AdamW `jit.TrainStep` (batch 16 x 1024): 2 warm-up and 10 timed
   steps; check finite, falling losses that start near ln(vocab) and
   that every step's attention went through K3 and K4; hold one layer's
   recorded attention inputs and output gradient against the plain
   versions; then train a small GPT (D=64) 3 steps on the card and on
   the CPU from the same weights, in f32 and under bf16 AMP, and hold
   losses and parameters against each other;
7. report — one JSON line of kernels, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The whole result also goes to chiprun_out/chip_smoke.json.  The script
imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,    # H100 SXM, f32 outside the tensor cores
              "bfloat16": 989e12}  # H100 SXM, dense bf16 tensor cores
# stated tolerances of K1 against the plain version, by dtype:
# f32 — the kernel scales q before the dot (the Pallas form) where the
#   plain version scales the product (the XLA form), and sums in another
#   order: a few f32 ulps of logits, far under 1e-4 on outputs of O(1);
# bf16 — the plain version rounds logits and probabilities to bf16
#   (the XLA cast discipline) while the kernel keeps them in f32; both
#   round the output to bf16, whose ulp is 2**-7 near 1: 2e-2 holds two
#   output ulps for values below 2 plus the rounding of the logits.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K1_SOURCE = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
K1_REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:339"
# stated tolerances of K3/K4 against the plain versions, by dtype and
# output: f32 as K1's (q scaled before the product against the product
# scaled, sums in another order); bf16 outputs and gradients 2e-2 as K1's
# (both sides work in f32 on the same bf16 inputs and round the result to
# bf16: two ulps below 2), bf16 lse 5e-2 (the plain forward rounds the
# logits to bf16, |logit| up to ~8 at these inputs: 2**-8 * 8 = 3e-2)
FLASH_TOL = {"float32": dict(out=1e-4, lse=1e-4, dq=1e-4, dk=1e-4, dv=1e-4),
             "bfloat16": dict(out=2e-2, lse=5e-2, dq=2e-2, dk=2e-2,
                              dv=2e-2)}
FLASH_SOURCE = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_KERNELS = {  # wrapper name -> (TPU kernel replaced, products, outputs)
    "fwd": ("paddle_tpu/ops/pallas/flash_attention.py:69", 2,
            ("out", "lse")),
    "dkv": ("paddle_tpu/ops/pallas/flash_attention.py:298", 4, ("dk", "dv")),
    "dq": ("paddle_tpu/ops/pallas/flash_attention.py:359", 3, ("dq",)),
}
TRAIN_STEPS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------
def kernel_inputs(torch, case, dtype, gen):
    b, qn, hq, d = case["B"], case["Q"], case["Hq"], case["D"]
    hkv, page, pages_max = case["Hkv"], case["page"], case["pages_max"]
    npages = b * pages_max + 3
    dev = "cuda"
    k_pages = torch.randn(hkv, npages, page, d, generator=gen,
                          device=dev).to(dtype)
    v_pages = torch.randn(hkv, npages, page, d, generator=gen,
                          device=dev).to(dtype)
    # a shuffled block table: the indirection must really be exercised
    bt = torch.randperm(npages, generator=gen, device=dev)[:b * pages_max]
    bt = bt.reshape(b, pages_max).to(torch.int32).contiguous()
    q = torch.randn(b, qn, hq, d, generator=gen, device=dev).to(dtype)
    seq_lens = torch.tensor(case["seq_lens"], dtype=torch.int32, device=dev)
    q_offsets = torch.tensor(case["q_offsets"], dtype=torch.int32,
                             device=dev)
    return q, k_pages, v_pages, bt, seq_lens, q_offsets


def work_of(torch, case, dtype):
    """Bytes the function must move (live K/V, q, out, indices once) and
    the flops these inputs need (4 * D per visible (row, kv) pair)."""
    item = torch.empty((), dtype=dtype).element_size()
    b, qn, hq, d = case["B"], case["Q"], case["Hq"], case["D"]
    hkv = case["Hkv"]
    horizon = case["page"] * case["pages_max"]
    live = sum(min(s, horizon) for s in case["seq_lens"])
    nbytes = (2 * live * hkv * d * item + 2 * b * qn * hq * d * item
              + 4 * (b * case["pages_max"] + 2 * b))
    pairs = sum(max(min(s, o + i + 1, horizon), 0)
                for s, o in zip(case["seq_lens"], case["q_offsets"])
                for i in range(qn))
    flops = 4 * d * hq * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps=30, warm=3):
    """Median CUDA-event time of ``fn``; a 128 MB write before every
    timed launch evicts the 50 MB L2, as the serving path (which walks
    every layer's pages in turn) finds it cold."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def reset_counts():
    """Set every kernel's launch count to 0."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    for w in (pa.paged_attention_cuda, fa.flash_attention_cuda_fwd,
              fa.flash_attention_cuda_dkv, fa.flash_attention_cuda_dq):
        w.launches = 0


def read_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    return dict(paged_attention=pa.paged_attention_cuda.launches,
                fwd=fa.flash_attention_cuda_fwd.launches,
                dkv=fa.flash_attention_cuda_dkv.launches,
                dq=fa.flash_attention_cuda_dq.launches)


def kernel_phase(torch):
    from paddle_tpu_torch.nn.functional.attention import \
        multi_query_causal_mask
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    decode_lens = [0, 1, 63, 64, 65, 517, 1000, 1024]
    mixed_offs = [0, 37, 64, 200, 447, 0, 700, 960]
    mixed_caps = [64, 64, 64, 10, 64, 0, 1, 64]
    mixed_lens = [o + c for o, c in zip(mixed_offs, mixed_caps)]
    base = dict(B=8, page=64, pages_max=16)
    cases = [
        # the serving path's two shapes (GPT-2-small, 8 slots, 64-token
        # pages, 1024 horizon) and a GQA shape
        dict(base, name="decode", Q=1, Hq=12, Hkv=12, D=64,
             seq_lens=decode_lens, q_offsets=[s - 1 for s in decode_lens]),
        dict(base, name="mixed", Q=64, Hq=12, Hkv=12, D=64,
             seq_lens=mixed_lens, q_offsets=mixed_offs),
        dict(base, name="gqa_decode", Q=1, Hq=32, Hkv=8, D=128,
             seq_lens=decode_lens, q_offsets=[s - 1 for s in decode_lens]),
        dict(base, name="gqa_mixed", Q=64, Hq=32, Hkv=8, D=128,
             seq_lens=mixed_lens, q_offsets=mixed_offs),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, kp, vp, bt, sl, qo = kernel_inputs(torch, case, dtype, gen)
            out = paged_attention_cuda(q, kp, vp, bt, sl, qo)
            ref = paged_attention_reference(q, kp, vp, bt, sl, q_offsets=qo)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K1 {case['name']} {dname}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            zero_rows = [i for i, s in enumerate(case["seq_lens"]) if s == 0]
            if zero_rows and out[zero_rows].abs().max().item() != 0.0:
                fail(f"K1 {case['name']} {dname}: seq_len 0 not exact zeros")
            ms = time_ms(torch, lambda: paged_attention_cuda(
                q, kp, vp, bt, sl, qo))
            plain_ms = time_ms(torch, lambda: paged_attention_reference(
                q, kp, vp, bt, sl, q_offsets=qo))
            # library yardstick: SDPA over K/V gathered to dense
            # [B, Hq, S, D] AHEAD of the timing (gather excluded)
            g = case["Hq"] // case["Hkv"]
            kd = kp[:, bt.long()].movedim(1, 0).flatten(2, 3)
            vd = vp[:, bt.long()].movedim(1, 0).flatten(2, 3)
            kd = kd.repeat_interleave(g, dim=1).contiguous()
            vd = vd.repeat_interleave(g, dim=1).contiguous()
            qd = q.transpose(1, 2).contiguous()
            mask = multi_query_causal_mask(qo, case["Q"], sl,
                                           kd.shape[2])[:, None]
            library_ms = time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                     attn_mask=mask))
            bound_ms, bound_by = work_of(torch, case, dtype)
            ok = err <= TOL[dname]
            results.append(dict(case=case["name"], dtype=dname,
                                shape=dict(B=case["B"], Q=case["Q"],
                                           Hq=case["Hq"], Hkv=case["Hkv"],
                                           D=case["D"], page=case["page"],
                                           pages_max=case["pages_max"]),
                                max_abs_err=err, tol=TOL[dname], ok=ok,
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=library_ms))
            print(f"kernel K1 {case['name']:>10} {dname:>8}: max_abs_err "
                  f"{err:.3g} (tol {TOL[dname]}) ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                  f"{bound_ms:.4f} ({bound_by})", flush=True)
            if not ok:
                fail(f"K1 {case['name']} {dname}: max_abs_err {err} > "
                     f"{TOL[dname]}")
    return results


# ---------------------------------------------------------------------------
# phase 4: serve GPT-2-small
# ---------------------------------------------------------------------------
class AttentionRecorder:
    """Records the inputs and output of the first mixed-step call (q of
    rank 4) and the first decode-step call (rank 3) of the serving
    path's attention, passing every call through unchanged."""

    def __init__(self, module):
        self.module = module
        self.inner = module.paged_attention
        self.calls = {}

    def __call__(self, q, k_pages, v_pages, block_tables, seq_lens,
                 scale=None, q_offsets=None):
        out = self.inner(q, k_pages, v_pages, block_tables, seq_lens,
                         scale=scale, q_offsets=q_offsets)
        kind = "mixed" if q.dim() == 4 else "decode"
        if kind not in self.calls:
            self.calls[kind] = dict(
                args=[t.clone() for t in (q, k_pages, v_pages,
                                          block_tables, seq_lens)],
                q_offsets=None if q_offsets is None else q_offsets.clone(),
                out=out.clone())
        return out

    def __enter__(self):
        self.module.paged_attention = self
        return self

    def __exit__(self, *exc):
        self.module.paged_attention = self.inner


def serve_phase(torch):
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # GPT-2-small at full width, its prompts and its engine, warmed up
    model, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")
    cfg = model.cfg

    eng = new_engine()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=serve_profile.NEW_TOKENS)
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["paged_attention"]
    peak = torch.cuda.max_memory_allocated()
    st = eng.decode_stats()

    for r in reqs:
        toks = r.generated_ids
        if (r.finish_reason != "length"
                or len(toks) != serve_profile.NEW_TOKENS):
            fail(f"request {r.request_id}: {r.finish_reason} after "
                 f"{len(toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {r.request_id}: token outside the vocab")
    if eng.pool.available_count != eng.pool.num_pages:
        fail(f"pool did not drain: {eng.pool.available_count} of "
             f"{eng.pool.num_pages} pages available")
    if st["prefix_hits"] <= 0:
        fail("no prefix-cache hit")
    if launches <= 0 or launches != cfg.num_layers * st["steps"]:
        fail(f"K1 launches {launches} != num_layers x steps "
             f"({cfg.num_layers} x {st['steps']})")
    decode_steps = st["steps"] - st["mixed_steps"]
    serve = dict(
        requests=len(reqs), prompt_tokens=sum(len(p) for p in prompts),
        new_tokens=st["tokens"], wall_s=wall,
        tokens_per_s=st["tokens"] / wall, steps=st["steps"],
        mixed_steps=st["mixed_steps"], decode_steps=decode_steps,
        mean_mixed_step_ms=st["mixed_step_s"] / st["mixed_steps"] * 1e3,
        mean_decode_step_ms=(st["decode_step_s"] / decode_steps * 1e3
                             if decode_steps else None),
        prefix_hits=st["prefix_hits"], launches=counts,
        peak_memory_bytes=peak)
    print("serve: " + json.dumps(serve), flush=True)

    # the attention outputs of one real mixed step and one real decode
    # step, recorded on the path, against the plain version on the
    # same inputs (a check, not a route the engine can take)
    with AttentionRecorder(pa) as rec:
        DecodeEngine(model, max_batch_size=2, page_size=64).generate(
            [prompts[0][:100], prompts[2][:150]], max_new_tokens=3)
    checks = {}
    for kind in ("mixed", "decode"):
        if kind not in rec.calls:
            fail(f"no {kind} step recorded")
        call = rec.calls[kind]
        ref = pa.paged_attention_reference(*call["args"],
                                           q_offsets=call["q_offsets"])
        err = (call["out"] - ref).abs().max().item()
        checks[kind] = err
        print(f"serve {kind} step attention vs plain: max_abs_err "
              f"{err:.3g} (tol {TOL['float32']})", flush=True)
        if not err <= TOL["float32"]:
            fail(f"{kind} step attention disagrees with the plain version")

    # end to end on a small input: greedy tokens of the card's engine
    # (K1) against the CPU engine (the plain version) on the same weights
    cpu_model = GPT.random(cfg, seed=serve_profile.SEED,
                           device="cpu")  # the same weights
    prompt = prompts[1][:64]
    gpu_toks = DecodeEngine(model, max_batch_size=1, max_seq_len=128,
                            page_size=64).generate([prompt], 8)[0]
    cpu_toks = DecodeEngine(cpu_model, max_batch_size=1, max_seq_len=128,
                            page_size=64, device="cpu").generate([prompt],
                                                                 8)[0]
    print(f"greedy tokens, card vs CPU engine: {gpu_toks} / {cpu_toks}",
          flush=True)
    if gpu_toks != cpu_toks:
        fail("greedy tokens of the card's engine differ from the CPU's")
    serve["step_attention_max_abs_err"] = checks
    serve["greedy_tokens_match_cpu"] = True
    return serve, launches


# ---------------------------------------------------------------------------
# phase 5: K3/K4 against their plain versions
# ---------------------------------------------------------------------------
def flash_work(torch, case, dtype, kernel):
    """Bound of one K3/K4 kernel: bytes = its inputs read once and its
    outputs written once; flops = 2 * D per visible (query, key) pair for
    each of its products (forward 2, dkv 4, dq 3)."""
    item = torch.empty((), dtype=dtype).element_size()
    bh, s, d = case["B"] * case["H"], case["S"], case["D"]
    rows = bh * s * d * item  # one [B, H, S, D] tensor
    nbytes = {"fwd": 4 * rows + 4 * bh * s,              # q k v -> out lse
              "dkv": 7 * rows + 4 * bh * s,              # q k v o do lse -> dk dv
              "dq": 6 * rows + 4 * bh * s}[kernel]       # ... -> dq
    pairs = bh * (s * (s + 1) // 2 if case["causal"] else s * s)
    flops = FLASH_KERNELS[kernel][1] * 2 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_errors(torch, fa, q, k, v, do, causal):
    """Max abs errors of K3 (out, lse) and K4 (dq, dk, dv) against the
    plain versions; both backwards take the plain forward's out and lse,
    so every kernel sees the same inputs as its plain version.  Returns
    ``(errors, plain out, plain lse)``."""
    b, h, s, _ = q.shape
    out, lse = fa.flash_attention_cuda_fwd(q, k, v, causal)
    ref, ref_lse = fa._composed_attention(q, k, v, None, causal, None,
                                          want_lse=True)
    ref_lse = ref_lse.reshape(b * h, s)
    dk, dv = fa.flash_attention_cuda_dkv(q, k, v, ref, ref_lse, do, causal)
    dq = fa.flash_attention_cuda_dq(q, k, v, ref, ref_lse, do, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                            causal, None)
    torch.cuda.synchronize()
    got = dict(out=(out, ref), lse=(lse, ref_lse), dq=(dq, want[0]),
               dk=(dk, want[1]), dv=(dv, want[2]))
    errs = {}
    for name, (a, r) in got.items():
        if not torch.isfinite(a.float()).all():
            fail(f"K3/K4: non-finite {name}")
        errs[name] = (a.float() - r.float()).abs().max().item()
    return errs, ref, ref_lse


def flash_phase(torch):
    from paddle_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [
        dict(name="train", B=16, H=12, S=1024, D=64, causal=True,
             dtypes=("float32", "bfloat16")),
        dict(name="full", B=16, H=12, S=1024, D=64, causal=False,
             dtypes=("float32", "bfloat16")),
        dict(name="ragged", B=16, H=12, S=1000, D=64, causal=True,
             dtypes=("float32", "bfloat16")),
        dict(name="d128", B=2, H=16, S=2048, D=128, causal=True,
             dtypes=("bfloat16",)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for case in cases:
        shape = (case["B"], case["H"], case["S"], case["D"])
        c = case["causal"]
        for dname in case["dtypes"]:
            dtype = getattr(torch, dname)
            q, k, v, do = (torch.randn(*shape, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            errs, o, lse = flash_errors(torch, fa, q, k, v, do, c)
            tol = FLASH_TOL[dname]
            ms = dict(
                fwd=time_ms(torch, lambda: fa.flash_attention_cuda_fwd(
                    q, k, v, c)),
                dkv=time_ms(torch, lambda: fa.flash_attention_cuda_dkv(
                    q, k, v, o, lse, do, c)),
                dq=time_ms(torch, lambda: fa.flash_attention_cuda_dq(
                    q, k, v, o, lse, do, c)))
            plain_fwd = time_ms(torch, lambda: fa._composed_attention(
                q, k, v, None, c, None, want_lse=True), reps=10)
            plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, c, None), reps=10)
            # library yardstick: SDPA forward, and its autograd backward
            # as (forward + backward) - forward; the port never calls it
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=c))
            lib_both = time_ms(torch, lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, is_causal=c), (qg, kg, vg), do))
            row = dict(case=case["name"], dtype=dname, causal=c,
                       shape=dict(zip("BHSD", shape)), max_abs_err=errs,
                       tol=tol, kernels={})
            for kern, (_, _, outs) in FLASH_KERNELS.items():
                bound_ms, bound_by = flash_work(torch, case, dtype, kern)
                row["kernels"][kern] = dict(
                    ms=ms[kern], max_abs_err=max(errs[n] for n in outs),
                    plain_ms=plain_fwd if kern == "fwd" else plain_bwd,
                    library_ms=(lib_fwd if kern == "fwd"
                                else lib_both - lib_fwd),
                    bound_ms=bound_ms, bound_by=bound_by)
            results.append(row)
            print(f"kernel K3/K4 {case['name']:>6} {dname:>8}: max_abs_err "
                  + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
                  + " | ms " + " ".join(
                      f"{n} {r['ms']:.4f} (bound {r['bound_ms']:.4f})"
                      for n, r in row["kernels"].items())
                  + f" | plain fwd {plain_fwd:.4f} bwd {plain_bwd:.4f}"
                  f" | library fwd {lib_fwd:.4f} bwd "
                  f"{lib_both - lib_fwd:.4f}", flush=True)
            bad = [n for n, e in errs.items() if not e <= tol[n]]
            if bad:
                fail(f"K3/K4 {case['name']} {dname}: {bad} beyond {tol}")
    return results


# ---------------------------------------------------------------------------
# phase 6: train GPT-2-small
# ---------------------------------------------------------------------------
class FlashRecorder:
    """Records q, k, v, the output and (through a hook on the output)
    the output's gradient of the first call of the train path's
    attention, passing every call through unchanged."""

    def __init__(self, module):
        self.module = module
        self.inner = module.flash_attention_fwd
        self.call = None

    def __call__(self, q, k, v, mask=None, is_causal=False, scale=None):
        out = self.inner(q, k, v, mask, is_causal, scale)
        if self.call is None:
            self.call = dict(args=[t.detach().contiguous().clone()
                                   for t in (q, k, v)],
                             causal=is_causal, out=out.detach().clone())
            out.register_hook(lambda g: self.call.__setitem__(
                "dout", g.detach().contiguous().clone()))
        return out

    def __enter__(self):
        self.module.flash_attention_fwd = self
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_fwd = self.inner


def train_phase(torch):
    import math

    from paddle_tpu_torch.nn.functional import attention as attn_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import train_profile as tp

    torch.cuda.reset_peak_memory_stats()
    model, step, tokens, labels, warm = tp.gpt2_small_train("cuda")
    cfg = model.cfg
    reset_counts()
    t0 = time.perf_counter()
    losses = [step(tokens, labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [float(x) for x in losses]
    ntok = tokens.numel() * TRAIN_STEPS
    train = dict(batch=list(tokens.shape), warmup_steps=len(warm),
                 steps=TRAIN_STEPS, wall_s=wall, tokens_per_s=ntok / wall,
                 mean_step_ms=wall / TRAIN_STEPS * 1e3, losses=losses,
                 launches=counts, peak_memory_bytes=peak)
    print("train: " + json.dumps(train), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite train loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"first loss {losses[0]} not within 0.5 of "
             f"ln({cfg.vocab_size})")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on a fixed batch: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    if any(counts[k] != want for k in FLASH_KERNELS):
        fail(f"K3/K4 launches {counts} != num_layers x steps = {want}")

    # one layer's attention on the path, recorded during a real step,
    # against the plain versions on the same inputs
    with FlashRecorder(attn_mod) as rec:
        step(tokens, labels)
    torch.cuda.synchronize()
    if rec.call is None or "dout" not in rec.call:
        fail("no train-path attention recorded")
    q, k, v = rec.call["args"]
    if q.dtype != torch.bfloat16:
        fail(f"train-path attention ran in {q.dtype}, not bfloat16 under AMP")
    errs, ref, _ = flash_errors(torch, fa, q, k, v, rec.call["dout"],
                                rec.call["causal"])
    errs["path_out"] = (rec.call["out"].float() - ref.float()).abs().max(
        ).item()
    tol = dict(FLASH_TOL["bfloat16"], path_out=FLASH_TOL["bfloat16"]["out"])
    print(f"train-path attention vs plain: {errs} (tol {tol})", flush=True)
    bad = [n for n, e in errs.items() if not e <= tol[n]]
    if bad:
        fail(f"train-path attention disagrees with the plain version: {bad}")
    train["step_attention_max_abs_err"] = errs
    train["card_vs_cpu"] = card_vs_cpu(torch, fa)
    return train


# card against CPU: losses within f32 1e-4 / bf16 2e-2 (bf16 rounds the
# activations at ~2**-8); parameters within 10 * lr at most (Adam moves
# each parameter about lr a step, so a near-zero gradient whose sign the
# two devices round apart moves it up to 2 * lr apart a step) and within
# f32 1e-6 / bf16 1e-5 on average over every parameter
CARD_CPU_TOL = {"float32": dict(loss=1e-4, param_mean=1e-6),
                "bf16_amp": dict(loss=2e-2, param_mean=1e-5)}


def card_vs_cpu(torch, fa):
    import numpy as np

    from paddle_tpu_torch.inference.weights import params_to_numpy
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.train_profile import amp_loss_fn

    lr = 1e-4
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, use_parallel_layers=False)
    rng = np.random.default_rng(SEED)
    batch = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))
                              .astype(np.int32)) for _ in range(2)]
    out = {}
    for mode, loss_fn in (("float32", gpt_loss_fn),
                          ("bf16_amp", amp_loss_fn)):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = GPT.random(cfg, seed=SEED, device=dev)
            step = train_step(model, loss_fn, AdamW(
                learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01))
            n0 = fa.flash_attention_cuda_fwd.launches
            losses = [float(step(*(t.to(dev) for t in batch)))
                      for _ in range(3)]
            runs[dev] = (losses, params_to_numpy(model.params()),
                         fa.flash_attention_cuda_fwd.launches - n0)
        (gl, gp, gn), (cl, cp, cn) = runs["cuda"], runs["cpu"]
        if gn != 3 * cfg.num_layers or cn != 0:
            fail(f"card vs CPU {mode}: K3 launched {gn} times on the card "
                 f"and {cn} on the CPU")
        diffs = [np.abs(a - b) for a, b in zip(_leaves(gp), _leaves(cp))]
        res = dict(losses_card=gl, losses_cpu=cl,
                   loss_max_abs_err=max(abs(a - b) for a, b in zip(gl, cl)),
                   param_max_abs_err=max(float(d.max()) for d in diffs),
                   param_mean_abs_err=float(np.concatenate(
                       [d.ravel() for d in diffs]).mean()),
                   tol=dict(CARD_CPU_TOL[mode], param_max=10 * lr))
        print(f"card vs CPU {mode}: {json.dumps(res)}", flush=True)
        tol = res["tol"]
        if not (res["loss_max_abs_err"] <= tol["loss"]
                and res["param_max_abs_err"] <= tol["param_max"]
                and res["param_mean_abs_err"] <= tol["param_mean"]):
            fail(f"card vs CPU {mode}: beyond tolerance")
        out[mode] = res
    return out


def _leaves(tree):
    flat = [tree[k] for k in sorted(tree) if k != "blocks"]
    for blk in tree["blocks"]:
        flat += [blk[k] for k in sorted(blk)]
    return flat


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside this script "
              f"({e})", file=sys.stderr)
        return 1

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {build_s:.1f} s", flush=True)

    # 3. K1 against its plain version
    cases = kernel_phase(torch)

    # 4. serve
    serve, launches = serve_phase(torch)

    # 5. K3/K4 against their plain versions
    flash_cases = flash_phase(torch)

    # 6. train
    train = train_phase(torch)

    # 7. report
    main_cases = [c for c in cases if c["dtype"] == "float32"
                  and c["case"] in ("decode", "mixed")]
    head = next(c for c in main_cases if c["case"] == "decode")
    kernels = [dict(
        name="paged_attention", route="cuda", source=K1_SOURCE,
        replaces=K1_REPLACES, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in main_cases),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        timed_case="decode float32 B=8 Q=1 Hq=Hkv=12 D=64 page=64",
        library_call="scaled_dot_product_attention on K/V gathered ahead "
                     "of time (gather excluded)",
        cases=cases)]
    # K3/K4 at the train path's own shape and dtype (bf16 under AMP)
    train_case = next(c for c in flash_cases if c["case"] == "train"
                      and c["dtype"] == "bfloat16")
    for kern, (replaces, _, _) in FLASH_KERNELS.items():
        k = train_case["kernels"][kern]
        if kern == "fwd":  # every case of K3/K4, once
            k = dict(k, cases=flash_cases)
        kernels.append(dict(
            name=f"flash_attention_{'bwd_' if kern != 'fwd' else ''}{kern}",
            route="cuda", source=FLASH_SOURCE, replaces=replaces,
            launches=train["launches"][kern], **k,
            timed_case="train bfloat16 B=16 H=12 S=1024 D=64 causal",
            plain_call=("_composed_attention" if kern == "fwd" else
                        "flash_attention_bwd_reference (dq, dk and dv "
                        "together)"),
            library_call=("scaled_dot_product_attention forward"
                          if kern == "fwd" else
                          "scaled_dot_product_attention backward (dq, dk "
                          "and dv together): forward+backward - forward")))
    result = dict(card=card, build_s=build_s, kernels=kernels, serve=serve,
                  train=train)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
