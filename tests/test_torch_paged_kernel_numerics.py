"""CPU rehearsal of the arithmetic of kernels K1/K2
(paddle_tpu_torch/ops/csrc/paged_attention.cu).

The kernels cannot run here, so this file emulates their arithmetic with
torch ops and holds it against the plain version
(`paged_attention_reference`) within the tolerances `chip_smoke.py`
states for the kernels (f32 1e-4, bf16 2e-2):

* the split plan of the wrapper (`split_plan`): the KV range cut into
  chunks, each chunk's partial ``(m, l, acc)`` in log2 units, combined in
  split order over the chunks a row reaches;
* the tensor-core path (``q_len * group >= 16``): in f32 each operand
  (q * scale * log2 e, K, p, V) is a TF32 high part and a TF32
  remainder, rounded to nearest (ties away, as ``cvt.rna.tf32.f32``) by
  clearing the low 13 mantissa bits, and the products lo*hi + hi*lo +
  hi*hi accumulate in f32; in bf16 the product runs on the bf16 inputs in
  f32, is scaled after, and p is rounded to bf16 for p.v;
* the SIMT path (fewer rows): f32 math on q scaled in f32;
* int8 pages (K2): each element times its page's scale, rounded through
  q's dtype.

This proves the numeric design, not the kernel: the kernel itself is held
against the plain version on the card (`cuda`-marked tests,
`chip_smoke.py`).  Nothing outside the tests imports this file.

    PYTHONPATH=. python tests/test_torch_paged_kernel_numerics.py

prints the errors at `chip_smoke.py`'s shapes.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as TPA

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
SM_COUNT = 132  # an H100 SXM's SMs: the split plan the card would run


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b, split=True):
    """a @ b in f32 from TF32 parts: lo*hi + hi*lo + hi*hi (``split``),
    or hi*hi alone (TF32 without the split)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if not split:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _dense_kv(k_pages, v_pages, block_tables, dtype, k_scales, v_scales):
    """Each sequence's K and V as f32 [B, Hkv, horizon, D], dequantized as
    the kernels do."""
    bt = block_tables.long()
    k, v = k_pages[:, bt], v_pages[:, bt]  # [Hkv, B, pages_max, page, D]
    if k_scales is not None:
        k = (k.float() * k_scales[:, bt][..., None, None]).to(dtype)
        v = (v.float() * v_scales[:, bt][..., None, None]).to(dtype)
    hkv, b = k.shape[:2]
    d = k.shape[-1]
    return (k.movedim(1, 0).reshape(b, hkv, -1, d).float(),
            v.movedim(1, 0).reshape(b, hkv, -1, d).float())


def emulate(q, k_pages, v_pages, block_tables, seq_lens, q_offsets,
            k_scales=None, v_scales=None, split=True):
    """The kernels' function, arithmetic and split plan, in torch ops.
    q: [B, Q, Hq, D] f32 or bf16.  Returns q's shape and dtype."""
    b, qn, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    g = hq // hkv
    rows = qn * g
    horizon = block_tables.shape[1] * page
    splits, chunk = TPA.split_plan(b, rows, hkv, horizon, SM_COUNT)
    tc = rows >= TPA._TC_MIN_ROWS
    sl2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    k, v = _dense_kv(k_pages, v_pages, block_tables, q.dtype, k_scales,
                     v_scales)
    # rows r = (i, g) of each (b, h): [B, Hkv, rows, D]
    qr = q.float().reshape(b, qn, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d)
    i = torch.arange(rows) // g
    lim = torch.minimum(seq_lens.long()[:, None],
                        q_offsets.long()[:, None] + i[None] + 1)
    lim = lim.clamp(min=0, max=horizon)[:, None, :, None]  # [B, 1, rows, 1]
    pos = torch.arange(horizon)
    bf16 = q.dtype == torch.bfloat16
    if tc and not bf16:
        s = mm3(qr * sl2, k.transpose(-1, -2), split)
    elif tc:
        s = (qr @ k.transpose(-1, -2)) * sl2
    else:
        s = (qr * sl2) @ k.transpose(-1, -2)
    parts = []
    for c in range(splits):
        c0, c1 = c * chunk, min((c + 1) * chunk, horizon)
        sc = s[..., c0:c1]
        valid = pos[None, None, None, c0:c1] < lim
        x = torch.where(valid, sc, torch.full_like(sc, -1e30))
        m = x.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp2(x - m), torch.zeros_like(x))
        l_ = p.sum(-1, keepdim=True)
        vc = v[:, :, c0:c1]
        if tc and not bf16:
            acc = mm3(p, vc, split)
        elif tc:
            acc = p.to(torch.bfloat16).float() @ vc
        else:
            acc = p @ vc
        reach = lim > c0  # the rows whose horizon reaches this chunk
        parts.append((m, l_, acc, reach))
    mx = torch.full_like(parts[0][0], -1e30)
    for m, _, _, reach in parts:
        mx = torch.where(reach, torch.maximum(mx, m), mx)
    # each chunk's weight exp2(m - max m) / l, then the partials summed in
    # split order
    ws = [torch.where(reach, torch.exp2(m - mx), torch.zeros_like(m))
          for m, _, _, reach in parts]
    tot_l = torch.zeros_like(mx)
    for (_, l_, _, _), w in zip(parts, ws):
        tot_l = tot_l + l_ * w
    inv = 1.0 / tot_l.clamp(min=1e-30)
    out = torch.zeros_like(parts[0][2])
    for (_, _, acc, _), w in zip(parts, ws):
        out = out + acc * (w * inv)
    out = out.reshape(b, hkv, qn, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, qn, hq, d)
    return out.to(q.dtype)


def _quant_pages(rng, hkv, npages, page, d):
    """int8 pages and scales as `paged_quant_write` makes them from
    unit-normal rows, each page at its own magnitude."""
    vals = rng.randn(hkv, npages, page, d) * (
        0.25 + 0.75 * rng.rand(1, npages, 1, 1))
    scales = np.abs(vals).max(axis=(2, 3)) / 127.0
    q8 = np.clip(np.round(vals / scales[..., None, None]), -127, 127)
    return (torch.from_numpy(q8.astype(np.int8)),
            torch.from_numpy(scales.astype(np.float32)))


def make_case(seed, b, qn, hq, hkv, d, page, pages_max, seq_lens, q_offsets,
              dtype, quant=False):
    rng = np.random.RandomState(seed)
    npages = b * pages_max + 3
    sc = {}
    if quant:
        kp, ks = _quant_pages(rng, hkv, npages, page, d)
        vp, vs = _quant_pages(rng, hkv, npages, page, d)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp = torch.from_numpy(rng.randn(hkv, npages, page, d).astype(
            np.float32)).to(dtype)
        vp = torch.from_numpy(rng.randn(hkv, npages, page, d).astype(
            np.float32)).to(dtype)
    bt = torch.from_numpy(rng.permutation(npages)[:b * pages_max].reshape(
        b, pages_max).astype(np.int32))
    q = torch.from_numpy(rng.randn(b, qn, hq, d).astype(np.float32)).to(dtype)
    return (q, kp, vp, bt, torch.tensor(seq_lens, dtype=torch.int32),
            torch.tensor(q_offsets, dtype=torch.int32)), sc


# chip_smoke.py's kernel-phase shapes: the serve's decode and mixed steps
# (GPT-2-small, 8 slots, 64-token pages, 1024 horizon)
_DECODE = [0, 1, 63, 64, 65, 517, 1000, 1024]
_OFFS = [0, 37, 64, 200, 447, 0, 700, 960]
_CAPS = [64, 64, 64, 10, 64, 0, 1, 64]
# ... and its verify windows (K=4 and K=8) and ragged steady state (every
# slot one live row of 64), with K+1-row plans: 5 and 9 rows a KV head on
# the SIMT path (9: two row tiles, each with its own combine), 20 (GQA)
# on the tensor cores
_V_OFFS = [0, 63, 64, 200, 517, 1000, 1019, 1023]
_V_CAPS = {5: [5, 5, 1, 0, 5, 3, 5, 1], 9: [9, 9, 1, 0, 9, 3, 5, 1]}
_RAGGED = [1, 2, 64, 65, 66, 518, 1001, 1024]
SHAPES = {
    # tier-1 sizes: both paths, several splits, a zero-length slot, a
    # length past the block table's reach, pages of 16
    "tiny_decode": dict(b=3, qn=1, hq=4, hkv=2, d=64, page=16, pages_max=8,
                        seq_lens=[37, 0, 200], q_offsets=[36, -1, 199]),
    "tiny_mixed": dict(b=3, qn=9, hq=8, hkv=2, d=64, page=16, pages_max=8,
                       seq_lens=[45, 0, 128], q_offsets=[36, 0, 119]),
    "decode": dict(b=8, qn=1, hq=12, hkv=12, d=64, page=64, pages_max=16,
                   seq_lens=_DECODE, q_offsets=[s - 1 for s in _DECODE]),
    "mixed": dict(b=8, qn=64, hq=12, hkv=12, d=64, page=64, pages_max=16,
                  seq_lens=[o + c for o, c in zip(_OFFS, _CAPS)],
                  q_offsets=_OFFS),
    "verify": dict(b=8, qn=5, hq=12, hkv=12, d=64, page=64, pages_max=16,
                   seq_lens=[o + c for o, c in zip(_V_OFFS, _V_CAPS[5])],
                   q_offsets=_V_OFFS),
    "verify_k8": dict(b=8, qn=9, hq=12, hkv=12, d=64, page=64, pages_max=16,
                      seq_lens=[o + c for o, c in zip(_V_OFFS, _V_CAPS[9])],
                      q_offsets=_V_OFFS),
    "gqa_verify": dict(b=8, qn=5, hq=32, hkv=8, d=128, page=64,
                       pages_max=16,
                       seq_lens=[o + c for o, c in zip(_V_OFFS,
                                                       _V_CAPS[5])],
                       q_offsets=_V_OFFS),
    "ragged_decode": dict(b=8, qn=64, hq=12, hkv=12, d=64, page=64,
                          pages_max=16, seq_lens=_RAGGED,
                          q_offsets=[s - 1 for s in _RAGGED]),
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_arithmetic_holds_the_tolerance(shape, dtype, quant):
    args, sc = make_case(sorted(SHAPES).index(shape), dtype=dtype,
                         quant=quant, **SHAPES[shape])
    got = emulate(*args, **sc)
    ref = TPA.paged_attention_reference(*args[:5], q_offsets=args[5], **sc)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert float((got.float() - ref.float()).abs().max()) <= TOL[dtype]
    zero = [i for i, n in enumerate(SHAPES[shape]["seq_lens"]) if n == 0]
    if zero:
        assert float(got[zero].abs().max()) == 0.0  # exact zeros


def test_split_plan_cuts_the_horizon():
    """Every plan covers the horizon with whole 64-position units, and the
    serve's decode and mixed shapes do split."""
    for b, rows, hkv, horizon in [(8, 1, 12, 1024), (8, 64, 12, 1024),
                                  (8, 256, 8, 1024), (1, 1, 1, 16),
                                  (64, 1, 32, 4096), (3, 9, 2, 128),
                                  (8, 5, 12, 1024), (8, 9, 12, 1024),
                                  (8, 20, 8, 1024)]:
        splits, chunk = TPA.split_plan(b, rows, hkv, horizon, SM_COUNT)
        assert chunk % 64 == 0 and splits >= 1
        assert (splits - 1) * chunk < horizon <= splits * chunk
    assert TPA.split_plan(8, 1, 12, 1024, SM_COUNT)[0] > 1
    assert TPA.split_plan(8, 64, 12, 1024, SM_COUNT)[0] > 1
    # the verify plans split too: 5 and 9 rows (one and two SIMT row
    # tiles) and GQA's 20 (one tensor-core tile)
    for rows, hkv in ((5, 12), (9, 12), (20, 8)):
        assert TPA.split_plan(8, rows, hkv, 1024, SM_COUNT)[0] > 1


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12 - 2 ** -23], dtype=torch.float32)
    np.testing.assert_array_equal(
        tf32(x).numpy(), np.array([1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                   -(1.0 + 2 ** -10), 1.0], np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x)  # the remainder is exact here


def test_tf32_alone_misses_the_f32_tolerance():
    """Why f32 runs three products: TF32 without the split misses 1e-4 at
    the mixed step's shape, the split holds it."""
    args, _ = make_case(3, dtype=torch.float32, **SHAPES["mixed"])
    ref = TPA.paged_attention_reference(*args[:5], q_offsets=args[5])
    one = float((emulate(*args, split=False) - ref).abs().max())
    three = float((emulate(*args) - ref).abs().max())
    assert three <= TOL[torch.float32] < one


if __name__ == "__main__":
    for name in ("decode", "mixed", "verify", "verify_k8", "gqa_verify",
                 "ragged_decode"):
        for dtype in (torch.float32, torch.bfloat16):
            for quant in (False, True):
                args, sc = make_case(0, dtype=dtype, quant=quant,
                                     **SHAPES[name])
                ref = TPA.paged_attention_reference(*args[:5],
                                                    q_offsets=args[5], **sc)
                err = float((emulate(*args, **sc).float()
                             - ref.float()).abs().max())
                print(f"{name:>13} {str(dtype)[6:]:>8} "
                      f"{'int8' if quant else 'dense'}: max_abs_err "
                      f"{err:.3g} (tol {TOL[dtype]})")
    args, _ = make_case(3, dtype=torch.float32, **SHAPES["mixed"])
    ref = TPA.paged_attention_reference(*args[:5], q_offsets=args[5])
    err = float((emulate(*args, split=False) - ref).abs().max())
    print(f" mixed  float32 dense, TF32 without the split: max_abs_err "
          f"{err:.3g}")
