"""paddle_tpu_torch flash attention against the JAX package.

The port's plain versions (the route every CPU tensor takes) are held
against the JAX package on the same inputs made with numpy:
`_composed_attention` (out and lse) against JAX `_composed_attention` and
the Pallas forward in interpret mode; `flash_attention_bwd_reference`
against the Pallas backward in interpret mode and against ``jax.vjp`` of
`_xla_reference`.  Tolerances, with their reasons:

* f32 forward 2e-5 (two frameworks sum in different orders); f32 forward
  against the Pallas kernel and every f32 gradient 2e-4 (the kernels and
  the port's backward scale q in f32 before the product, the composed
  form scales the product, and gradients sum S terms);
* bf16 2e-2 on outputs of O(1) (bf16 rounds logits, probabilities and
  results at ~2**-8 relative, at different points in each form), and
  5e-2 on the gradients, whose JAX reference runs autograd through bf16
  products while the port's backward works in f32.

The CUDA kernels K3/K4 are checked against the plain versions on the
card only (`cuda` marker).  Their bf16 kernels run on the tensor cores,
which round the probabilities and ds to bf16 where they meet a product;
`_tensor_core_emulation` rehearses that rounding on the CPU against the
plain versions under the card's tolerance (``PYTHONPATH=. python
tests/test_torch_flash_attention.py`` prints it at the card's shapes).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu import amp as JA
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as TFA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3/K4 have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _inputs(seed, b=1, h=2, sq=256, sk=None, d=64):
    """q, k, v, dout as numpy f32 [B, H, S, D]."""
    rng = np.random.RandomState(seed)
    sk = sk or sq
    return [rng.randn(b, h, s, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ---------------------------------------------------------------------------
# the plain forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (100, 100), (48, 80)])
def test_composed_forward_matches_jax(sq, sk, causal, dtype):
    arrays = _inputs(sq + sk, sq=sq, sk=sk, d=32)
    jdt, tdt = _DT[dtype]
    q, k, v, _ = _jax(arrays, jdt)
    want, want_lse = FA._composed_attention(q, k, v, None, causal, None,
                                            want_lse=True)
    tq, tk, tv, _ = _torch(arrays, tdt)
    got, lse = TFA._composed_attention(tq, tk, tv, None, causal, None,
                                       want_lse=True)
    assert got.dtype == tdt and lse.dtype == torch.float32
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), atol=atol)


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_composed_forward_matches_pallas(interpret_pallas, causal, block_q,
                                         block_k):
    """Against the Pallas forward run in interpret mode (S=256, so the
    kernel takes two or four K blocks): out and its f32 lse ([B*H, S])."""
    arrays = _inputs(3)
    q, k, v, _ = _jax(arrays, jnp.float32)
    want, want_lse = FA._pallas_forward(q, k, v, causal, None, block_q,
                                        block_k)
    tq, tk, tv, _ = _torch(arrays, torch.float32)
    got, lse = TFA._composed_attention(tq, tk, tv, None, causal, None,
                                       want_lse=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4)
    np.testing.assert_allclose(lse.reshape(-1, 256).numpy(), _np(want_lse),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# the plain backward
# ---------------------------------------------------------------------------
def _port_backward(arrays, causal, tdt):
    """The port's plain backward on the port's plain forward's out/lse."""
    tq, tk, tv, tdo = _torch(arrays, tdt)
    out, lse = TFA._composed_attention(tq, tk, tv, None, causal, None,
                                       want_lse=True)
    return TFA.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                             causal, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_matches_pallas(interpret_pallas, causal,
                                           block_q, block_k, dtype):
    """The Pallas backward on its own forward's out and lse, the port's on
    its plain forward's: the kernels' formulas on both sides, in f32 on
    bf16 inputs too, so bf16 differs by the forward's bf16 output and the
    final rounding: 2e-2."""
    arrays = _inputs(5)
    jdt, tdt = _DT[dtype]
    q, k, v, do = _jax(arrays, jdt)
    out, lse = FA._pallas_forward(q, k, v, causal, None, block_q, block_k)
    want = FA._pallas_backward(q, k, v, out, lse, do, causal, None, block_q,
                               block_k)
    got = _port_backward(arrays, causal, tdt)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(w),
                                   atol=2e-2 if dtype == "bfloat16" else 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 100])
def test_backward_reference_matches_jax_vjp(s, causal, dtype):
    arrays = _inputs(s + causal, sq=s, d=32)
    jdt, tdt = _DT[dtype]
    q, k, v, do = _jax(arrays, jdt)
    _, vjp = jax.vjp(
        lambda a, b, c: FA._xla_reference(a, b, c, None, causal, None),
        q, k, v)
    want = vjp(do)
    got = _port_backward(arrays, causal, tdt)
    atol = 5e-2 if dtype == "bfloat16" else 2e-4
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(w), atol=atol)


def test_autograd_function_on_cpu_uses_the_plain_versions():
    """`FlashAttention` on CPU tensors: forward = the composed form, and
    its gradients = the plain backward; no kernel launches."""
    arrays = _inputs(7, sq=80, d=64)
    tq, tk, tv, tdo = [t.requires_grad_() for t in
                       _torch(arrays[:3], torch.float32)] + \
        [torch.from_numpy(arrays[3])]
    before = (TFA.flash_attention_cuda_fwd.launches,
              TFA.flash_attention_cuda_dkv.launches,
              TFA.flash_attention_cuda_dq.launches)
    out = TFA.flash_attention_fwd(tq, tk, tv, is_causal=True)
    out.backward(tdo)
    want = TFA._composed_attention(*_torch(arrays[:3], torch.float32), None,
                                   True, None)
    assert torch.equal(out.detach(), want)
    ref = _port_backward(arrays, True, torch.float32)
    for t, r in zip((tq, tk, tv), ref):
        assert torch.equal(t.grad, r)
    assert (TFA.flash_attention_cuda_fwd.launches,
            TFA.flash_attention_cuda_dkv.launches,
            TFA.flash_attention_cuda_dq.launches) == before


@pytest.mark.parametrize("use_amp", [False, True])
@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_sdpa_matches_jax(mask, use_amp):
    """`scaled_dot_product_attention` on CPU tensors (the composed form,
    scaled by ``1 / sqrt(d)`` in the input dtype) against the JAX
    package's, with and without bf16 auto_cast, which casts q, k, v and an
    additive mask to bf16.  f32 2e-5; bf16 2e-2."""
    rng = np.random.RandomState(11)
    q, k, v, _ = _inputs(11, b=2, h=2, sq=24, d=32)
    m = {None: None, "bool": rng.rand(2, 1, 24, 24) > 0.2,
         "additive": (rng.randn(2, 1, 24, 24) * 0.5).astype(np.float32)}[mask]
    causal = mask is None
    jargs = [paddle.to_tensor(a) for a in (q, k, v)]
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    jm = None if m is None else paddle.to_tensor(m)
    tm = None if m is None else torch.from_numpy(m)
    with JA.auto_cast(enable=use_amp, dtype="bfloat16"):
        want = JF.scaled_dot_product_attention(*jargs, attn_mask=jm,
                                               is_causal=causal)
    with TA.auto_cast(enable=use_amp, dtype="bfloat16"):
        got = TF.scaled_dot_product_attention(*targs, attn_mask=tm,
                                              is_causal=causal)
    assert got.dtype == (torch.bfloat16 if use_amp else torch.float32)
    np.testing.assert_allclose(_np(got), _np(want._array),
                               atol=2e-2 if use_amp else 2e-5)


# ---------------------------------------------------------------------------
# routing and the wrappers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mask", "cross_length_causal"])
def test_mask_and_cross_length_causal_take_the_composed_form(monkeypatch,
                                                             case):
    """As in the JAX package: the kernels mask top-left, the composed form
    bottom-right, so these never reach `FlashAttention`."""
    def boom(*a):
        raise AssertionError("FlashAttention taken")

    monkeypatch.setattr(TFA.FlashAttention, "apply", boom)
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(1, 2, 16, 64).astype(np.float32))
    kv = torch.from_numpy(rng.randn(1, 2, 40, 64).astype(np.float32))
    if case == "mask":
        mask = torch.from_numpy(rng.rand(1, 1, 16, 40) > 0.3)
        got = TFA.flash_attention_fwd(q, kv, kv, mask=mask)
        want = FA.flash_attention_fwd(*_jax([q.numpy(), kv.numpy(),
                                             kv.numpy()], jnp.float32),
                                      mask=jnp.asarray(mask.numpy()))
    else:
        got = TFA.flash_attention_fwd(q, kv, kv, is_causal=True)
        want = FA.flash_attention_fwd(*_jax([q.numpy(), kv.numpy(),
                                             kv.numpy()], jnp.float32),
                                      is_causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch on CUDA tensors only: they never compute a CPU
    answer themselves."""
    tq, tk, tv, tdo = _torch(_inputs(9, sq=64), torch.float32)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fwd":
            TFA.flash_attention_cuda_fwd(tq, tk, tv, True)
        elif kernel == "dkv":
            TFA.flash_attention_cuda_dkv(tq, tk, tv, tq, lse, tdo, True)
        else:
            TFA.flash_attention_cuda_dq(tq, tk, tv, tq, lse, tdo, True)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lse_shape", "rank"])
def test_cuda_wrappers_validate_shapes(bad):
    tq, tk, tv, tdo = _torch(_inputs(10, sq=64), torch.float32)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match={"head_dim": "head_dim",
                                          "dtype": "float32 or bfloat16",
                                          "lse_shape": "lse",
                                          "rank": "rank"}[bad]):
        if bad == "head_dim":
            TFA.flash_attention_cuda_fwd(tq[..., :32], tk[..., :32],
                                         tv[..., :32], True)
        elif bad == "dtype":
            TFA.flash_attention_cuda_fwd(tq.half(), tk.half(), tv.half(),
                                         True)
        elif bad == "lse_shape":
            TFA.flash_attention_cuda_dq(tq, tk, tv, tq, lse[:, :10], tdo,
                                        True)
        else:
            TFA.flash_attention_cuda_fwd(tq[0], tk[0], tv[0], True)


# ---------------------------------------------------------------------------
# the tensor-core kernels' rounding, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke_flash_tol():
    """chip_smoke.py's stated K3/K4 tolerances (its module level is
    constants and the standard library's imports)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_TOL


# the bound of the bf16 kernels against the plain versions on the card
FLASH_TOL_BF16 = _chip_smoke_flash_tol()["bfloat16"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, o, lse, do, causal):
    """What the bf16 tensor-core kernels compute, in f32 on bf16 inputs:
    the plain versions' formulas with the kernels' rounding points.  The
    scale multiplies the f32 product ``q k^T``; p is exp(s - max) in f32
    and meets ``p v`` (forward) rounded to bf16.  In the backward p meets
    ``p^T dout`` (dv) and ds meets ``ds^T q`` (dk) and ``ds k`` (dq),
    each split, as the kernels do, into a bf16 high part plus a bf16
    remainder.  The backward takes ``o``, ``lse`` (the plain forward's,
    as on the card).  Returns out, lse [B*H, Sq], dq, dk, dv."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)

    def split(p):
        hi = _bf16(p)
        return hi + _bf16(p - hi)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool).tril()
        s = torch.where(visible, s, TFA._MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", _bf16(p), v.float()) / den
    out_lse = (m + torch.log(den)).reshape(b * h, sq)
    dof = do.float()
    p = torch.exp(s - lse.float().reshape(b, h, sq, 1))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, v.float()) - delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", split(p), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", split(ds), q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", split(ds), k.float()) * scale
    return (out.to(q.dtype), out_lse, dq.to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _emulation_errors(arrays, causal):
    """Max abs errors of `_tensor_core_emulation` against the plain
    versions (the backward on the plain forward's out and lse), bf16."""
    tq, tk, tv, tdo = _torch(arrays, torch.bfloat16)
    ref, ref_lse = TFA._composed_attention(tq, tk, tv, None, causal, None,
                                           want_lse=True)
    ref_lse = ref_lse.reshape(-1, tq.shape[2])
    want = TFA.flash_attention_bwd_reference(tq, tk, tv, ref, ref_lse, tdo,
                                             causal, None)
    got = _tensor_core_emulation(tq, tk, tv, ref, ref_lse, tdo, causal)
    return {name: float((g.float() - w.float()).abs().max())
            for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got,
                                  (ref, ref_lse) + tuple(want))}


@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_rounding_holds_the_card_tolerance(d):
    """The bf16 kernels' rounding points (scale on the f32 product, p
    rounded in the forward, p and ds split in two bf16 parts in the
    backward) on unit-normal inputs as chip_smoke.py draws them (B=1,
    H=2, S=1024, causal) stay within the card's bf16 tolerance of the
    unchanged plain versions."""
    rng = np.random.default_rng(d)
    arrays = [rng.standard_normal((1, 2, 1024, d), dtype=np.float32)
              for _ in range(4)]
    errs = _emulation_errors(arrays, causal=True)
    assert all(errs[n] <= FLASH_TOL_BF16[n] for n in errs), errs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, tol):
    """K3 and K4 on the card against the plain versions on the same
    inputs: causal and full, a ragged length, head_dim 64 and 128, and a
    non-causal cross length; each call launches each kernel once."""
    for seed, (b, h, sq, sk, d, causal) in enumerate([
            (2, 3, 128, 128, 64, True), (2, 3, 128, 128, 64, False),
            (1, 2, 100, 100, 64, True), (1, 2, 200, 200, 128, True),
            (1, 2, 70, 150, 128, False)]):
        arrays = _inputs(seed, b=b, h=h, sq=sq, sk=sk, d=d)
        tq, tk, tv, tdo = [t.to(cuda_device) for t in _torch(arrays, dtype)]
        n0 = (TFA.flash_attention_cuda_fwd.launches,
              TFA.flash_attention_cuda_dkv.launches,
              TFA.flash_attention_cuda_dq.launches)
        out, lse = TFA.flash_attention_cuda_fwd(tq, tk, tv, causal)
        ref, ref_lse = TFA._composed_attention(tq, tk, tv, None, causal,
                                               None, want_lse=True)
        ref_lse = ref_lse.reshape(b * h, sq)
        dk, dv = TFA.flash_attention_cuda_dkv(tq, tk, tv, ref, ref_lse, tdo,
                                              causal)
        dq = TFA.flash_attention_cuda_dq(tq, tk, tv, ref, ref_lse, tdo,
                                         causal)
        want = TFA.flash_attention_bwd_reference(tq, tk, tv, ref, ref_lse,
                                                 tdo, causal, None)
        torch.cuda.synchronize()
        assert (TFA.flash_attention_cuda_fwd.launches,
                TFA.flash_attention_cuda_dkv.launches,
                TFA.flash_attention_cuda_dq.launches) == tuple(
                    n + 1 for n in n0)
        for got, ref_t in [(out, ref), (lse, ref_lse),
                           *zip((dq, dk, dv), want)]:
            assert float((got.float() - ref_t.float()).abs().max()) <= tol


_BF16_CASES = [(s, s, d, causal) for s in (1, 17, 63, 65, 129, 1000)
               for d in (64, 128) for causal in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal",
                         _BF16_CASES + [(70, 150, 128, False)])
def test_cuda_bf16_kernels_match_plain_versions(cuda_device, sq, sk, d,
                                                causal):
    """The bf16 tensor-core K3/K4 against the plain versions at ragged
    lengths (one row up to a tile and a bit), head_dim 64 and 128, causal
    and not, and a non-causal cross length, under the card's bf16
    tolerance; every call launches its kernel once."""
    b, h = 2, 3
    arrays = _inputs(sq * 7 + d + causal, b=b, h=h, sq=sq, sk=sk, d=d)
    tq, tk, tv, tdo = [t.to(cuda_device) for t in
                       _torch(arrays, torch.bfloat16)]
    n0 = (TFA.flash_attention_cuda_fwd.launches,
          TFA.flash_attention_cuda_dkv.launches,
          TFA.flash_attention_cuda_dq.launches)
    out, lse = TFA.flash_attention_cuda_fwd(tq, tk, tv, causal)
    ref, ref_lse = TFA._composed_attention(tq, tk, tv, None, causal, None,
                                           want_lse=True)
    ref_lse = ref_lse.reshape(b * h, sq)
    dk, dv = TFA.flash_attention_cuda_dkv(tq, tk, tv, ref, ref_lse, tdo,
                                          causal)
    dq = TFA.flash_attention_cuda_dq(tq, tk, tv, ref, ref_lse, tdo, causal)
    want = TFA.flash_attention_bwd_reference(tq, tk, tv, ref, ref_lse, tdo,
                                             causal, None)
    torch.cuda.synchronize()
    assert (TFA.flash_attention_cuda_fwd.launches,
            TFA.flash_attention_cuda_dkv.launches,
            TFA.flash_attention_cuda_dq.launches) == tuple(n + 1 for n in n0)
    for name, got, ref_t in [("out", out, ref), ("lse", lse, ref_lse),
                             ("dq", dq, want[0]), ("dk", dk, want[1]),
                             ("dv", dv, want[2])]:
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - ref_t.float()).abs().max())
        assert err <= FLASH_TOL_BF16[name], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_bf16_backward_is_deterministic(cuda_device, d):
    """Every gradient tile has one writer (no atomics): two launches of
    the backward on the same inputs give bitwise-equal dq, dk and dv."""
    arrays = _inputs(40 + d, b=2, h=3, sq=300, d=d)
    tq, tk, tv, tdo = [t.to(cuda_device) for t in
                       _torch(arrays, torch.bfloat16)]
    out, lse = TFA.flash_attention_cuda_fwd(tq, tk, tv, True)
    runs = [(TFA.flash_attention_cuda_dq(tq, tk, tv, out, lse, tdo, True),
             *TFA.flash_attention_cuda_dkv(tq, tk, tv, out, lse, tdo, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


if __name__ == "__main__":
    # The rehearsal at chip_smoke.py's bf16 shapes (a few GB of f32 on the
    # CPU, minutes): max abs errors of the emulated kernels against the
    # plain versions, four heads at a time.
    shapes = {"train": (16, 12, 1024, 64, True),
              "full": (16, 12, 1024, 64, False),
              "ragged": (16, 12, 1000, 64, True),
              "d128": (2, 16, 2048, 128, True)}
    torch.set_num_threads(8)
    for name, (b, h, s, d, causal) in shapes.items():
        rng = np.random.default_rng(0)
        worst = {}
        for _ in range(b * h // 4):
            arrays = [rng.standard_normal((1, 4, s, d), dtype=np.float32)
                      for _ in range(4)]
            for n, e in _emulation_errors(arrays, causal).items():
                worst[n] = max(worst.get(n, 0.0), e)
        bad = [n for n in worst if worst[n] > FLASH_TOL_BF16[n]]
        print(f"{name:>6}: " + " ".join(f"{n} {e:.4g}"
                                        for n, e in worst.items())
              + (f"  beyond {bad}" if bad else ""), flush=True)
