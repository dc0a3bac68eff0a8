"""paddle_tpu_torch paged attention against the JAX package.

The port's plain version (`paged_attention_reference`, the route every
CPU tensor takes) is held against the JAX XLA reference
(`_xla_paged_attention`) and against the Pallas kernel run in interpret
mode (`_pallas_paged_attention`), on the same inputs made with numpy.
Tolerances: f32 2e-5 (two frameworks sum in different orders); bf16
2e-2 (bf16 rounds logits, probabilities and the output at ~2**-8
relative, at different points in the two frameworks); Pallas-form vs
XLA-form scale placement is covered by the same bounds.  The CUDA
kernel itself is checked on the card only (`cuda` marker).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.ops.pallas import paged_attention as PA
from paddle_tpu_torch.ops import paged_attention as TPA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _paged_inputs(seed, b=3, hq=4, hkv=2, d=32, page=16, pages_max=8,
                  lens=(37, 0, 128), qn=None, dtype=np.float32):
    """Random page pools + a shuffled block table, as numpy arrays (the
    shapes of tests/test_paged_decode.py); ``qn`` adds a query axis."""
    rng = np.random.RandomState(seed)
    npages = b * pages_max + 3
    k_pages = rng.randn(hkv, npages, page, d).astype(dtype)
    v_pages = rng.randn(hkv, npages, page, d).astype(dtype)
    bt = rng.permutation(npages)[:b * pages_max].reshape(b, pages_max)
    qshape = (b, hq, d) if qn is None else (b, qn, hq, d)
    q = rng.randn(*qshape).astype(dtype)
    return q, k_pages, v_pages, bt.astype(np.int32), \
        np.asarray(lens, np.int32)


def _jax(arrays, dtype=None):
    out = [jnp.asarray(a) for a in arrays]
    if dtype is not None:
        out = [a.astype(dtype) if a.dtype == jnp.float32 else a
               for a in out]
    return out


def _torch(arrays, dtype=None):
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    if dtype is not None:
        out = [t.to(dtype) if t.dtype == torch.float32 else t for t in out]
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (inputs kwargs, q_offsets or None) per case
_CASES = {
    "ragged": (dict(), None),
    "gqa": (dict(hq=8, hkv=2, lens=(40, 17, 96)), None),
    "zero_len": (dict(lens=(16, 0, 48)), None),
    "multi_query": (dict(qn=5, lens=(37, 0, 128)), (32, 0, 100)),
    "multi_query_gqa": (dict(qn=4, hq=8, hkv=2, lens=(21, 64, 9)),
                        (17, 60, 0)),
    "head_dim_64": (dict(d=64, lens=(70, 5, 128)), None),
    # a seq_len past the block table's reach (5 pages of 16)
    "past_horizon": (dict(pages_max=5, lens=(37, 0, 120)), None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("against", ["xla", "pallas"])
def test_reference_matches_jax(case, dtype, against, request):
    if against == "pallas":
        request.getfixturevalue("interpret_pallas")
    kw, offs = _CASES[case]
    arrays = _paged_inputs(sorted(_CASES).index(case), **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    q, kp, vp, bt, lens = _jax(arrays, jdt)
    jfn = PA._xla_paged_attention if against == "xla" else \
        PA._pallas_paged_attention
    ref = jfn(q, kp, vp, bt, lens,
              q_offsets=None if offs is None else jnp.asarray(offs,
                                                              jnp.int32))
    tq, tkp, tvp, tbt, tlens = _torch(arrays, tdt)
    out = TPA.paged_attention_reference(
        tq, tkp, tvp, tbt, tlens,
        q_offsets=None if offs is None else torch.tensor(offs,
                                                         dtype=torch.int32))
    assert out.dtype == (tdt or torch.float32)
    assert tuple(out.shape) == tuple(ref.shape)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)
    zero = [i for i, n in enumerate(arrays[4]) if n == 0]
    if zero:
        assert float(out[zero].abs().max()) == 0.0  # exact zeros


def test_public_entry_routes_cpu_to_reference():
    arrays = _paged_inputs(6)
    tq, tkp, tvp, tbt, tlens = _torch(arrays)
    before = TPA.paged_attention_cuda.launches
    out = TPA.paged_attention(tq, tkp, tvp, tbt, tlens)
    ref = TPA.paged_attention_reference(tq, tkp, tvp, tbt, tlens)
    assert torch.equal(out, ref)
    assert TPA.paged_attention_cuda.launches == before


def test_public_entry_validates_like_jax():
    tq, tkp, tvp, tbt, tlens = _torch(_paged_inputs(5))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        TPA.paged_attention(tq[:, :3], tkp, tvp, tbt, tlens)
    with pytest.raises(ValueError, match="head_dim"):
        TPA.paged_attention(tq[..., :16], tkp, tvp, tbt, tlens)
    with pytest.raises(ValueError, match="rank"):
        TPA.paged_attention(tq[0], tkp, tvp, tbt, tlens)
    # int8 pages need their scales, of the pool's [Hkv, num_pages]
    k8, v8 = tkp.to(torch.int8), tvp.to(torch.int8)
    with pytest.raises(ValueError, match="k_scales/v_scales"):
        TPA.paged_attention(tq, k8, v8, tbt, tlens)
    ok = torch.ones(k8.shape[:2])
    with pytest.raises(ValueError, match="v_scales shape"):
        TPA.paged_attention(tq, k8, v8, tbt, tlens, k_scales=ok,
                            v_scales=ok[:, :-1])
    with pytest.raises(ValueError, match="non-int8"):
        TPA.paged_attention(tq, tkp, tvp, tbt, tlens, k_scales=ok,
                            v_scales=ok)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only — it never computes a
    CPU answer itself."""
    tq, tkp, tvp, tbt, tlens = _torch(_paged_inputs(7, d=64, qn=1))
    with pytest.raises(ValueError, match="CUDA"):
        TPA.paged_attention_cuda(tq, tkp, tvp, tbt, tlens, tlens - 1)


@pytest.mark.parametrize("max_len", [1024, 1056, 48, 17, 16, 64, 100,
                                     4096, 50])
def test_page_size_rules_match_jax(max_len):
    assert TPA.pick_page_size(max_len) == PA.pick_page_size(max_len)
    assert TPA.pick_page_size(max_len, 32) == PA.pick_page_size(max_len, 32)
    assert TPA.default_page_size(max_len) == \
        (PA.pick_page_size(max_len) or PA._MIN_PAGE_SIZE)


def _write_inputs(seed, b=4, pages_max=5, page=8, qn=6):
    rng = np.random.RandomState(seed)
    npages = b * pages_max + 2
    bt = rng.permutation(npages)[:b * pages_max].reshape(b, pages_max)
    # the last slot's rows run past the block table's horizon, the
    # second is inactive (cap 0), the third partly capped
    lens = np.array([3, 0, 17, pages_max * page - 2], np.int32)
    caps = np.array([qn, 0, 2, qn], np.int32)
    return bt.astype(np.int32), lens, caps, npages, page, qn


def test_paged_write_indices_match_jax():
    bt, lens, caps, npages, page, qn = _write_inputs(0)
    jp, js = PA.paged_write_indices(jnp.asarray(bt), jnp.asarray(lens),
                                    jnp.asarray(caps), qn, npages, page)
    tp, ts = TPA.paged_write_indices(torch.from_numpy(bt),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(caps), qn, npages,
                                     page)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_masked_scatter_drops_capped_rows_like_jax():
    """JAX drops a scatter row at page id == num_pages; torch would
    raise, so the port's pool holds one page more, the drop page, where
    those rows land — every live page must come out identical to JAX's,
    capped rows leaving no trace there, and the write keeps its shape."""
    bt, lens, caps, npages, page, qn = _write_inputs(1)
    b, hkv, d = bt.shape[0], 3, 4
    rng = np.random.RandomState(2)
    pages = rng.randn(hkv, npages, page, d).astype(np.float32)
    vals = rng.randn(b, qn, hkv, d).astype(np.float32)
    jp, js = PA.paged_write_indices(jnp.asarray(bt), jnp.asarray(lens),
                                    jnp.asarray(caps), qn, npages, page)
    want = jnp.asarray(pages).at[:, jp, js, :].set(
        jnp.asarray(vals).transpose(2, 0, 1, 3))
    tp, ts = TPA.paged_write_indices(torch.from_numpy(bt),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(caps), qn, npages,
                                     page)
    rows = TPA.paged_write_rows(tp, ts)
    assert len(rows[0]) == b * qn  # every row, dropped ones too
    assert int((rows[0] < npages).sum()) == int(caps.sum())
    got = torch.zeros(hkv, npages + 1, page, d)
    got[:, :npages] = torch.from_numpy(pages)
    TPA.paged_write(got, rows, torch.from_numpy(vals).reshape(b * qn, hkv,
                                                              d))
    np.testing.assert_array_equal(got[:, :npages].numpy(), np.asarray(want))


def _strided(q):
    """q as a view with the serving steps' strides: the q slice of a
    fused [B, Q, 3, Hq, D] qkv."""
    big = torch.zeros(q.shape[0], q.shape[1], 3, *q.shape[2:],
                      dtype=q.dtype, device=q.device)
    big[:, :, 0] = q
    return big[:, :, 0]


# (head_dim, Hq, Hkv, Q, page, pages_max, seq_lens) of the kernel cases:
# both paths (SIMT below Q * group = 16, tensor cores from it, just below
# and at the threshold at head_dim 64 and 128), one split and several,
# pages of 16, 32 and 64 (a 64-position tile spans several pages), a
# zero-length slot in every case, seq_lens at and past the block table's
# reach (pages_max * page)
_KERNEL_CASES = [
    (64, 12, 12, 1, 16, 8, (37, 0, 128)),
    (64, 12, 12, 7, 16, 8, (37, 0, 128)),
    (128, 32, 8, 1, 16, 8, (37, 0, 128)),
    (128, 8, 2, 9, 16, 8, (37, 0, 128)),
    (64, 12, 12, 1, 16, 5, (37, 0, 120)),
    (64, 12, 12, 7, 16, 5, (37, 0, 120)),
    (64, 12, 12, 15, 32, 8, (200, 0, 256)),
    (64, 12, 12, 16, 32, 8, (200, 0, 256)),
    (128, 15, 1, 1, 64, 4, (100, 0, 300)),
    (128, 16, 1, 1, 64, 4, (100, 0, 256)),
    (128, 4, 2, 8, 32, 8, (90, 0, 256)),
    (64, 12, 12, 64, 64, 16, (700, 0, 1024)),
    (64, 12, 12, 1, 16, 4, (60, 0, 64)),
    (64, 12, 12, 16, 16, 4, (60, 0, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_reference(cuda_device, dtype, tol):
    """K1 on the card against the plain version over `_KERNEL_CASES`
    (GQA, ragged lengths, a zero-length slot giving exact zeros,
    multi-query with offsets, head_dim 64 and 128, both paths, one split
    and several, pages of 16 to 64, seq_lens past the block table's
    reach); q strided as the serving steps pass it in every other case;
    two launches bitwise equal."""
    for seed, (d, hq, hkv, qn, page, pages_max, lens) in enumerate(
            _KERNEL_CASES):
        arrays = _paged_inputs(seed, b=3, hq=hq, hkv=hkv, d=d, page=page,
                               pages_max=pages_max, lens=lens, qn=qn)
        tq, tkp, tvp, tbt, tlens = [t.to(cuda_device)
                                    for t in _torch(arrays, dtype)]
        if seed % 2:
            tq = _strided(tq)
        offs = tlens - qn
        before = TPA.paged_attention_cuda.launches
        out = TPA.paged_attention(tq, tkp, tvp, tbt, tlens, q_offsets=offs)
        again = TPA.paged_attention(tq, tkp, tvp, tbt, tlens, q_offsets=offs)
        ref = TPA.paged_attention_reference(tq, tkp, tvp, tbt, tlens,
                                            q_offsets=offs)
        torch.cuda.synchronize()
        assert TPA.paged_attention_cuda.launches == before + 2
        err = float((out.float() - ref.float()).abs().max())
        assert err <= tol, (seed, err)
        assert float(out[1].abs().max()) == 0.0
        assert torch.equal(out, again), seed
