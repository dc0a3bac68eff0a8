"""paddle_tpu_torch quantized serving against the JAX package.

int8 weights (`quantize_weight`, `_quantize_gpt_params`, `_wmm`), the
quantized KV write (`paged_write_spans`, `paged_quant_write`), the int8
paged-attention plain version (K2's CPU route) and the engine with
``kv_quant="int8"`` and ``serve_weights="int8"``, each held against the
JAX package on the same inputs made with numpy.  Tolerances are stated
per test.  Kernel K2 itself is checked on the card only (`cuda`
marker).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.ops.pallas import paged_attention as PA
from paddle_tpu.quantization import int8 as JQ
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.ops import paged_attention as TPA
from paddle_tpu_torch.quantization import int8 as TQ

# the configs of tests/test_torch_serving.py
CONFIGS = {
    "tiny": dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=128, use_parallel_layers=False, dropout=0.0),
    "head_dim_64": dict(vocab_size=96, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=128,
                        use_parallel_layers=False, dropout=0.0),
    "untied": dict(vocab_size=64, hidden_size=32, num_layers=2,
                   num_heads=4, max_seq_len=128, use_parallel_layers=False,
                   dropout=0.0, tie_embeddings=False),
}
STAT_KEYS = ("steps", "tokens", "mixed_steps", "prefill_chunks",
             "prefix_hits", "prefix_misses", "prefix_cached_tokens",
             "kv_quant_pages", "kv_quant_refolds", "weight_quant_mats",
             "weight_quant_bytes_saved")
MODES = {"kv": dict(kv_quant="int8"), "weights": dict(serve_weights="int8"),
         "both": dict(kv_quant="int8", serve_weights="int8")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _models(name, seed):
    kw = CONFIGS[name]
    paddle.seed(seed)
    m = GPT(GPTConfig(**kw))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    tm = TGPT.from_params(TGPTConfig(**kw),
                          params_from_numpy(tree, device="cpu"))
    return m, tm


def _prompts(seed, lens, vocab=64):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((32, 96), 1), ((96, 32), 0),
                                        ((4, 5, 6), 1), ((7, 3), 1)])
def test_quantize_weight_bit_equal_to_jax(shape, axis):
    """Payloads and scales bit-equal: the same ops in the same order, and
    round half to even on both sides (the 0.5 and -2.5 multiples and a
    zero channel are in the input)."""
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w.reshape(-1)[:3] = [0.5, -2.5, 1.5]  # exact halves after scaling
    np.moveaxis(w, axis, 0)[-1] = 0.0  # an all-zero channel
    jq, js = JQ.quantize_weight(jnp.asarray(w), quant_axis=axis)
    tq, ts = TQ.quantize_weight(torch.from_numpy(w), quant_axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert TQ.Q_MAX == JQ.Q_MAX


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantize_gpt_params_matches_jax(name):
    """The folded tree: the same leaves (``*_q`` int8 and ``*_s`` f32 for
    every matmul weight, the untied head included, wte kept f32), values
    bit-equal, and the same matrix and byte counts."""
    m, _ = _models(name, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    jtree, jmats, jsaved = JS._quantize_gpt_params(
        jax.tree_util.tree_map(jnp.asarray, tree))
    ttree, tmats, tsaved = TS._quantize_gpt_params(
        params_from_numpy(tree, device="cpu"))
    assert (tmats, tsaved) == (jmats, int(jsaved))
    assert tmats == 4 * 2 + (name == "untied")
    assert set(ttree) == set(jtree)
    pairs = [(ttree[k], jtree[k]) for k in jtree if k != "blocks"]
    for tb, jb in zip(ttree["blocks"], jtree["blocks"]):
        assert set(tb) == set(jb)
        pairs += [(tb[k], jb[k]) for k in jb]
    for t, j in pairs:
        if j is None:
            assert t is None
            continue
        assert t.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[
            np.asarray(j).dtype]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_wmm_is_the_dequantized_product():
    """Off: ``x @ w`` itself.  int8: ``(x @ q) * s`` equals ``x @ (q *
    s)`` within f32 rounding (the per-out-channel scale commutes past the
    contraction), 1e-6 at these magnitudes, and ``x @ w`` within the
    quantization step's bound."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 32).astype(np.float32))
    w = torch.from_numpy((rng.randn(32, 48) * 0.02).astype(np.float32))
    assert torch.equal(TS._wmm(x, {"a_w": w}, "a_w"), x @ w)
    q, scale = TQ.quantize_weight(w, quant_axis=1)
    s = scale / TQ.Q_MAX
    got = TS._wmm(x, {"a_w_q": q, "a_w_s": s}, "a_w")
    torch.testing.assert_close(got, x @ (q.float() * s), atol=1e-6,
                               rtol=0)
    # against the f32 weights: each weight moves at most half a step
    bound = x.abs().sum(dim=1, keepdim=True) * (s / 2) + 1e-6
    assert bool(((got - x @ w).abs() <= bound).all())


def test_params_from_numpy_keeps_int8_leaves():
    """``dtype=`` widens or narrows the floating leaves only: int8
    payloads keep their dtype and values."""
    rng = np.random.RandomState(1)
    tree = {"wte": rng.randn(4, 8).astype(np.float32),
            "blocks": [{"qkv_w_q": rng.randint(-127, 128, (8, 24)).astype(
                np.int8), "qkv_w_s": rng.rand(24).astype(np.float32)}]}
    out = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16,
                            requires_grad=True)
    assert out["wte"].dtype == torch.bfloat16 and out["wte"].requires_grad
    q = out["blocks"][0]["qkv_w_q"]
    assert q.dtype == torch.int8 and not q.requires_grad
    np.testing.assert_array_equal(q.numpy(), tree["blocks"][0]["qkv_w_q"])
    assert out["blocks"][0]["qkv_w_s"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the quantized KV write
# ---------------------------------------------------------------------------
def _write_case(seed, b=4, pages_max=5, page=8, qn=6):
    rng = np.random.RandomState(seed)
    npages = b * pages_max + 2
    bt = rng.permutation(npages)[:b * pages_max].reshape(b, pages_max)
    # slot 1 inactive (cap 0), slot 2 partly capped and unaligned, slot 3
    # running past the block table's horizon (its last rows drop)
    lens = np.array([3, 0, 13, pages_max * page - 2], np.int32)
    caps = np.array([qn, 0, 2, qn], np.int32)
    return bt.astype(np.int32), lens, caps, npages, page, qn


@pytest.mark.parametrize("seed,qn,page", [(0, 6, 8), (1, 17, 4), (2, 1, 16),
                                          (3, 33, 8)])
def test_paged_write_spans_match_jax(seed, qn, page):
    bt, lens, caps, npages, page, qn = _write_case(seed, page=page, qn=qn)
    want = PA.paged_write_spans(jnp.asarray(bt), jnp.asarray(lens),
                                jnp.asarray(caps), qn, npages, page)
    got = TPA.paged_write_spans(torch.from_numpy(bt), torch.from_numpy(lens),
                                torch.from_numpy(caps), qn, npages, page)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _coords(bt, lens, caps, qn, npages, page, spans):
    """The write coordinates of both packages: dropped rows at page id
    ``npages`` (JAX drops them, the port writes them into its drop
    page)."""
    args = (bt, lens, caps)
    jp, js = PA.paged_write_indices(*map(jnp.asarray, args), qn, npages,
                                    page)
    tp, ts = TPA.paged_write_indices(*map(torch.from_numpy, args), qn,
                                     npages, page)
    jspan = tspan = None
    if spans:
        jspan = PA.paged_write_spans(*map(jnp.asarray, args), qn, npages,
                                     page)
        tspan = TPA.paged_write_spans(*map(torch.from_numpy, args), qn,
                                      npages, page)
    rows = TPA.paged_write_rows(tp, ts, tspan)
    return (jp.reshape(-1), js.reshape(-1), jspan), rows


@pytest.mark.parametrize("spans", [True, False], ids=["spans", "per_row"])
def test_paged_quant_write_matches_jax(spans):
    """Three writes into layer 1 of a two-layer pool whose pages start
    as garbage: a fresh page wipes it (ratio 0), later rows of larger
    magnitude grow a page's scale and refold its rows, capped rows and
    span slots drop, several rows share a page (and, per row, the span
    ids repeat).  The port's pools hold a drop page past JAX's, where
    the dropped rows and spans land.  Live payloads exact, scales within
    1e-7 (the same f32 ops in the same order: equal in practice), refold
    counts equal."""
    h, d, li = 3, 4, 1
    bt, lens, caps, npages, page, qn = _write_case(5)
    rng = np.random.RandomState(6)
    pages = rng.randint(-127, 128, (2, h, npages, page, d)).astype(np.int8)
    scales = np.zeros((2, h, npages), np.float32)
    scales[0] = rng.rand(h, npages)  # another layer's: left untouched
    jpages, jscales = jnp.asarray(pages), jnp.asarray(scales)
    tpages = torch.zeros(2, h, npages + 1, page, d, dtype=torch.int8)
    tscales = torch.zeros(2, h, npages + 1)
    tpages[:, :, :npages] = torch.from_numpy(pages)
    tscales[:, :, :npages] = torch.from_numpy(scales)
    refolds = []
    for step, mag in enumerate((1.0, 3.0, 0.5)):
        vals = (rng.randn(len(bt) * qn, h, d) * mag).astype(np.float32)
        (jp, js, jspan), rows = _coords(bt, lens, caps, qn, npages, page,
                                        spans)
        jpages, jscales, jr = PA.paged_quant_write(
            jpages, jscales, li, jnp.asarray(vals), jp, js, jspan)
        tr = TPA.paged_quant_write(tpages[li], tscales[li], rows,
                                   torch.from_numpy(vals))
        assert tr.dtype == torch.int32
        refolds.append((int(tr), int(jr)))
        np.testing.assert_array_equal(tpages[:, :, :npages].numpy(),
                                      np.asarray(jpages))
        np.testing.assert_allclose(tscales[:, :, :npages].numpy(),
                                   np.asarray(jscales), atol=1e-7, rtol=0)
        lens = lens + caps
    assert [t for t, _ in refolds] == [j for _, j in refolds]
    assert refolds[0][0] == 0 and refolds[1][0] > 0
    np.testing.assert_array_equal(tpages[0, :, :npages].numpy(), pages[0])


def test_quant_write_rows_pay_one_fetch(monkeypatch):
    """The write coordinates, spans included, wait for the device in no
    way: no `tolist`, no `nonzero` (the one fetch a step pays is its
    token fetch), and they keep every row and span, dropped ones at page
    id ``npages``, in the order of the step's rows."""
    bt, lens, caps, npages, page, qn = _write_case(7)
    args = [torch.from_numpy(a) for a in (bt, lens, caps)]
    tp, ts = TPA.paged_write_indices(*args, qn, npages, page)
    span = TPA.paged_write_spans(*args, qn, npages, page)
    calls = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: calls.append(1) or real(t))
    monkeypatch.setattr(torch, "nonzero", None)
    p, s, sp = TPA.paged_write_rows(tp, ts, span)
    assert not calls
    np.testing.assert_array_equal(p.numpy(), tp.reshape(-1).numpy())
    np.testing.assert_array_equal(s.numpy(), ts.reshape(-1).numpy())
    np.testing.assert_array_equal(sp.numpy(), span.numpy())
    keep = p.numpy() < npages
    assert keep.sum() == caps.sum() and not keep.all()


# ---------------------------------------------------------------------------
# the int8 plain version (K2's CPU route)
# ---------------------------------------------------------------------------
def _quant_inputs(seed, b=3, hq=4, hkv=2, d=32, page=16, pages_max=8,
                  lens=(37, 0, 128), qn=None):
    rng = np.random.RandomState(seed)
    npages = b * pages_max + 3
    kp = rng.randint(-127, 128, (hkv, npages, page, d)).astype(np.int8)
    vp = rng.randint(-127, 128, (hkv, npages, page, d)).astype(np.int8)
    ks = (rng.rand(hkv, npages) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(hkv, npages) * 0.02 + 1e-3).astype(np.float32)
    bt = rng.permutation(npages)[:b * pages_max].reshape(b, pages_max)
    q = rng.randn(*((b, hq, d) if qn is None else (b, qn, hq, d))).astype(
        np.float32)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lens, np.int32), ks, vs


_CASES = {
    "ragged": (dict(), None),
    "gqa": (dict(hq=8, hkv=2, lens=(40, 17, 96)), None),
    "zero_len": (dict(lens=(16, 0, 48)), None),
    "multi_query": (dict(qn=5), (32, 0, 100)),
    "multi_query_gqa": (dict(qn=4, hq=8, hkv=2, lens=(21, 64, 9)),
                        (17, 60, 0)),
    "head_dim_64": (dict(d=64, lens=(70, 5, 128)), None),
    # 4-position pages: a K2 tile of 32 positions spans 8 pages
    "page_4": (dict(page=4, pages_max=32, qn=3, lens=(37, 0, 128)),
               (34, 0, 125)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("against", ["xla", "pallas"])
def test_quant_reference_matches_jax(case, dtype, against, request):
    """The int8 plain version against `_xla_paged_attention` and the
    interpret-mode Pallas K2 (`_decode_kernel_q`) on the same int8 pages
    and scales.  The dequantized operands are the same on all three
    sides (int8 -> f32, times the scale, cast to q's dtype); the
    tolerances are K1's test's: f32 2e-5, bf16 2e-2."""
    if against == "pallas":
        request.getfixturevalue("interpret_pallas")
    kw, offs = _CASES[case]
    q, kp, vp, bt, lens, ks, vs = _quant_inputs(sorted(_CASES).index(case),
                                                **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jfn = PA._xla_paged_attention if against == "xla" else \
        PA._pallas_paged_attention
    ref = jfn(jnp.asarray(q).astype(jdt), jnp.asarray(kp), jnp.asarray(vp),
              jnp.asarray(bt), jnp.asarray(lens),
              q_offsets=None if offs is None else jnp.asarray(offs,
                                                              jnp.int32),
              k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    out = TPA.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(bt), torch.from_numpy(lens),
        q_offsets=None if offs is None else torch.tensor(offs,
                                                         dtype=torch.int32),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=2e-2 if dtype == "bfloat16" else 2e-5)
    zero = [i for i, n in enumerate(lens) if n == 0]
    if zero:
        assert float(out[zero].abs().max()) == 0.0


def test_quant_entry_routes_cpu_to_reference():
    q, kp, vp, bt, lens, ks, vs = map(torch.from_numpy, _quant_inputs(3))
    before = (TPA.paged_attention_cuda.launches,
              TPA.paged_attention_cuda_q.launches)
    out = TPA.paged_attention(q, kp, vp, bt, lens, k_scales=ks, v_scales=vs)
    ref = TPA.paged_attention_reference(q, kp, vp, bt, lens, k_scales=ks,
                                        v_scales=vs)
    assert torch.equal(out, ref)
    assert (TPA.paged_attention_cuda.launches,
            TPA.paged_attention_cuda_q.launches) == before


def test_k2_wrapper_refuses_what_it_does_not_take():
    """K2 launches on CUDA tensors only, over int8 pages with f32 scales;
    it never computes a CPU answer itself."""
    q, kp, vp, bt, lens, ks, vs = map(torch.from_numpy, _quant_inputs(
        4, d=64, qn=1))
    with pytest.raises(ValueError, match="CUDA"):
        TPA.paged_attention_cuda_q(q, kp, vp, bt, lens, lens - 1,
                                   k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="k_scales"):
        TPA.paged_attention_cuda_q(q, kp, vp, bt, lens, lens - 1)
    with pytest.raises(ValueError, match="k_pages must be torch.int8"):
        TPA.paged_attention_cuda_q(q, kp.float(), vp.float(), bt, lens,
                                   lens - 1, k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="no scales"):
        TPA.paged_attention_cuda(q, kp.float(), vp.float(), bt, lens,
                                 lens - 1, k_scales=ks, v_scales=vs)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
def _serve_both(m, tm, prompts, max_new, **kw):
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **kw)
    jt, jr = je.generate(prompts, max_new, return_meta=True)
    jst = JS.decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", **kw)
    tt, tr = te.generate(prompts, max_new, return_meta=True)
    tst = te.decode_stats()
    for eng in (je, te):
        assert eng.pool.available_count == eng.pool.num_pages
    te.pool.assert_consistent(live_pages=[])
    assert tt == [[int(t) for t in o] for o in jt]
    assert tr == jr
    assert {k: int(tst[k]) for k in STAT_KEYS} == \
        {k: int(jst[k]) for k in STAT_KEYS}
    return je, te, tt, tst


def _assert_pools_close(je, te):
    """int8 pools within 1 LSB and scales within 1e-6 relative: the two
    packages' CPU matmuls round the K/V rows differently in the last f32
    bit, which can flip a rounding at a .5 boundary; the scales are
    absmax / 127 of those rows."""
    for j, t in ((je._k_pages, te._k_pages), (je._v_pages, te._v_pages)):
        assert t.dtype == torch.int8
        diff = np.abs(t[:, :, :-1].numpy().astype(np.int32)  # no drop page
                      - np.asarray(j).astype(np.int32))
        assert diff.max() <= 1
    for j, t in ((je._k_scales, te._k_scales), (je._v_scales, te._v_scales)):
        np.testing.assert_allclose(t[:, :, :-1].numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quant_engine_matches_jax(name, mode):
    """More requests than slots, ragged prompts streamed in 8-token
    chunks over 16-token pages (mixed steps write spans of two pages),
    then decode: greedy tokens, finish reasons and every counter equal
    the JAX engine's; the pools agree as `_assert_pools_close` says."""
    m, tm = _models(name, seed=5)
    prompts = _prompts(3, (5, 9, 13, 21), CONFIGS[name]["vocab_size"])
    je, te, _, st = _serve_both(m, tm, prompts, 6, max_batch_size=2,
                                max_seq_len=64, page_size=16,
                                prefill_chunk_tokens=8, **MODES[mode])
    if "kv_quant" in MODES[mode]:
        assert st["kv_quant_pages"] > 0 and st["kv_quant_refolds"] > 0
        _assert_pools_close(je, te)
    else:
        assert st["kv_quant_pages"] == 0 and te._k_scales is None
    if "serve_weights" in MODES[mode]:
        assert st["weight_quant_mats"] == 8 + (name == "untied")
    else:
        assert st["weight_quant_mats"] == 0


def test_quant_engine_small_pages_prefix_cache_matches_jax():
    """4-token pages (a refold on nearly every write), a shared prefix
    the later requests map from the cache, kv and weights int8."""
    m, tm = _models("tiny", seed=2)
    rng = np.random.RandomState(4)
    shared = rng.randint(0, 64, 12)
    prompts = [np.concatenate([shared, rng.randint(0, 64, n)]).astype(
        np.int32) for n in (3, 7, 1, 9)]
    je, te, _, st = _serve_both(m, tm, prompts, 5, max_batch_size=2,
                                max_seq_len=48, page_size=4,
                                prefill_chunk_tokens=8, kv_quant="int8",
                                serve_weights="int8")
    assert st["prefix_hits"] > 0
    _assert_pools_close(je, te)


def test_kv_quant_off_is_todays_engine():
    """Explicit "off" modes are the default engine: the same tokens and
    bit-identical f32 pools (the live pages: the drop page holds
    whichever dropped row landed last), no scales, no quant counter."""
    _, tm = _models("tiny", seed=8)
    prompts = _prompts(9, (5, 9, 13))
    kw = dict(max_batch_size=2, max_seq_len=64, page_size=16)
    a = TS.DecodeEngine(tm, device="cpu", **kw)
    b = TS.DecodeEngine(tm, device="cpu", kv_quant="off",
                        serve_weights="off", **kw)
    assert a.generate(prompts, 6) == b.generate(prompts, 6)
    for eng in (a, b):
        assert eng._k_pages.dtype == torch.float32
        assert eng._k_scales is None and "qkv_w" in eng._params["blocks"][0]
        assert all(eng.decode_stats()[k] == 0 for k in STAT_KEYS[7:])
    assert torch.equal(a._k_pages[:, :, :-1], b._k_pages[:, :, :-1])
    assert torch.equal(a._v_pages[:, :, :-1], b._v_pages[:, :, :-1])


def test_recycled_page_scale_reset_reproduces():
    """Port of tests/test_kv_quant.py's recycled-page test: serving one
    request, then enough others to recycle every page, then the first
    again gives bit-identical tokens (a recycled page's stale scale never
    leaks into its next owner)."""
    _, tm = _models("tiny", seed=0)
    page = 4
    pages_per_req = -(-(20 + 6 - 1) // page)
    eng = TS.DecodeEngine(tm, device="cpu", kv_quant="int8",
                          max_batch_size=1, max_seq_len=48, page_size=page,
                          prefill_chunk_tokens=8,
                          num_pages=pages_per_req + 2)

    def serve(seed):
        p = np.random.RandomState(seed).randint(0, 64, (20,)).astype(
            np.int32)
        return eng.generate([p], max_new_tokens=6)[0]

    first = serve(7)
    for s in (8, 9, 10):
        serve(s)
    assert eng.pool.evictions > 0
    assert serve(7) == first


@pytest.mark.parametrize("name", ["tiny", "untied"])
def test_fingerprint_same_in_every_weight_mode(name):
    """The prefix-cache root samples the qkv rows before the fold renames
    the leaf: it is the same with int8 weights, and so is the JAX
    engine's."""
    m, tm = _models(name, seed=3)
    kw = dict(max_batch_size=1, max_seq_len=64, page_size=16)
    roots = {TS.DecodeEngine(tm, device="cpu", serve_weights=w, kv_quant=k,
                             **kw)._model_salt
             for w in ("off", "int8") for k in ("off", "int8")}
    assert len(roots) == 1
    assert JS.DecodeEngine(m, serve_weights="int8", **kw)._model_salt == \
        JS.DecodeEngine(m, **kw)._model_salt


def test_kv_byte_occupancy_matches_jax():
    """int8 payload and f32 scales per token: the JAX engine's figure,
    and under 0.3x the f32 pool's."""
    m, tm = _models("head_dim_64", seed=1)
    kw = dict(max_batch_size=2, max_seq_len=64, page_size=16)
    got = TS.DecodeEngine(tm, device="cpu", kv_quant="int8",
                          **kw)._kv_byte_occupancy()
    want = JS.DecodeEngine(m, kv_quant="int8", **kw)._kv_byte_occupancy()
    assert got["bytes_per_token"] == want["bytes_per_token"]
    assert got["dtype"] == "int8"
    f32 = TS.DecodeEngine(tm, device="cpu", **kw)._kv_byte_occupancy()
    assert got["bytes_per_token"] < 0.3 * f32["bytes_per_token"]


@pytest.mark.parametrize("mixed", [False, True])
def test_quant_steps_pack_the_refold_count(mixed):
    """With scales, a step returns [B+1]: the tokens, then the refold
    count of its writes (one fetch brings both)."""
    tm = TGPT.random(TGPTConfig(**CONFIGS["tiny"]), seed=4, device="cpu")
    params = tm.params()
    pages = [torch.zeros(2, 4, 6, 16, 8, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.zeros(2, 4, 6) for _ in range(2)]
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    kw = dict(num_heads=4, head_dim=8, eps=1e-5,
              sampling=dict(sampler="greedy"), k_scales=scales[0],
              v_scales=scales[1])
    if mixed:
        out = TS._gpt_mixed_step(
            params, *pages, bt, torch.tensor([0, 0], dtype=torch.int32),
            torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
            torch.tensor([3, 2], dtype=torch.int32),
            torch.tensor([2, 1], dtype=torch.int32),
            torch.tensor([True, True]), None, **kw)
    else:
        out = TS._gpt_decode_step(
            params, *pages, bt, torch.tensor([3, 5], dtype=torch.int32),
            torch.tensor([7, 9], dtype=torch.int32),
            torch.tensor([True, True]), None, **kw)
    assert out.shape == (3,) and out.dtype == torch.int32
    assert int(out[-1]) == 0  # fresh pages only: nothing to refold
    assert all(float(s.sum()) > 0 for s in scales)
    assert all(int(p.abs().sum()) > 0 for p in pages)


# ---------------------------------------------------------------------------
# kernel K2 on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_k2_matches_reference(cuda_device, dtype, tol):
    """K2 on the card against the plain version (K1's tolerances: both
    attend over bit-identical dequantized operands): head_dim 64 and
    128, GQA, multi-query with offsets, a zero-length slot, pages of 4 to
    64 positions (a tile then spans several pages), both paths, one split
    and several; two launches bitwise equal."""
    for seed, (d, hq, hkv, qn, page, pages_max, lens) in enumerate([
            (64, 12, 12, 1, 16, 8, (37, 0, 128)),
            (64, 12, 12, 7, 16, 8, (37, 0, 128)),
            (128, 32, 8, 1, 16, 8, (37, 0, 128)),
            (128, 8, 2, 9, 16, 8, (37, 0, 128)),
            (64, 12, 12, 5, 4, 32, (37, 0, 128)),
            (64, 12, 12, 1, 16, 5, (37, 0, 120)),
            # both paths at the threshold (Q * group 15 and 16), pages of
            # 32 and 64, one split and several, seq_lens at and past the
            # block table's reach
            (64, 12, 12, 15, 32, 8, (200, 0, 256)),
            (64, 12, 12, 16, 32, 8, (200, 0, 300)),
            (128, 15, 1, 1, 64, 4, (100, 0, 256)),
            (128, 16, 1, 1, 64, 4, (100, 0, 300)),
            (64, 12, 12, 64, 64, 16, (700, 0, 1024)),
            (64, 12, 12, 16, 16, 4, (60, 0, 64))]):
        arrays = _quant_inputs(seed, b=3, hq=hq, hkv=hkv, d=d, page=page,
                               pages_max=pages_max, lens=lens, qn=qn)
        q, kp, vp, bt, lens_t, ks, vs = [
            torch.from_numpy(a).to(cuda_device) for a in arrays]
        q = q.to(dtype)
        offs = lens_t - qn
        before = TPA.paged_attention_cuda_q.launches
        out = TPA.paged_attention(q, kp, vp, bt, lens_t, q_offsets=offs,
                                  k_scales=ks, v_scales=vs)
        again = TPA.paged_attention(q, kp, vp, bt, lens_t, q_offsets=offs,
                                    k_scales=ks, v_scales=vs)
        ref = TPA.paged_attention_reference(q, kp, vp, bt, lens_t,
                                            q_offsets=offs, k_scales=ks,
                                            v_scales=vs)
        torch.cuda.synchronize()
        assert TPA.paged_attention_cuda_q.launches == before + 2
        err = float((out.float() - ref.float()).abs().max())
        assert err <= tol, (seed, err)
        assert torch.equal(out, again), seed
        assert float(out[1].abs().max()) == 0.0
