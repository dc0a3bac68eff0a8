"""paddle_tpu_torch's step tracker (`_StepGraph`, one CUDA graph per step
signature on the card) against the JAX package's `_JitTracker`.

On the CPU every step runs eagerly, and the tracker only counts: its
``<kind>_compiles`` and ``<kind>_retraces`` must equal the JAX engine's
on the same tiny serves (split, ragged, prompt-lookup speculative, int8
and legacy one-shot prefill).  The fixed-shape KV writes that make a
step capturable (a drop page past the live ones takes the rows JAX
drops) must leave every live page, scale and refold count equal to the
row filter they replaced; payloads and refold counts exactly, scales
exactly (the same f32 operations on the same rows).  A NaN left in a
freed page must do in the port what it does in JAX.  The `cuda` tests
capture and replay the decode and mixed steps on the card: tokens equal
to the eager steps', sampled ones too, and each replay adds its captured
K1 launches to the count.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.ops import paged_attention as TPA
from paddle_tpu_torch.quantization.int8 import Q_MAX

# tests/test_paged_decode.py's TINY
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
COMPILE_KEYS = ("decode_compiles", "mixed_compiles", "ragged_compiles",
                "verify_compiles", "draft_compiles", "prefill_compiles",
                "kv_quant_compiles")
RETRACE_KEYS = tuple(k.replace("_compiles", "_retraces")
                     for k in COMPILE_KEYS) + ("retraces_after_warmup",)
SERVES = {
    "split": {},
    "ragged": dict(ragged_step=True),
    "spec": dict(spec_decode_k=3),
    "int8": dict(kv_quant="int8"),
    "legacy": dict(chunked_prefill=False),
}


def _models(seed, cfg=TINY):
    """A random JAX GPT and the port's GPT over the same weights."""
    paddle.seed(seed)
    m = GPT(GPTConfig(**cfg))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    return m, TGPT.from_params(TGPTConfig(**cfg),
                               params_from_numpy(tree, device="cpu"))


def _prompts(seed, lens, vocab=64):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


_KW = dict(max_batch_size=2, max_seq_len=64, page_size=16,
           prefill_chunk_tokens=8)


def _counts(st):
    return {k: int(st[k]) for k in COMPILE_KEYS + RETRACE_KEYS}


# ---------------------------------------------------------------------------
# the counters against the JAX engine's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("serve", sorted(SERVES))
def test_compile_counters_match_jax(serve):
    """Four ragged prompts through two slots (one spans several pow-2
    prefill buckets on the legacy path): the same greedy tokens, and
    every compile and retrace counter of the port's process-wide
    `decode_stats` equal to the JAX engine's; none retraces."""
    m, tm = _models(5)
    prompts = _prompts(3, (5, 9, 13, 40))
    kw = dict(_KW, **SERVES[serve])
    JS.reset_decode_stats()
    jt = JS.DecodeEngine(m, cost_model=False, **kw).generate(prompts, 10)
    jst = JS.decode_stats()
    TS.reset_decode_stats()
    tt = TS.DecodeEngine(tm, device="cpu", **kw).generate(prompts, 10)
    tst = TS.decode_stats()
    assert tt == [[int(t) for t in o] for o in jt]
    assert _counts(tst) == _counts(jst)
    assert all(tst[k] == 0 for k in RETRACE_KEYS)
    assert sum(tst[k] for k in COMPILE_KEYS) >= 1


@pytest.mark.parametrize("key", COMPILE_KEYS)
def test_forced_signature_change_counts_one_retrace(key):
    """A tracker called at one signature, then at another (twice each):
    one compile and one retrace of its kind, as JAX's `_JitTracker`
    counts them for the same calls."""
    calls = [np.zeros(3, np.int32), np.ones(3, np.int32),
             np.zeros(4, np.int32), np.ones(4, np.int32)]
    JS.reset_decode_stats()
    jfn = JS._JitTracker(lambda x: x + 1, key)
    jout = [np.asarray(jfn(jnp.asarray(a))) for a in calls]
    TS.reset_decode_stats()
    tfn = TS._StepGraph(lambda x: x + 1, key, torch.device("cpu"),
                        TS._GraphMemory())
    tout = [tfn(a).numpy() for a in calls]
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)
    want = _counts(JS.decode_stats())
    assert _counts(TS.decode_stats()) == want
    assert want[key] == 1 and want["retraces_after_warmup"] == 1
    assert tfn.captures == 0  # the CPU captures nothing


def test_disable_capture_changes_no_token():
    """`disable_capture` (nested, and left again) serves the same tokens
    and counts the same compiles; on the CPU no graph is ever taken."""
    _, tm = _models(2)
    prompts = _prompts(4, (7, 20, 3))
    TS.reset_decode_stats()
    eng = TS.DecodeEngine(tm, device="cpu", **_KW)
    base = eng.generate(prompts, 8)
    want = _counts(TS.decode_stats(reset=True))
    with TS.disable_capture():
        with TS.disable_capture():
            eng = TS.DecodeEngine(tm, device="cpu", **_KW)
            assert eng.generate(prompts, 8) == base
        assert TS._CAPTURE_OFF[0] == 1
    assert TS._CAPTURE_OFF[0] == 0
    assert _counts(TS.decode_stats()) == want
    assert eng.graph_captures() == 0


# ---------------------------------------------------------------------------
# the fixed-shape writes against the row filter they replaced
# ---------------------------------------------------------------------------
def _filtered(page_idx, slot, npages, spans=None):
    """The earlier write coordinates: only the rows (and span pages) a
    JAX scatter would not drop, found with `nonzero`."""
    page_idx = page_idx.reshape(-1)
    rows = torch.nonzero(page_idx < npages).squeeze(1)
    out = (rows, page_idx[rows], slot.reshape(-1)[rows])
    if spans is not None:
        spans = spans.reshape(-1)
        out += (spans[spans < npages],)
    return out


def _filtered_write(pages, rows, vals):
    pages[:, rows[1], rows[2]] = vals[rows[0]].transpose(0, 1)


def _filtered_quant_write(pages, scales, rows, vals):
    """The quantized write over filtered rows, as it was."""
    _, page_idx, slot = rows[:3]
    spans = rows[3] if len(rows) > 3 else page_idx
    h = pages.shape[0]
    v = vals[rows[0]].float()
    s_old = scales.clone()
    scales.scatter_reduce_(1, page_idx[None].expand(h, -1),
                           v.abs().amax(dim=-1).T / Q_MAX, "amax")
    so_g, sn_g = s_old[:, spans], scales[:, spans]
    ratio = torch.where(so_g > 0,
                        so_g / torch.where(sn_g > 0, sn_g, 1.0), 0.0)
    old = pages[:, spans].float()
    pages[:, spans] = torch.round(old * ratio[..., None, None]).to(
        torch.int8)
    sn_rows = scales[:, page_idx].T[..., None]
    q = torch.clamp(torch.round(v / torch.clamp(sn_rows, min=1e-30)),
                    -Q_MAX, Q_MAX).to(torch.int8)
    pages[:, page_idx, slot] = q.transpose(0, 1)
    return int(((scales > s_old) & (s_old > 0)).sum())


def _coords(kind, rng, b=4, pages_max=5, page=8, qn=6):
    """Write coordinates with dropped rows: ``multi`` — up to ``qn`` rows a
    sequence (one slot inactive, one capped mid-page, one running past the
    block table's horizon); ``single`` — one row a sequence, the decode
    write, two slots inactive.  Returns ``(page_idx, slot, spans, npages,
    rows a write)``."""
    npages = b * pages_max + 2
    bt = torch.from_numpy(rng.permutation(npages)[:b * pages_max].reshape(
        b, pages_max).astype(np.int32))
    if kind == "multi":
        lens = torch.tensor([3, 0, 13, pages_max * page - 2],
                            dtype=torch.int32)
        caps = torch.tensor([qn, 0, 2, qn], dtype=torch.int32)
        p, s = TPA.paged_write_indices(bt, lens, caps, qn, npages, page)
        spans = TPA.paged_write_spans(bt, lens, caps, qn, npages, page)
        return p, s, spans, npages, b * qn
    pos = torch.tensor([5, 17, 30, 38], dtype=torch.int64)
    active = torch.tensor([True, False, True, False])
    p = torch.where(active, bt.long()[torch.arange(b), pos // page], npages)
    return p, pos % page, None, npages, b


@pytest.mark.parametrize("kind", ["multi", "single"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_fixed_shape_writes_match_the_row_filter(kv, kind):
    """Three writes at growing magnitudes into pages that start as
    garbage, some page scales established: the fixed-shape write (drop
    page included) and the row filter leave every live page, scale and
    refold count equal, and the write keeps one shape whatever is
    dropped."""
    rng = np.random.RandomState(11)
    h, page, d = 3, 8, 4
    p, s, spans, npages, nrows = _coords(kind, rng, page=page)
    rows = TPA.paged_write_rows(p, s, spans if kv == "int8" else None)
    assert all(r.shape == (nrows,) for r in rows[:2])
    old = _filtered(p, s, npages, spans if kv == "int8" else None)
    assert len(old[0]) < nrows  # the case drops rows
    if kv == "int8":
        start = rng.randint(-127, 128, (h, npages, page, d)).astype(np.int8)
        scales = np.zeros((h, npages), np.float32)
        scales[:, ::2] = rng.rand(h, (npages + 1) // 2)
    else:
        start = rng.randn(h, npages, page, d).astype(np.float32)
    ref = torch.from_numpy(start.copy())
    got = torch.zeros((h, npages + 1, page, d), dtype=ref.dtype)
    got[:, :npages] = ref
    if kv == "int8":
        ref_s = torch.from_numpy(scales.copy())
        got_s = torch.zeros(h, npages + 1)
        got_s[:, :npages] = ref_s
    for mag in (1.0, 3.0, 0.5):
        vals = torch.from_numpy((rng.randn(nrows, h, d) * mag).astype(
            np.float32))
        if kv == "int8":
            n_ref = _filtered_quant_write(ref, ref_s, old, vals)
            n_got = TPA.paged_quant_write(got, got_s, rows, vals)
            assert int(n_got) == n_ref
            assert torch.equal(got_s[:, :npages], ref_s)
        else:
            _filtered_write(ref, old, vals)
            TPA.paged_write(got, rows, vals)
        assert torch.equal(got[:, :npages], ref)
    if kv == "int8":
        assert n_ref >= 0


# ---------------------------------------------------------------------------
# a NaN left in a freed page
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["chunked", "legacy", "int8"])
def test_nan_in_freed_page_matches_jax(mode):
    """One request serves and frees its pages (the prompt's stay cached,
    unreferenced); every page is then
    poisoned with NaN (its K/V payload, or with int8 pages its scales)
    in both engines, and two more requests reuse them.  Whatever both
    packages do with the stale NaN (every version of paged attention
    multiplies masked probabilities by the page's stale rows, and by the
    pages a block table's unused entries point at), the port does too:
    the same tokens, finish reasons and finish counters."""
    m, tm = _models(7)
    kw = dict(_KW, max_batch_size=1)
    if mode == "legacy":
        kw["chunked_prefill"] = False
    if mode == "int8":
        kw["kv_quant"] = "int8"
    first = _prompts(1, (20,))
    later = _prompts(2, (5, 11))
    JS.reset_decode_stats()
    TS.reset_decode_stats()
    je = JS.DecodeEngine(m, **kw)
    te = TS.DecodeEngine(tm, device="cpu", **kw)
    assert te.generate(first, 6) == [[int(t) for t in o]
                                     for o in je.generate(first, 6)]
    assert je.pool.available_count == te.pool.available_count == \
        te.pool.num_pages
    if mode == "int8":
        je._k_scales = je._k_scales.at[:].set(jnp.nan)
        je._v_scales = je._v_scales.at[:].set(jnp.nan)
        te._k_scales[:] = float("nan")
        te._v_scales[:] = float("nan")
    else:
        je._k_pages = je._k_pages.at[:].set(jnp.nan)
        je._v_pages = je._v_pages.at[:].set(jnp.nan)
        te._k_pages[:] = float("nan")
        te._v_pages[:] = float("nan")
    jt, jr = je.generate(later, 6, return_meta=True)
    tt, tr = te.generate(later, 6, return_meta=True)
    assert tt == [[int(t) for t in o] for o in jt]
    assert tr == jr
    keys = ("finished_eos", "finished_length", "finished_fault", "prefills",
            "tokens")
    jst, tst = JS.decode_stats(), TS.decode_stats()
    assert {k: int(tst[k]) for k in keys} == {k: int(jst[k]) for k in keys}
    # the NaN reaches a later request in every mode, int8 too: a handed-
    # out page's scales are reset, but a block table's unused entries
    # point at page 0, whose NaN scale the masked multiply still reads
    assert "fault" in tr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    return torch.device("cuda")


def _card_serve(cfg, prompts, capture, **kw):
    """Serve ``prompts`` step by step on a fresh card engine (captured, or
    eager under `disable_capture`); returns the tokens, the K1 launches
    of each step and the engine."""
    eng = TS.DecodeEngine(TGPT.random(cfg, seed=3, device="cuda"),
                          max_batch_size=2, max_seq_len=128, page_size=16,
                          **kw)
    reqs = [eng.add_request(p, 10) for p in prompts]
    per_step = []
    with contextlib.nullcontext() if capture else TS.disable_capture():
        while eng._queue or eng._active.any():
            n0 = TPA.paged_attention_cuda.launches
            eng.step()
            per_step.append(TPA.paged_attention_cuda.launches - n0)
    torch.cuda.synchronize()
    return [r.output_ids for r in reqs], per_step, eng


_CARD_CFG = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
                 max_seq_len=128)


@pytest.mark.cuda
def test_cuda_captured_decode_and_mixed_steps_replay(cuda_device):
    """The split engine on the card (head_dim 64): one graph for the
    mixed step and one for the decode step, each captured at its first
    step and replayed after; greedy tokens equal to the eager engine's;
    every step, captured or replayed, adds num_layers K1 launches, the
    eager serve's count; nothing retraces."""
    cfg = TGPTConfig(**_CARD_CFG)
    prompts = [p.tolist() for p in _prompts(3, (5, 40, 13, 70), 96)]
    eager, eager_steps, _ = _card_serve(cfg, prompts, capture=False)
    TS.reset_decode_stats()
    got, steps, eng = _card_serve(cfg, prompts, capture=True)
    assert got == eager
    assert steps == eager_steps and set(steps) == {cfg.num_layers}
    assert eng._decode_fn.captures == eng._mixed_fn.captures == 1
    assert eng.graph_captures() == 2
    st = TS.decode_stats()
    assert (st["decode_compiles"], st["mixed_compiles"]) == (1, 1)
    assert all(st[k] == 0 for k in RETRACE_KEYS)
    assert TPA.paged_attention_cuda.captured >= 2 * cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [dict(sampler="top_k", top_k=8, seed=5),
                                   dict(sampler="top_p", top_p=0.9, seed=6),
                                   dict(kv_quant="int8"),
                                   dict(chunked_prefill=False)],
                         ids=["top_k", "top_p", "int8", "legacy"])
def test_cuda_captured_serve_equals_eager(cuda_device, extra):
    """Sampled tokens (the engine's generator registered with each graph,
    so a replay advances it as the eager step does), int8 pages (K2, the
    scale reset and the quantized write captured) and the legacy
    one-shot prefill (one graph a bucket): the captured serve's tokens
    equal the eager serve's on the same seed."""
    cfg = TGPTConfig(**_CARD_CFG)
    prompts = [p.tolist() for p in _prompts(4, (9, 33, 17), 96)]
    eager, _, _ = _card_serve(cfg, prompts, capture=False, **extra)
    got, _, eng = _card_serve(cfg, prompts, capture=True, **extra)
    assert got == eager
    assert eng.graph_captures() >= 2
