"""paddle_tpu_torch's unified ragged step against the JAX package's.

The scenarios of tests/test_ragged_step.py: decode only, chunked mixed
prefill+decode, speculative verify, int8 KV pages with and without
speculation, the flag and the argument, the grid's default width, and
generated pages entering the prefix cache.  In each, three engines serve
the same prompts from the same weights — the JAX ragged engine, the
port's ragged engine and the port's split engine (``ragged_step=False``)
— and their greedy tokens must be equal, the counters the two ragged
engines share equal, and every pool drained.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# tests/test_ragged_step.py's TINY
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128, use_parallel_layers=False, dropout=0.0)
STAT_KEYS = ("steps", "tokens", "mixed_steps", "prefill_chunks",
             "prefix_hits", "prefix_misses", "prefix_cached_tokens",
             "spec_steps", "spec_slot_steps", "spec_proposed",
             "spec_accepted", "spec_emitted")


def _models(seed):
    """A random JAX GPT and the port's GPT over the same weights."""
    paddle.seed(seed)
    m = GPT(GPTConfig(**TINY))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    return m, TGPT.from_params(TGPTConfig(**TINY),
                               params_from_numpy(tree, device="cpu"))


def _prompts(seed, lens):
    return [np.random.RandomState(seed).randint(0, 64, (n,)).astype(
        np.int32) for n in lens]


def _kw(kw):
    out = dict(max_batch_size=2, max_seq_len=64, page_size=16)
    out.update(kw)
    return out


def _serve_three(seed, prompts, max_new, **kw):
    """Greedy tokens of the JAX ragged engine, the port's ragged engine
    and the port's split engine over ``kw``; the JAX engine's counters and
    the port ragged engine's.  Every pool drains."""
    m, tm = _models(seed)
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, ragged_step=True, **_kw(kw))
    jt = [[int(t) for t in o] for o in je.generate(prompts, max_new)]
    jst = JS.decode_stats()
    te = TS.DecodeEngine(tm, device="cpu", ragged_step=True, **_kw(kw))
    tt = te.generate(prompts, max_new)
    split = TS.DecodeEngine(tm, device="cpu", ragged_step=False, **_kw(kw))
    st = split.generate(prompts, max_new)
    for eng in (je, te, split):
        assert eng.pool.available_count == eng.pool.num_pages
        assert eng.pool.reserved == 0 and not eng._active.any()
    te.pool.assert_consistent(live_pages=[])
    return jt, tt, st, jst, te.decode_stats()


def _assert_counters(jst, tst, keys=STAT_KEYS):
    assert {k: int(tst[k]) for k in keys} == {k: int(jst[k]) for k in keys}


# ---------------------------------------------------------------------------
# greedy parity, scenario by scenario
# ---------------------------------------------------------------------------
def test_decode_only_parity():
    """Staggered continuous batching through the ragged step alone: every
    step, the chunkless ones too, is a ragged step (no decode step)."""
    jt, tt, st, jst, tst = _serve_three(5, _prompts(3, (5, 9, 13)), 10)
    assert tt == jt == st
    _assert_counters(jst, tst)
    assert tst["ragged_steps"] == tst["steps"] == tst["mixed_steps"]
    assert all(len(o) == 10 for o in tt)


def test_chunked_mixed_parity():
    """Prompt chunks of at most ``prefill_q_max=8`` rows ride the ragged
    step beside decode rows."""
    jt, tt, st, jst, tst = _serve_three(6, _prompts(4, (5, 19, 11)), 8,
                                        prefill_q_max=8)
    assert tt == jt == st
    _assert_counters(jst, tst)
    assert tst["prefill_chunks"] > 3  # the 19- and 11-token prompts split


def test_spec_verify_parity():
    """Speculative rounds verify through the ragged step: the verify
    window is a row span of the grid."""
    jt, tt, st, jst, tst = _serve_three(7, _prompts(5, (5, 9, 13)), 10,
                                        spec_decode_k=3)
    assert tt == jt == st
    _assert_counters(jst, tst)
    assert tst["spec_steps"] > 0
    assert tst["ragged_steps"] == tst["spec_steps"] + tst["mixed_steps"]


def test_int8_parity():
    jt, tt, st, jst, tst = _serve_three(8, _prompts(6, (6, 11)), 8,
                                        kv_quant="int8")
    assert tt == jt == st
    _assert_counters(jst, tst, STAT_KEYS + ("kv_quant_pages",
                                            "kv_quant_refolds"))


def test_int8_spec_parity():
    jt, tt, st, jst, tst = _serve_three(9, _prompts(7, (5, 9)), 8,
                                        kv_quant="int8", spec_decode_k=3)
    assert tt == jt == st
    _assert_counters(jst, tst, STAT_KEYS + ("kv_quant_pages",))


def test_flag_enables_ragged_and_arg_wins():
    _, tm = _models(10)
    p = _prompts(8, (6,))[0]
    ref = TS.DecodeEngine(tm, device="cpu", **_kw({})).generate([p], 6)[0]
    TF.set_flags({"FLAGS_ragged_step": True})
    try:
        eng = TS.DecodeEngine(tm, device="cpu", **_kw({}))
        assert eng._ragged
        assert eng.generate([p], 6)[0] == ref
        assert eng.decode_stats()["ragged_steps"] == \
            eng.decode_stats()["steps"]
        assert not TS.DecodeEngine(tm, device="cpu", ragged_step=False,
                                   **_kw({}))._ragged
    finally:
        TF.set_flags({"FLAGS_ragged_step": False})


def test_grid_defaults_to_page_span():
    """An unpinned ``prefill_q_max`` becomes one page of span, never below
    the verify window; an explicit one wins; the split engine keeps the
    chunk budget — as the JAX engine decides for the same arguments."""
    m, tm = _models(12)
    cases = [dict(ragged_step=True, spec_decode_k=3),
             dict(ragged_step=True, spec_decode_k=3, prefill_q_max=48),
             dict(ragged_step=True, spec_decode_k=3, prefill_q_max=2),
             dict(ragged_step=True, page_size=4, spec_decode_k=6),
             dict(spec_decode_k=3)]
    want = [(16, 16), (48, 48), (2, 4), (7, 7), (64, 4)]
    for kw, (q_max, q_r) in zip(cases, want):
        te = TS.DecodeEngine(tm, device="cpu", **_kw(kw))
        je = JS.DecodeEngine(m, **_kw(kw))
        assert (te._q_max, te._q_ragged) == (je._q_max, je._q_ragged)
        assert te._q_max == q_max
        if te._ragged:
            assert te._q_ragged == q_r


@pytest.mark.parametrize("kw", [dict(ragged_step=True),
                                dict(ragged_step=True, spec_decode_k=3),
                                dict(spec_decode_k=3)],
                         ids=["ragged", "ragged_spec", "spec"])
def test_nonfinite_rows_finish_as_fault(kw):
    """A NaN position-embedding row at position 6 poisons the 5-token
    request's decode row there (the ragged step's NaN sentinel reaches
    the host's span-end pick, or a verify window) and the 9-token
    request's prompt: both finish as "fault", with the JAX engine's
    tokens, and the pool drains."""
    m, tm = _models(3)
    with torch.no_grad():
        tm.wpe.weight[6] = float("nan")
    wpe = np.asarray(m.wpe.weight.numpy()).copy()
    wpe[6] = np.nan
    m.wpe.weight.set_value(wpe)
    prompts = _prompts(4, (5, 9))
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **_kw(kw))
    jt, jr = je.generate(prompts, 6, return_meta=True)
    te = TS.DecodeEngine(tm, device="cpu", **_kw(kw))
    tt, tr = te.generate(prompts, 6, return_meta=True)
    assert tr == jr == ["fault", "fault"]
    assert tt == [[int(t) for t in o] for o in jt]
    # the first token comes from row 4, before the poisoned position
    assert 1 <= len(tt[0]) <= 2 and tt[1] == []
    assert te.pool.available_count == te.pool.num_pages


# ---------------------------------------------------------------------------
# generated pages enter the prefix cache (tests/test_ragged_step.py:370-470)
# ---------------------------------------------------------------------------
def _cache_kw(**kw):
    out = dict(max_batch_size=2, max_seq_len=64, page_size=4,
               prefix_cache=True, cache_generated_pages=True)
    out.update(kw)
    return out


def _live_pages(eng):
    return [p for r in eng._by_slot if r is not None for p in r.pages]


@pytest.mark.parametrize("kw,seed,rs", [(dict(), 31, 12),
                                        (dict(spec_decode_k=3), 33, 14),
                                        (dict(ragged_step=True), 34, 15)],
                         ids=["decode", "spec", "ragged"])
def test_fanout_hits_generated_pages(kw, seed, rs):
    """A prompt extending another request's prompt and output maps the
    generated full pages from the cache, and continues the original
    stream; the JAX engine agrees on tokens and hits."""
    m, tm = _models(seed)
    p = _prompts(rs, (8,))[0]
    eng = TS.DecodeEngine(tm, device="cpu", **_cache_kw(**kw))
    out1 = eng.generate([p], 12)[0]
    eng.pool.assert_consistent(live_pages=[])
    # prompt (2 pages) + out1[:8] (2 generated pages): pages 0-2 hit, the
    # last stays uncached by policy (one prompt token must prefill)
    p2 = np.concatenate([p, np.asarray(out1[:8], np.int32)])
    hits0 = eng.decode_stats()["prefix_hits"]
    out2 = eng.generate([p2], 4)[0]
    st = eng.decode_stats()
    assert st["prefix_hits"] - hits0 == 3
    assert out2 == out1[8:12]
    eng.pool.assert_consistent(live_pages=[])
    JS.reset_decode_stats()
    je = JS.DecodeEngine(m, **_cache_kw(**kw))
    assert [int(t) for t in je.generate([p], 12)[0]] == out1
    assert [int(t) for t in je.generate([p2], 4)[0]] == out2
    assert int(JS.decode_stats()["prefix_hits"]) == st["prefix_hits"]


@pytest.mark.parametrize("kw", [dict(), dict(ragged_step=True),
                                dict(spec_decode_k=3, ragged_step=True)],
                         ids=["decode", "ragged", "ragged_spec"])
def test_refcounts_consistent_across_boundaries(kw):
    """The pool's partition and refcounts hold after every step, with a
    live request holding pages across page boundaries."""
    _, tm = _models(32)
    p = _prompts(13, (6,))[0]
    eng = TS.DecodeEngine(tm, device="cpu",
                          **_cache_kw(max_batch_size=1, **kw))
    req = eng.add_request(p, max_new_tokens=14)
    while req.state != "done":
        eng.step()
        eng.pool.assert_consistent(live_pages=_live_pages(eng))
    assert len(req.output_ids) == 14
    eng.pool.assert_consistent(live_pages=[])
    ref = TS.DecodeEngine(tm, device="cpu", **_cache_kw(max_batch_size=1))
    assert ref.generate([p], 14)[0] == req.output_ids


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_ragged_engine_matches_cpu(cuda_device):
    """The ragged engine on the card (K1 at the [slots, Q_r] grid) against
    the CPU's split engine, same weights (head_dim 64): equal greedy
    tokens, and K1 launched once a layer a step, every step ragged."""
    from paddle_tpu_torch.ops import paged_attention as TPA

    cfg = TGPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                     num_heads=2, max_seq_len=128)
    prompts = [p.tolist() for p in _prompts(3, (5, 40, 13, 70))]
    kw = dict(max_batch_size=2, max_seq_len=128, page_size=16)
    cpu = TS.DecodeEngine(TGPT.random(cfg, seed=3, device="cpu"),
                          device="cpu", **kw).generate(prompts, 10)
    eng = TS.DecodeEngine(TGPT.random(cfg, seed=3, device=cuda_device),
                          ragged_step=True, **kw)
    before = TPA.paged_attention_cuda.launches
    assert eng.generate(prompts, 10) == cpu
    st = eng.decode_stats()
    assert st["ragged_steps"] == st["steps"]
    assert TPA.paged_attention_cuda.launches - before == 2 * st["steps"]
    assert eng.pool.available_count == eng.pool.num_pages
