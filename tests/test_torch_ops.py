"""paddle_tpu_torch ops and serving building blocks against the JAX package.

LayerNorm (`_fwd_xla`, the serving path's form), the ragged causal mask,
token sampling, the serving flags, the typed errors, the chain hash and
the KV page pool.  Inputs are made with numpy from a seed and handed to
both packages.  Greedy sampling is compared exactly; the samplers that
draw cannot reproduce `jax.random` streams, so top_k / top_p draws are
compared in distribution by a chi-square test over many draws.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from paddle_tpu.core import flags as JF
from paddle_tpu.inference import errors as JE
from paddle_tpu.inference import serving as JS
from paddle_tpu.nn.decode import sample_logits as jax_sample_logits
from paddle_tpu.nn.functional.attention import \
    multi_query_causal_mask as jax_mask
from paddle_tpu.ops.pallas.layer_norm import _fwd_xla
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import errors as TE
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.nn.decode import sample_logits
from paddle_tpu_torch.nn.functional.attention import multi_query_causal_mask
from paddle_tpu_torch.ops.layer_norm import layer_norm


# ---------------------------------------------------------------------------
# LayerNorm and the causal mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,d", [(5, 32), (17, 768), (3, 100)])
def test_layer_norm_matches_fwd_xla(rows, d):
    """f32, atol 1e-6: both take f32 statistics with the population
    variance; only the summation order differs."""
    rng = np.random.RandomState(rows * d)
    x = (rng.randn(rows, d) * 3 + 1).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    want = _fwd_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_layer_norm_uses_population_variance():
    """A row of two values a, b normalizes to exactly -1, +1 only with
    the population variance (n, not n - 1)."""
    x = torch.tensor([[1.0, 3.0]])
    y = layer_norm(x, torch.ones(2), torch.zeros(2), 0.0)
    np.testing.assert_allclose(y.numpy(), [[-1.0, 1.0]], atol=1e-6)


def test_layer_norm_keeps_bf16():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    y = layer_norm(x.bfloat16(), torch.ones(64), torch.zeros(64), 1e-5)
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("q_len,kv_len", [(1, 16), (5, 40), (8, 8)])
def test_multi_query_causal_mask_matches_jax(q_len, kv_len):
    rng = np.random.RandomState(q_len + kv_len)
    b = 6
    lens = rng.randint(0, kv_len + 1, b).astype(np.int32)
    lens[1] = 0  # a fully masked slot
    offs = np.maximum(lens - rng.randint(0, q_len + 1, b), 0).astype(
        np.int32)
    want = jax_mask(jnp.asarray(offs), q_len, jnp.asarray(lens), kv_len)
    got = multi_query_causal_mask(torch.from_numpy(offs), q_len,
                                  torch.from_numpy(lens), kv_len)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_greedy_matches_jax_exactly():
    rng = np.random.RandomState(0)
    logits = rng.randn(9, 50).astype(np.float32)
    logits[3, [7, 21]] = 10.0  # a tie: both pick the first index
    want = np.asarray(jax_sample_logits(jnp.asarray(logits)))
    got = sample_logits(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[3]) == 7


@pytest.mark.parametrize("sampler", ["top_k", "top_p"])
@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_nonpositive_temperature_is_greedy(sampler, temperature):
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 30).astype(np.float32)
    kw = dict(sampler=sampler, temperature=temperature, top_k=5, top_p=0.9)
    want = np.asarray(jax_sample_logits(jnp.asarray(logits), **kw,
                                        key=jax.random.PRNGKey(0)))
    got = sample_logits(torch.from_numpy(logits), generator=_gen(), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_tiny_top_p_keeps_rank_zero():
    """A nucleus too small for any token still keeps the argmax."""
    rng = np.random.RandomState(2)
    logits = rng.randn(64, 12).astype(np.float32)
    kw = dict(sampler="top_p", top_p=1e-9)
    want = np.asarray(jax_sample_logits(jnp.asarray(logits), **kw,
                                        key=jax.random.PRNGKey(3)))
    got = sample_logits(torch.from_numpy(logits), generator=_gen(3), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_top_k_argument_checks_match_jax():
    logits = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="top_k >= 1"):
        sample_logits(logits, sampler="top_k", top_k=0, generator=_gen())
    with pytest.raises(ValueError, match="top_k >= 1"):
        jax_sample_logits(jnp.zeros((2, 8)), sampler="top_k", top_k=0,
                          key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_logits(logits, sampler="beam", generator=_gen())
    with pytest.raises(ValueError, match="Generator"):
        sample_logits(logits, sampler="top_p")


# the two packages' draws, many rows of one logits vector each: the
# counts per token must come from one distribution (chi-square test of
# homogeneity) and both must put no mass outside the filter
_DRAWS = 20000
_LOGITS = np.array([2.0, 1.5, 1.2, 0.3, 0.0, -0.5, -1.0, -3.0], np.float32)


@pytest.mark.parametrize("kw,support", [
    (dict(sampler="top_k", top_k=3, temperature=0.7), {0, 1, 2}),
    (dict(sampler="top_k", top_k=1000), set(range(8))),  # clamped to V
    (dict(sampler="top_p", top_p=0.8), {0, 1, 2, 3}),
    (dict(sampler="top_p", top_p=0.6, temperature=1.5), {0, 1, 2}),
], ids=["top_k", "top_k_over_vocab", "top_p", "top_p_hot"])
def test_sampler_marginals_match_jax(kw, support):
    tiled = np.tile(_LOGITS, (_DRAWS, 1))
    jt = np.asarray(jax_sample_logits(jnp.asarray(tiled), **kw,
                                      key=jax.random.PRNGKey(11)))
    tt = sample_logits(torch.from_numpy(tiled), generator=_gen(11),
                       **kw).numpy()
    v = len(_LOGITS)
    jc = np.bincount(jt, minlength=v)
    tc = np.bincount(tt, minlength=v)
    assert set(np.nonzero(jc)[0]) <= support
    assert set(np.nonzero(tc)[0]) == set(np.nonzero(jc)[0])
    cols = sorted(set(np.nonzero(jc)[0]))
    if len(cols) > 1:
        _, p, _, _ = stats.chi2_contingency(np.stack([jc[cols], tc[cols]]))
        assert p > 1e-4, (jc, tc)


# ---------------------------------------------------------------------------
# flags and errors
# ---------------------------------------------------------------------------
_FLAG_NAMES = ["chunked_prefill", "prefill_chunk_tokens", "prefix_cache",
               "cache_generated_pages", "kv_quant", "serve_weights",
               "ragged_step", "spec_decode_k", "serve_mesh", "spec_drafter",
               "spec_adaptive_k", "spec_k_min", "spec_k_shrink_streak",
               "spec_k_grow_streak", "sched_policy", "fault_inject",
               "step_retries", "step_backoff_ms", "degrade_after",
               "degraded_probe_steps", "engine_recoveries", "journal_dir",
               "journal_fsync", "snapshot_interval_steps", "journal_compact",
               "snapshot_kv", "step_timeout_ms", "compile_cache_dir",
               "flight_window", "flight_dir", "sched_cost_admission",
               "fleet_trace", "kv_pool_debug", "sanitize"]
# flags the port keeps at their default only
_LATER_FLAGS = ("compile_cache_dir",)


@pytest.mark.parametrize("name", _FLAG_NAMES)
def test_flag_defaults_match_jax(name):
    assert TF.flag(name) == JF.flag(name)
    assert TF.get_flags(f"FLAGS_{name}") == {f"FLAGS_{name}": JF.flag(name)}


@pytest.mark.parametrize("name,value", [
    ("kv_quant", "int8"), ("serve_weights", "int8"), ("ragged_step", True),
    ("spec_decode_k", 4), ("chunked_prefill", False), ("serve_mesh", "mp=2"),
    ("compile_cache_dir", "/tmp/cache"), ("flight_window", 0),
    ("flight_dir", "/tmp/flight"), ("sched_cost_admission", True),
    ("kv_pool_debug", True), ("sanitize", True)])
def test_unported_flags_raise(name, value):
    """compile_cache_dir (a CUDA graph cannot be serialized) refuses a
    non-default, naming the reason.  kv_quant and serve_weights
    (quantized serving), ragged_step (the unified ragged step),
    spec_decode_k (speculative decoding), chunked_prefill=False (the
    legacy one-shot prefill), serve_mesh (tensor-parallel serving) and
    the telemetry plane's flight_window, flight_dir and
    sched_cost_admission, and the debug modes kv_pool_debug and sanitize
    are ported: the value is set, and an engine that takes it from the
    flag alone serves with it."""
    if name not in _LATER_FLAGS:
        from paddle_tpu_torch.models.gpt import GPT, GPTConfig
        tm = GPT.random(GPTConfig(vocab_size=64, hidden_size=32,
                                  num_layers=2, num_heads=4,
                                  max_seq_len=64), seed=0, device="cpu")
        TF.set_flags({name: value})
        try:
            assert TF.flag(name) == value
            eng = TS.DecodeEngine(tm, device="cpu", max_batch_size=1,
                                  max_seq_len=32, page_size=16)
            out = eng.generate([[1, 2, 3, 4, 5]], 4)
        finally:
            TF.set_flags({name: JF.flag(name)})
        assert len(out[0]) == 4
        st = eng.decode_stats()
        if name == "kv_quant":
            assert eng._k_pages.dtype == torch.int8
            assert st["kv_quant_pages"] > 0
        elif name == "serve_weights":
            assert st["weight_quant_mats"] == 8
            assert "qkv_w_q" in eng._params["blocks"][0]
        elif name == "ragged_step":
            assert eng._ragged and st["ragged_steps"] == st["steps"] > 0
        elif name == "chunked_prefill":
            # the one-shot prefill takes no prefix cache: the flag's
            # default resolves off, as in JAX
            assert not eng._chunked and not eng._prefix_cache
            assert st["mixed_steps"] == 0 and st["steps"] == 3
        elif name == "flight_window":
            assert eng._flight is None  # 0 turns the recorder off
        elif name == "flight_dir":
            assert eng._flight.flight_dir == value
        elif name == "sched_cost_admission":
            assert eng._cost_admission and eng._cost is not None
        elif name == "kv_pool_debug":
            assert eng._pool_debug
        elif name == "sanitize":
            from paddle_tpu_torch.analysis import sanitizer
            rep = sanitizer.get().report()
            assert rep["steps"] >= st["steps"] > 0
            assert rep["warm_retraces"] == 0
        elif name == "serve_mesh":
            assert eng._mesh_mp == 2 and eng._ragged
            assert st["ragged_steps"] == st["steps"] > 0
        else:
            assert eng._spec.k == value and st["spec_steps"] > 0
        return
    with pytest.raises(NotImplementedError, match="slice"):
        TF.set_flags({name: value})
    assert TF.flag(name) == JF.flag(name)  # nothing was set
    TF.set_flags({name: TF.flag(name)})  # the default is accepted


def test_set_flags_validates_before_mutating():
    before = TF.flag("prefill_chunk_tokens")
    with pytest.raises(KeyError):
        TF.set_flags({"prefill_chunk_tokens": 8, "no_such_flag": 1})
    assert TF.flag("prefill_chunk_tokens") == before
    TF.set_flags({"FLAGS_prefill_chunk_tokens": 8})
    try:
        assert TF.flag("prefill_chunk_tokens") == 8
    finally:
        TF.set_flags({"prefill_chunk_tokens": before})


def test_errors_mirror_jax_hierarchy():
    assert issubclass(TE.PoolExhausted, TE.ServingError)
    assert issubclass(TE.ServingError, RuntimeError)
    assert issubclass(JE.PoolExhausted, JE.ServingError)
    assert TE.PoolExhausted.__name__ == JE.PoolExhausted.__name__


# ---------------------------------------------------------------------------
# chain hash, request and page pool
# ---------------------------------------------------------------------------
def test_chain_hash_matches_jax():
    rng = np.random.RandomState(4)
    prev = b"salt"
    for _ in range(4):
        toks = rng.randint(0, 50304, 16)
        a = TS._chain_hash(prev, toks)
        assert a == JS._chain_hash(prev, toks)
        prev = a


@pytest.mark.parametrize("prompt_len,max_new", [(5, 1), (9, 6), (40, 32)])
def test_request_accounting_matches_jax(prompt_len, max_new):
    ids = np.arange(prompt_len, dtype=np.int32)
    t, j = TS.Request(ids, max_new), JS.Request(ids, max_new)
    assert t.total_kv_tokens() == j.total_kv_tokens()
    assert t.prompt_ids == list(j.prompt_ids)
    assert t.state == j.state == "queued"
    assert t.generated_ids == [] and t.finish_reason is None


def _pool_state(pool):
    return (pool.free_count, pool.cached_count,
            pool.cached_unreferenced_count, pool.available_count,
            pool.evictions, pool.reserved)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_follows_jax_pool(seed):
    """One random sequence of allocations, registrations, refs and
    releases through both pools: every returned page, every counter and
    every raised error must agree, and both stay consistent."""
    rng = np.random.RandomState(seed)
    tp, jp = TS.KVBlockPool(12), JS.KVBlockPool(12)
    held = []       # private or referenced pages we hold, with repeats
    keys = {}       # page -> key of pages we registered
    for step in range(300):
        op = rng.randint(5)
        if op == 0:
            try:
                a = tp.alloc_page()
            except TE.PoolExhausted:
                with pytest.raises(JE.PoolExhausted):
                    jp.alloc_page()
                continue
            assert a == jp.alloc_page()
            held.append(a)
        elif op == 1 and held:
            p = held[rng.randint(len(held))]
            key = bytes([step % 256, seed])
            assert tp.register_page(p, key) == jp.register_page(p, key)
            if tp.lookup(key) == p:
                keys[p] = key
        elif op == 2 and keys:
            p = list(keys)[rng.randint(len(keys))]
            if tp.lookup(keys[p]) != p:
                del keys[p]  # evicted and reused
                continue
            tp.ref_page(p)
            jp.ref_page(p)
            held.append(p)
        elif op in (3, 4) and held:
            p = held.pop(rng.randint(len(held)))
            tp.release_pages([p])
            jp.release_pages([p])
        assert _pool_state(tp) == _pool_state(jp)
        tp.assert_consistent(held)
        jp.assert_consistent(held)
    for p in held:
        tp.release_pages([p])
        jp.release_pages([p])
    assert tp.available_count == tp.num_pages == jp.available_count


def test_pool_guards_match_jax():
    for pool, Exc in ((TS.KVBlockPool(4), TE.PoolExhausted),
                      (JS.KVBlockPool(4), JE.PoolExhausted)):
        p = pool.alloc_page()
        pool.free_pages([p])
        with pytest.raises(ValueError, match="double free"):
            pool.free_pages([p])
        with pytest.raises(ValueError, match="outside pool"):
            pool.free_pages([9])
        q = pool.alloc_page()
        assert pool.register_page(q, b"k")
        with pytest.raises(ValueError, match="cached"):
            pool.free_pages([q])
        with pytest.raises(ValueError, match="free page"):
            pool.register_page(pool._free[-1], b"z")
        others = [pool.alloc_page() for _ in range(3)]
        with pytest.raises(Exc):
            pool.alloc_page()
        pool.release_pages(others + [q])
        assert pool.available_count == 4
