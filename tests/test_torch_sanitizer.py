"""The serving debug modes (``FLAGS_kv_pool_debug``, ``FLAGS_sanitize``)
of the port against the JAX package's on the same CPU serves: the pool
audit at every step boundary, a warm step tracker that meets a new
signature raising `WarmRetraceError`, the host-sync sentinel counting
what JAX's counts, lock-order cycles raising `LockOrderError`, and a
clean sanitized serve recording nothing.  Greedy tokens are compared
exactly.  The port's flag is armed by this file's own fixtures
(``tests/conftest.py``'s ``sanitize`` marker arms only the JAX
package's)."""
import threading

import numpy as np
import pytest

from paddle_tpu.analysis import sanitizer as jsan
from paddle_tpu_torch.analysis import sanitizer as tsan
from paddle_tpu_torch.inference import serving as TS

from torch_reliability_common import Side, both, port

PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [1, 2, 3, 4, 5, 9, 9, 9, 1, 2]]
NEW = 6


@pytest.fixture(autouse=True)
def _reset():
    tsan.reset()
    jsan.reset()
    yield
    tsan.reset()
    jsan.reset()


@pytest.fixture
def sanitize():
    """FLAGS_sanitize on in the port (and off again after)."""
    side = Side("torch")
    with side.flags(sanitize=True):
        tsan.reset()
        yield tsan.get()


def _engine_kw(**kw):
    return dict(max_batch_size=2, max_seq_len=64, page_size=4, **kw)


CONFIGS = {
    "chunked": {},
    "ragged": {"ragged_step": True},
    "legacy": {"chunked_prefill": False, "prefix_cache": False},
    "spec": {"spec_decode_k": 2},
}


# ---------------------------------------------------------------------------
# FLAGS_kv_pool_debug: the pool audit at every step boundary
# ---------------------------------------------------------------------------
def _audited_serve(side, monkeypatch, flag):
    """(tokens, audits, steps) of one serve with ``flag`` on, counting
    the package's `KVBlockPool.assert_consistent` calls."""
    calls = []
    orig = side.S.KVBlockPool.assert_consistent

    def counted(pool, live_pages=None):
        calls.append(live_pages is not None)
        return orig(pool, live_pages)
    monkeypatch.setattr(side.S.KVBlockPool, "assert_consistent", counted)
    with side.flags(**{flag: True}):
        eng = side.engine(**_engine_kw(prefix_cache=True))
        reqs = [eng.add_request(p, NEW) for p in PROMPTS * 2]
        steps = eng.run()
    monkeypatch.setattr(side.S.KVBlockPool, "assert_consistent", orig)
    return [r.generated_ids for r in reqs], calls, steps


@pytest.mark.parametrize("flag", ["kv_pool_debug", "sanitize"])
def test_pool_audit_runs_every_step(monkeypatch, flag):
    (jt, jcalls, jsteps), (tt, tcalls, tsteps) = both(
        lambda s: _audited_serve(s, monkeypatch, flag))
    assert tt == jt
    assert tsteps == jsteps > 0
    # one audit a step, each over the live requests' pages, as in JAX
    assert len(tcalls) == len(jcalls) == tsteps
    assert all(tcalls) and all(jcalls)


def test_pool_debug_off_by_default_and_read_at_construction():
    side = port()
    assert side._flags.flag("kv_pool_debug") is False
    assert not side.engine(**_engine_kw())._pool_debug
    with side.flags(kv_pool_debug=True):
        eng = side.engine(**_engine_kw())
    assert eng._pool_debug


def test_pool_audit_catches_a_corrupted_pool():
    """A refcount broken between steps fails the next step's audit, and
    the ladder does not contain it (AssertionError is non-retryable)."""
    side = port()
    with side.flags(kv_pool_debug=True):
        eng = side.engine(**_engine_kw(prefix_cache=True))
        eng.add_request(PROMPTS[2], NEW)
        for _ in range(4):
            eng.step()
        page = next(p for r in eng._by_slot if r is not None
                    for p in r.pages)
        eng.pool._free.append(page)  # a live page on the free list
        eng.pool._free_set.add(page)
        with pytest.raises(AssertionError):
            eng.step()


# ---------------------------------------------------------------------------
# FLAGS_sanitize: warm retraces raise
# ---------------------------------------------------------------------------
def _tracker():
    mem = TS._GraphMemory()
    return TS._StepGraph(lambda x: x * 2, "decode_compiles",
                         TS.resolve_device("cpu"), mem, site="fixture step")


def test_warm_new_signature_raises(sanitize):
    fn = _tracker()
    fn(np.ones((2,), np.float32))
    fn(np.ones((2,), np.float32))  # warm: the same signature
    with pytest.raises(tsan.WarmRetraceError) as ei:
        fn(np.ones((2,), np.int32))  # a new signature after warm-up
    assert "fixture step" in str(ei.value)
    assert sanitize.report()["warm_retraces"] == 1
    # the raise is the counter's replacement, as in JAX
    assert TS.decode_stats()["retraces_after_warmup"] == 0


def test_new_signature_counts_without_sanitizer():
    TS.reset_decode_stats()
    fn = _tracker()
    fn(np.ones((2,), np.float32))
    fn(np.ones((2,), np.int32))
    stats = TS.decode_stats()
    assert stats["retraces_after_warmup"] == 1
    assert stats["decode_retraces"] == 1
    assert tsan.get().report()["warm_retraces"] == 0


def test_first_signature_never_raises(sanitize):
    fn = _tracker()
    out = fn(np.arange(3, dtype=np.float32))
    assert out.tolist() == [0.0, 2.0, 4.0]
    assert sanitize.report()["warm_retraces"] == 0


def test_sanitizer_error_is_not_contained(sanitize, monkeypatch):
    """`SanitizerError` is in the ladder's NONRETRYABLE set, as in JAX: a
    warm retrace raised inside a step escapes the step as it is, neither
    retried nor quarantined."""
    side = port()
    assert tsan.SanitizerError in side.R.ResilienceManager.NONRETRYABLE
    eng = side.engine(**_engine_kw())
    eng.add_request(PROMPTS[0], NEW)
    eng.step()
    eng.step()
    fn = eng._decode_fn
    assert fn is not None and fn.warm
    orig = TS._StepGraph.__call__

    def grown(self, *host):
        # the decode step's operands grow a dimension mid-serve
        if self is fn:
            host = (*host, np.zeros((1,), np.int32))
        return orig(self, *host)
    monkeypatch.setattr(TS._StepGraph, "__call__", grown)
    with pytest.raises(tsan.WarmRetraceError):
        eng.step()
    assert sanitize.report()["warm_retraces"] == 1


# ---------------------------------------------------------------------------
# FLAGS_sanitize: the host-sync sentinel against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_host_syncs_and_steps_equal_jax(config):
    """The same CPU serve under FLAGS_sanitize in both packages: equal
    tokens, equal step and host-sync counts, no warm retrace.  The
    relation JAX holds is the port's too: one blocking fetch a step
    (``host_syncs == steps``), plus one a prompt for the legacy one-shot
    prefill at admission; a speculative serve fetches twice in some
    rounds (12/12, 13/13, 10/13 and 4/6 steps/syncs here in both)."""
    kw = _engine_kw(**CONFIGS[config])

    def serve(side):
        san = jsan if side.jax else tsan
        with side.flags(sanitize=True):
            san.reset()
            eng = side.engine(**kw)
            outs = eng.generate(PROMPTS, NEW)
        return outs, san.get().report()

    (jo, jr), (to, tr) = both(serve)
    assert to == jo
    assert (tr["steps"], tr["host_syncs"]) == (jr["steps"],
                                                jr["host_syncs"])
    assert tr["warm_retraces"] == jr["warm_retraces"] == 0
    assert tr["steps"] > 0
    if config in ("chunked", "ragged"):
        assert tr["host_syncs"] == tr["steps"]
    elif config == "legacy":
        assert tr["host_syncs"] == tr["steps"] + len(PROMPTS)


def test_clean_generate_records_zero_errors(sanitize):
    """A clean `generate` under FLAGS_sanitize: the unsanitized tokens,
    no warm retrace, a step and a fetch counted each step, and a
    lock-order graph with no cycle."""
    side = port()
    with side.flags(sanitize=False):
        reference = side.engine(**_engine_kw()).generate(PROMPTS, NEW)
    tsan.reset()
    eng = side.engine(**_engine_kw())
    assert eng.generate(PROMPTS, NEW) == reference
    rep = sanitize.report()
    assert rep["steps"] > 0 and rep["warm_retraces"] == 0
    assert rep["host_syncs"] == rep["steps"]
    assert rep["tombstoned_buffers"] == 0  # the port donates nothing
    edges = set(map(tuple, rep["lock_edges"]))
    assert not any((b, a) in edges for a, b in edges)
    assert "observability.LOCK" in {n for e in edges for n in e} or \
        not edges


# ---------------------------------------------------------------------------
# FLAGS_sanitize: lock order
# ---------------------------------------------------------------------------
def test_lock_order_cycle_raises(sanitize):
    a = tsan.TrackedLock(threading.Lock(), "fixture.A")
    b = tsan.TrackedLock(threading.Lock(), "fixture.B")
    with a:
        with b:
            pass
    with pytest.raises(tsan.LockOrderError) as ei:
        with b:
            with a:
                pass
    assert "fixture.A" in str(ei.value) and "fixture.B" in str(ei.value)
    # the cycle-closing edge is not recorded: the inversion raises again
    with pytest.raises(tsan.LockOrderError):
        with b:
            with a:
                pass
    with a:
        with b:
            pass
    assert sanitize.report()["lock_edges"] == [("fixture.A", "fixture.B")]


def test_lock_order_cycle_through_a_third_lock(sanitize):
    a, b, c = (tsan.TrackedLock(threading.RLock(), f"fixture.{n}")
               for n in "abc")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(tsan.LockOrderError, match="fixture.c"):
        with c, a:
            pass


def test_flag_flip_mid_hold_does_not_poison_stack(sanitize):
    side = port()
    a = tsan.TrackedLock(threading.Lock(), "fixture.flip")
    b = tsan.TrackedLock(threading.Lock(), "fixture.other")
    a.acquire()
    with side.flags(sanitize=False):
        a.release()  # bookkeeping runs while disabled
    with b:
        pass
    assert tsan.get().lock_edges == {}


def test_failed_nonblocking_acquire_not_recorded_as_held(sanitize):
    inner = threading.Lock()
    a = tsan.TrackedLock(inner, "fixture.busy")
    b = tsan.TrackedLock(threading.Lock(), "fixture.free")
    inner.acquire()
    try:
        assert a.acquire(blocking=False) is False
    finally:
        inner.release()
    with b:
        pass
    assert tsan.get().lock_edges == {}


def test_reentrant_rlock_is_not_a_cycle(sanitize):
    a = tsan.TrackedLock(threading.RLock(), "fixture.R")
    with a:
        with a:
            pass
    assert tsan.get().lock_edges == {}


def test_plain_lock_self_deadlock_raises(sanitize):
    a = tsan.TrackedLock(threading.Lock(), "fixture.plain")
    with a:
        with pytest.raises(tsan.LockOrderError, match="self-deadlock"):
            a.acquire()
    with a:
        pass


def test_telemetry_locks_are_tracked_under_jax_names():
    """The port's designated locks are TrackedLocks named as JAX names
    its own (the order graphs of the two packages read alike)."""
    import importlib

    mods = ["metrics", "tracing", "costmodel", "flight", "profiling",
            "alerts", "opsserver", "reporter"]
    for m in mods:
        t = importlib.import_module(f"paddle_tpu_torch.observability.{m}")
        j = importlib.import_module(f"paddle_tpu.observability.{m}")
        attr = "LOCK" if m == "metrics" else "_lock"
        tl, jl = getattr(t, attr), getattr(j, attr)
        assert isinstance(tl, tsan.TrackedLock), m
        assert tl.name == jl.name, m
        assert tl._reentrant == jl._reentrant, m


def test_report_keys_and_errors_match_jax():
    assert set(tsan.get().report()) == set(jsan.get().report())
    for name in ("SanitizerError", "UseAfterDonateError", "LockOrderError",
                 "WarmRetraceError"):
        t, j = getattr(tsan, name), getattr(jsan, name)
        assert [c.__name__ for c in t.__mro__[:-2]] == \
            [c.__name__ for c in j.__mro__[:-2]]
    assert set(tsan.__all__) == set(jsan.__all__)
