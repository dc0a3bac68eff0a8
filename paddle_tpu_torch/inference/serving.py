"""LLM decode serving: paged KV-cache pool + continuous-batching engine
(counterpart: paddle_tpu/inference/serving.py).

* `KVBlockPool` — host-side page allocator over the device page pools
  (``[layers, kv_heads, num_pages, page_size, head_dim]``), doubling as
  a content-addressed prefix cache: full prompt pages are registered
  under a chain hash, shared at refcount+1, parked on an LRU when their
  last reference drops, and recycled least-recently-released-first;
* `Request` / `DecodeEngine` — continuous batching over a fixed slot
  grid with chunked prefill: each step runs one ``[slots, Q_max]`` mixed
  batch (prefilling slots carry a prompt chunk as Q>1 ragged rows,
  decoding slots one row) while any slot is prefilling, and a classic
  one-row decode step otherwise.  With ``ragged_step`` every step is one
  ``[slots, Q_r]`` unified ragged step (`_gpt_ragged_step`) instead;
  with ``spec_decode_k`` each step is a speculative round
  (`inference.speculative`).  Every step calls
  `ops.paged_attention.paged_attention` once per layer.

Quantized serving: ``kv_quant="int8"`` keeps the KV pages as int8 with
per-page, per-head f32 scales (`ops.paged_attention.paged_quant_write`
writes them, kernel K2 reads them), and ``serve_weights="int8"`` folds
every matmul weight to per-out-channel int8 with f32 scales
(`_quantize_gpt_params`), widened back to the activation dtype at each
product (`_wmm`).  The int8 product is a PyTorch matmul over the widened
weight, as JAX leaves its ``dot_general`` to XLA: no kernel computes it,
and it reads the int8 weight and writes an f32 copy on every call.

The step functions are plain functions over the params dict and the
page pools, as in the JAX package, and record no autograd graph.  Where JAX donates the pools to a
jitted step and gets new ones back, the port writes into the pool
tensors in place.  Where JAX compiles each step into one executable per
signature (`_JitTracker`), the port runs each through a `_StepGraph`: on
the card, one CUDA graph per signature, captured at the step's first
call and replayed after; on the CPU, or inside `disable_capture()`, the
step runs eagerly.  Both count the JAX package's ``<kind>_compiles`` and
``<kind>_retraces`` in the process-wide `decode_stats` (the schema of
`paddle_tpu_torch.profiler`).  The legacy one-shot prefill
(``chunked_prefill=False``: `_gpt_prefill`, one graph per power-of-two
prompt bucket) is the chunked path's greedy oracle, as in JAX.

Admission is delegated to a `frontend.Scheduler` (FIFO or SLO: priority,
deadlines, preempt/resume); requests carry priority, deadline, SLO
targets and an ``on_token`` streaming hook.  Every step runs under the
containment ladder of `inference.resilience` (fault injection, retry,
degradation, bisect quarantine), with an optional write-ahead journal
and hung-step watchdog (`inference.durability`).  Disarmed, each fault,
journal and watchdog hook is one ``is None`` check; every step still
passes through the ladder's `run_step`.

The telemetry plane hooks in where the JAX engine's does
(`paddle_tpu_torch.observability`): the flight recorder
(``flight_window``, ``flight_dir``) records each step's batch, phase
times, events, pool and SLO burn; the cost observatory (``cost_model``)
counts each step signature's work at its first call, predicts step
cost, gates admission with ``FLAGS_sched_cost_admission`` and keeps the
HBM ledger; the profiling plane (``profile``) brackets sampled
dispatches with CUDA events; the alert engine (``alerts``) and the ops
server (``FLAGS_ops_port``) read what the engine publishes between
steps.  No hook reads a device tensor: they read the host mirrors
(``_lens``, ``_prefill_pos``, ``_active``, the pool allocator).

Tensor-parallel serving (``serve_mesh="mp=N"``, `paddle_tpu_torch.parallel`):
this process is the controller, rank 0 of N; the weights split by
`parallel.partition.gpt_serving_rules` (qkv head-aligned) and the KV
pools on their head axis.  The mesh implies the ragged step.  Each
sharded step sends its host inputs to the workers (`_MeshStep`), and
every rank runs `_forward_rows` over its heads, the row-split out and
fc2 products ending in an all-reduce (the ``reduce`` hook, JAX's
`_mesh_constrain`: absent off the mesh, where the steps are the
unsharded ones).  The controller alone samples, from the replicated
final LayerNorm and head.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import heapq
import itertools
import threading
import time
import weakref
from collections import Counter, OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import observability as _obs
from ..analysis import sanitizer as _san
from ..core import flags as _flags
from ..observability import costmodel as _costmodel
from ..device import resolve_device
from ..nn.decode import sample_logits
from ..nn.functional.attention import _sdpa_reference
from ..ops import capture as _capture
from ..ops import paged_attention as pa
from ..ops.layer_norm import layer_norm
from ..profiler import DECODE_STAT_COUNTERS, RecordEvent, _decode_stat_zero
from ..quantization.int8 import Q_MAX, quantize_weight
from .errors import FaultInfo, PoolExhausted, StepFault

__all__ = ["KVBlockPool", "Request", "DecodeEngine", "sample_logits",
           "NAN_TOKEN", "decode_stats", "reset_decode_stats",
           "disable_capture", "PRIORITY_INTERACTIVE", "PRIORITY_BATCH"]

# the sampled-token value of a row whose logits were not all finite: the
# host finishes that slot alone (finish_reason "fault")
NAN_TOKEN = -1

# the reusable no-op a disarmed flight recorder's phase sites enter
_NULL_CTX = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Telemetry (profiler.decode_stats): process-wide counters under one lock,
# every engine's deltas summed, with JAX's keys
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.RLock()
_STATS = {k: _decode_stat_zero(k) for k in DECODE_STAT_COUNTERS}


def _stats_add(**deltas):
    """Apply counter deltas atomically (one lock round per call)."""
    with _STATS_LOCK:
        for k, v in deltas.items():
            _STATS[k] += v


def decode_stats(reset=False):
    """Serving telemetry summed over every `DecodeEngine` of the process:
    the counters of `profiler.DECODE_STAT_COUNTERS` and the derived
    ``avg_step_ms``, ``batch_occupancy``, ``kv_block_utilization``,
    ``acceptance_rate`` and ``mean_accepted_per_step``, as the JAX
    package computes them.  ``retraces_after_warmup`` must stay 0 once
    every step has met its shapes.  ``reset=True`` zeroes the counters
    in the same lock round as the read."""
    with _STATS_LOCK:
        out = dict(_STATS)
        if reset:
            reset_decode_stats()
    steps = max(out["steps"], 1)
    out["avg_step_ms"] = out["decode_time_s"] / steps * 1e3
    out["batch_occupancy"] = out["occupancy_sum"] / steps
    out["kv_block_utilization"] = out["kv_util_sum"] / steps
    out["acceptance_rate"] = out["spec_accepted"] / max(
        out["spec_proposed"], 1)
    out["mean_accepted_per_step"] = out["spec_emitted"] / max(
        out["spec_slot_steps"], 1)
    return out


def reset_decode_stats():
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = _decode_stat_zero(k)


# ---------------------------------------------------------------------------
# One captured step per signature (counterpart: _JitTracker)
# ---------------------------------------------------------------------------
_CAPTURE_OFF = [0]  # open `disable_capture` blocks


@contextlib.contextmanager
def disable_capture():
    """Inside the block every `_StepGraph` runs its step eagerly, as JAX
    runs a jitted function under ``jax.disable_jit``: no graph is
    captured or replayed, and the counters count as before.  For
    comparisons against the captured serve, and for code that must see
    each step's Python call (a recorder that wraps a function the step
    calls)."""
    _CAPTURE_OFF[0] += 1
    try:
        yield
    finally:
        _CAPTURE_OFF[0] -= 1


class _GraphMemory:
    """What an engine's graphs share: one memory pool (they replay one
    at a time, in the order the engine calls them, on one stream) and
    the side stream that warms each step up and captures it.  Made at
    the first capture."""

    def __init__(self):
        self.pool = self.stream = None
        self.capture_s = 0.0  # host seconds spent warming up and capturing
        # bytes the captures grew the caching allocator's reserve by: the
        # graphs' pool (the HBM ledger's temp_scratch)
        self.pool_bytes = 0
        # set when the watchdog abandons the engine that owns these
        # graphs: a late-returning worker must launch nothing
        self.abandoned = False

    def ready(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        return self


class _Captured:
    """One step signature's CUDA graph (`ops.capture.Graph`), its static
    inputs (`ops.capture.StagedInputs`: one asynchronous copy stages a
    call's host inputs) and its static output."""

    def __init__(self, host, device):
        self.staged = _capture.StagedInputs.of(host, device)
        self.inputs = self.staged.inputs
        self.graph = self.out = None

    def replay(self, host):
        self.staged.load(host)
        self.graph.replay()
        return self.out


class _StepGraph:
    """The port's `_JitTracker`: one step function, counted as JAX
    counts its executables, and on the card one CUDA graph per signature.

    ``fn`` takes the step's per-call inputs as device tensors (weights,
    pools, generator and static keywords bound in) and returns a tensor
    or None; the tracker is called with those inputs as host numpy
    arrays, whose shapes and dtypes are the signature.  Construction
    counts one ``compile_key``; a signature first met after the first
    call counts ``<kind>_retraces`` and ``retraces_after_warmup``, as
    `_JitTracker.check_retrace` counts cache growth.  Under
    ``FLAGS_sanitize`` that call raises `sanitizer.WarmRetraceError`
    instead, before the step runs: the rule is "a new signature after
    the tracker's first call", on the CPU as on the card, where JAX's
    is its jit cache growing after warm-up.

    On the CPU, and inside `disable_capture`, the step runs eagerly.  On
    the card a new signature stages its inputs into a `_Captured`'s
    static buffer, runs the step once eagerly on the side stream (this
    call's result: it also makes every lazy handle, kernel attribute and
    counter a capture must not create), then captures it into the
    engine's shared pool; later calls copy their inputs in and replay.
    ``generator`` (an engine that samples) is registered with each
    graph, so a replay advances it as the eager step would.  A capture
    or replay that raises propagates: nothing falls back to eager.

    ``site`` is the JAX tracker's site label.  With the cost observatory
    armed, the first call of each signature (the eager call on the CPU,
    the warm-up before a capture on the card) is counted
    (`costmodel.count_executable`) and its profile key stamped as
    ``cost_sig``; ``cost`` is ``(tensors, bytes_of[, collective_of])``:
    the bound tensors the signature keys by besides the inputs, and
    functions of the host inputs giving the profile's bytes and its
    collective bytes.  ``capture=False`` runs the step eagerly on the
    card too (a step whose collectives cannot be captured)."""

    def __init__(self, fn, compile_key, device, memory, generator=None,
                 site=None, cost=None, capture=True):
        self.fn = fn
        self.site = site or compile_key
        self.cost_sig = None
        self._cost = cost
        self._capture_ok = capture
        self.compile_key = compile_key
        self._retrace_key = compile_key.replace("_compiles", "_retraces")
        self._device = device
        self._memory = memory
        self._generator = generator
        self._seen = set()
        self._graphs: Dict[tuple, _Captured] = {}
        # a first call of a signature (the compile, or on the card the
        # warm-up and capture) is in progress
        self._busy = False
        _stats_add(**{compile_key: 1})

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def release_graphs(self):
        """Destroy this tracker's CUDA graphs (an NCCL communicator is
        torn down only after the graphs that captured its collectives)."""
        for cap in self._graphs.values():
            if cap.graph is not None:
                cap.graph.reset()
        self._graphs.clear()

    @property
    def warm(self) -> bool:
        """Called at least once, and no first call of a signature in
        flight (the watchdog's `engine_warm`)."""
        return bool(self._seen) and not self._busy

    def __call__(self, *host):
        if self._memory.abandoned:
            raise StepFault(
                "engine abandoned by the hung-step watchdog: its late "
                "step launches nothing", site="hung", fatal=True)
        sig = tuple((a.shape, a.dtype.str) for a in host)
        first = sig not in self._seen
        if first:
            if self._seen:
                san = _san.active()
                if san is not None:
                    self._seen.add(sig)
                    san.count_warm_retrace()
                    raise _san.WarmRetraceError(
                        f"warm retrace of {self.site}: a new step "
                        f"signature {sig} after the tracker's first "
                        f"call — a step operand's shape or dtype "
                        f"changed mid-serve")
                _stats_add(retraces_after_warmup=1,
                           **{self._retrace_key: 1})
            self._seen.add(sig)
            self._busy = True
        try:
            if self._device.type != "cuda" or _CAPTURE_OFF[0] or \
                    not self._capture_ok:
                def run():
                    return self.fn(*(torch.from_numpy(
                        np.ascontiguousarray(a)).to(self._device)
                        for a in host))
                if first:
                    return self._counted(host, run)
                return run()
            cap = self._graphs.get(sig)
            if cap is None:
                self._busy = first = True
                cap, out = self._capture(host)
                self._graphs[sig] = cap
                return out
            return cap.replay(host)
        finally:
            if first:
                self._busy = False

    def _counted(self, host, run):
        """``run()``, counted into a cost profile when the observatory
        is armed (the first call of a signature)."""
        if not _costmodel.enabled():
            return run()
        tensors, bytes_of, *coll = self._cost or ((), None)
        key, out = _costmodel.count_executable(
            self.site, (*host, *tensors), run,
            None if bytes_of is None else (lambda: bytes_of(host)),
            (lambda: coll[0](host)) if coll else None)
        if key is not None:
            self.cost_sig = key
        return out

    def _capture(self, host):
        t0 = time.perf_counter()
        mem = self._memory.ready()
        reserved = torch.cuda.memory_reserved(self._device)
        cur = torch.cuda.current_stream(self._device)
        cap = _Captured(host, self._device)
        cap.staged.load(host)
        mem.stream.wait_stream(cur)
        with torch.cuda.stream(mem.stream):
            out = self._counted(host, lambda: self.fn(*cap.inputs))
            # a graph the cyclic collector frees inside a capture would
            # invalidate it (`ops.capture.capture` holds the collector
            # off): an engine holds no cycle of its own, `_EngineRef`, but
            # a caller's cycle can hold a dead engine and its graphs
            cap.graph, cap.out = _capture.capture(
                lambda: self.fn(*cap.inputs), pool=mem.pool,
                generator=self._generator)
        cur.wait_stream(mem.stream)
        if out is not None:
            out.record_stream(cur)
        grown = max(torch.cuda.memory_reserved(self._device) - reserved, 0)
        mem.pool_bytes += grown
        _costmodel.note_temp_bytes(self.cost_sig, grown)
        mem.capture_s += time.perf_counter() - t0
        return cap, out


class _MeshStep(_StepGraph):
    """The `_StepGraph` of a sharded step on the controller: each call
    first sends the workers the step's kind and host inputs
    (`parallel.mesh.MeshShards.step`), then runs rank 0's shard, whose
    all-reduces pair with theirs.  The mesh's lock holds other engines
    of the mesh off for the whole call.  Eager on a mesh whose
    collectives cannot be captured (gloo)."""

    def __init__(self, fn, compile_key, device, memory, shards, kind,
                 **kw):
        super().__init__(fn, compile_key, device, memory,
                         capture=shards.mesh.capturable, **kw)
        self._shards = shards
        self._kind = kind
        shards.mesh.track_graphs(self)

    def __call__(self, *host):
        mesh = self._shards.mesh
        with mesh.lock:
            if not self._memory.abandoned:
                self._shards.step(self._kind, host, bool(_CAPTURE_OFF[0]))
            try:
                return super().__call__(*host)
            except BaseException as e:
                # a half-run step leaves the workers in its collectives:
                # the mesh can serve nothing more
                if not (isinstance(e, StepFault) and
                        self._memory.abandoned):
                    mesh.broken = mesh.broken or f"a step raised: {e!r}"
                raise


# ---------------------------------------------------------------------------
# KV page pool (host-side allocator; the device pools live on the engine)
# ---------------------------------------------------------------------------
class KVBlockPool:
    """Free-list allocator over ``num_pages`` KV pages with a prefix
    cache.  A page is in exactly one of four states: free; private
    (owned by one request, writable); cached and referenced (registered
    under a chain-hash key, mapped read-only by refcount >= 1 requests);
    cached and unreferenced (refcount 0, payload kept for future hits,
    on the eviction LRU).

    `alloc_page` serves the free list first and then evicts the least
    recently released unreferenced cached page; a referenced page is
    never evicted.  `release_pages` unrefs cached pages and frees
    private ones; `free_pages` raises on a cached or already free page
    (the double-free guard)."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._free_set = set(self._free)
        self.reserved = 0  # pages promised to running requests
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0  # cached pages recycled under pressure

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def cached_count(self) -> int:
        """Pages currently content-addressed (referenced or not)."""
        return len(self._page_hash)

    @property
    def cached_unreferenced_count(self) -> int:
        return len(self._lru)

    @property
    def available_count(self) -> int:
        """Pages `alloc_page` can hand out now: free + evictable."""
        return len(self._free) + len(self._lru)

    def utilization(self) -> float:
        """Share of the pool a new request cannot claim: private and
        referenced cached pages (an idle warm cache reads 0.0)."""
        return (self.num_pages - self.available_count) / max(
            self.num_pages, 1)

    def alloc_page(self) -> int:
        if self._free:
            p = self._free.pop()
            self._free_set.discard(p)
            return p
        if self._lru:
            p, _ = self._lru.popitem(last=False)
            del self._hash_to_page[self._page_hash.pop(p)]
            del self._refs[p]
            self.evictions += 1
            return p
        raise PoolExhausted(
            "KV page pool exhausted: no free page and every cached "
            "page is referenced by a live request")

    def free_pages(self, pages):
        """Return PRIVATE pages to the free list; raises on a page that
        is not allocated-private."""
        for p in pages:
            p = int(p)
            if not 0 <= p < self.num_pages:
                raise ValueError(
                    f"page {p} outside pool [0, {self.num_pages})")
            if p in self._free_set:
                raise ValueError(f"double free of KV page {p}")
            if p in self._page_hash:
                raise ValueError(
                    f"page {p} is cached (refcount {self._refs[p]}); "
                    f"release_pages unrefs cached pages")
            self._free.append(p)
            self._free_set.add(p)

    def release_pages(self, pages):
        """A request is done with ``pages``: cached pages are unreffed,
        private pages go back to the free list."""
        for p in pages:
            p = int(p)
            if p in self._page_hash:
                self.unref_page(p)
            else:
                self.free_pages([p])

    def lookup(self, key: bytes) -> Optional[int]:
        return self._hash_to_page.get(key)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def register_page(self, page: int, key: bytes) -> bool:
        """Content-address a full, finally written PRIVATE page; the
        owner's hold becomes refcount 1.  False (nothing registered)
        when the key or the page is already cached."""
        p = int(page)
        if p in self._free_set:
            raise ValueError(f"cannot register free page {p}")
        if key in self._hash_to_page or p in self._page_hash:
            return False
        self._hash_to_page[key] = p
        self._page_hash[p] = key
        self._refs[p] = 1
        return True

    def ref_page(self, page: int):
        p = int(page)
        if p not in self._refs:
            raise ValueError(f"page {p} is not cached")
        self._refs[p] += 1
        self._lru.pop(p, None)

    def unref_page(self, page: int):
        p = int(page)
        r = self._refs.get(p)
        if r is None or r <= 0:
            raise ValueError(f"unref of page {p} without a live ref")
        self._refs[p] = r - 1
        if r == 1:
            self._lru[p] = None

    def assert_consistent(self, live_pages=None):
        """Audit the allocator invariants: free + private + cached
        referenced + cached unreferenced partition the pool, the hash
        maps are mutual inverses and the LRU is exactly the refcount-0
        cached set.  With ``live_pages`` (every live request's pages,
        with multiplicity) refcounts must equal the holders and each
        private used page must have one owner."""
        if not (len(self._free) == len(self._free_set)
                == len(set(self._free))):
            raise AssertionError("free list / free set diverged")
        if len(self._hash_to_page) != len(self._page_hash):
            raise AssertionError("hash->page / page->hash maps diverged")
        for h, p in self._hash_to_page.items():
            if self._page_hash.get(p) != h:
                raise AssertionError((p, "hash maps are not inverses"))
        if set(self._refs) != set(self._page_hash):
            raise AssertionError("refcounts must exist exactly for cached "
                                 "pages")
        if self._free_set & set(self._page_hash):
            raise AssertionError("cached page on the free list")
        if any(r < 0 for r in self._refs.values()):
            raise AssertionError("negative refcount")
        unref = {p for p, r in self._refs.items() if r == 0}
        if set(self._lru) != unref:
            raise AssertionError("LRU is not exactly the refcount-zero "
                                 "cached set")
        private = self.num_pages - self.free_count - self.cached_count
        if private < 0:
            raise AssertionError("more free+cached pages than the pool")
        if live_pages is None:
            return
        counts = Counter(int(p) for p in live_pages)
        for p, c in counts.items():
            if not 0 <= p < self.num_pages or p in self._free_set:
                raise AssertionError((p, "live page is free or outside"))
            if p in self._refs:
                if self._refs[p] != c:
                    raise AssertionError((p, self._refs[p], c,
                                          "refcount != live holders"))
            elif c != 1:
                raise AssertionError((p, c, "private page held twice"))
        for p, r in self._refs.items():
            if r > 0 and counts.get(p, 0) != r:
                raise AssertionError((p, r, "referenced page without "
                                      "its holders"))
        if len({p for p in counts if p not in self._refs}) != private:
            raise AssertionError("private page with no owner")


def _chain_hash(prev: bytes, tokens) -> bytes:
    """One link of a prompt's page chain hash: page i's key commits to
    tokens 0 .. (i+1)*page-1, so a hit at page i implies the whole
    prefix matched."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


# Priority classes (lower value = more urgent; any int works).  Plain
# `add_request` calls are BATCH: behind interactive traffic under the SLO
# scheduler, pure arrival order under FIFO.
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 10


class _EngineRef:
    """A helper's back-reference to the engine that owns it (scheduler,
    ladder, journal, watchdog, speculative decoder, drafter), held
    weakly.  Strong ones would put every engine in reference cycles, and
    its CUDA graphs and pools would outlive it until the cyclic collector
    ran, at a moment of its choosing: inside a later engine's serve.
    Reads give the engine, or None once it is gone."""

    def __set_name__(self, owner, name):
        self._key = f"_{name}_ref"

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        ref = obj.__dict__.get(self._key)
        return None if ref is None else ref()

    def __set__(self, obj, engine):
        obj.__dict__[self._key] = None if engine is None else \
            weakref.ref(engine)

    def bound(self, obj) -> bool:
        """Whether ``obj`` was bound to an engine, alive or gone, and not
        unbound (set to None) since: one scheduler or drafter serves one
        engine."""
        return obj.__dict__.get(self._key) is not None


class Request:
    """One generation request: queued -> running (slot + pages) -> done.

    ``finish_reason`` is "eos", "length", "evicted" (`DecodeEngine.evict`),
    "cancelled" (`cancel`), "deadline" (its ``deadline_ms`` passed while
    still queued under the SLO scheduler) or "fault" (containment
    quarantined it; ``fault_info`` holds the record).

    Scheduling metadata: ``priority`` (lower = more urgent),
    ``deadline_ms`` (budget from enqueue for the whole request),
    ``slo_ttft_ms``/``slo_tpot_ms`` (missing one is recorded in
    ``slo_violations``, never an abort).  ``on_token`` is called with
    each generated token the moment the engine lands it, from inside the
    serve loop: it must be cheap; a callback that raises is dropped and
    recorded in ``fault_info``.

    A preempted or recovered request goes back to "queued" with its
    generated tokens folded into ``prompt_ids`` for replay;
    ``generated_ids`` reads the whole generation throughout.  Lifecycle
    timestamps (``observability.now_ns``) feed the TTFT and TPOT
    histograms."""

    _next_id = itertools.count()
    # the engine it is queued or running on (`cancel`), held weakly: a
    # request kept after its serve does not keep the engine's pools alive
    _engine = _EngineRef()

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 priority=None, deadline_ms=None, slo_ttft_ms=None,
                 slo_tpot_ms=None, on_token=None):
        self.prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.priority = PRIORITY_BATCH if priority is None else \
            int(priority)
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        self.deadline_ms = None if deadline_ms is None else \
            float(deadline_ms)
        self.slo_ttft_ms = None if slo_ttft_ms is None else \
            float(slo_ttft_ms)
        self.slo_tpot_ms = None if slo_tpot_ms is None else \
            float(slo_tpot_ms)
        self.on_token = on_token
        # enqueue + deadline: the instant the request stops being worth
        # admitting
        self._deadline_ns: Optional[int] = None
        # preempt/resume: the original prompt length, generated tokens
        # folded into the prompt, preemptions, head-of-line skips
        self.orig_prompt_len = len(self.prompt_ids)
        self._absorbed = 0
        self.preemptions = 0
        self._hol_skips = 0
        # > 0 while replay recomputes tokens an earlier life already
        # streamed: `_emit` lands them but never re-fires on_token
        self._emit_gate = 0
        self.slo_violations: List[str] = []
        self.output_ids: List[int] = []
        self.state = "queued"
        self.finish_reason: Optional[str] = None
        self.fault_info: Optional[FaultInfo] = None
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        # prefix cache: the leading ``cached_page_count`` pages are shared
        # cached pages; chunked prefill starts at ``cached_prefix_len``
        self.cached_prefix_len = 0
        self.cached_page_count = 0
        # chain hashes of the prompt's full pages, memoized at the first
        # admission probe
        self._page_hashes: Optional[List[bytes]] = None
        # how many leading full pages are content-addressed in the pool
        self._reg_pages = 0
        self.request_id = next(Request._next_id)
        self.trace_id: Optional[str] = None
        self.t_enqueue_ns: Optional[int] = None
        self.t_admit_ns: Optional[int] = None
        self.t_first_token_ns: Optional[int] = None
        self.t_finish_ns: Optional[int] = None
        self.prefill_chunks = 0
        # SLO burn kinds already counted past 1.0 (the flight recorder's
        # paddle_slo_burn_exceeded_total counts each kind once)
        self._burn_noted = set()
        self._engine = None  # set by DecodeEngine.add_request

    def total_kv_tokens(self) -> int:
        # KV rows ever written: the prompt and every generated token
        # but the last (its KV is never needed); invariant under the
        # replay fold
        return len(self.prompt_ids) + max(self.max_new_tokens - 1, 0)

    @property
    def generated_ids(self) -> List[int]:
        """Every token this request generated, stable across
        preemptions and recoveries."""
        return self.prompt_ids[self.orig_prompt_len:] + self.output_ids

    def slo_burn(self, now_ns: int) -> Dict[str, float]:
        """Fraction of each declared latency budget consumed as of
        ``now_ns`` (the flight recorder samples it every step):
        ``ttft`` — elapsed since enqueue / ``slo_ttft_ms`` while the
        first token is pending; ``tpot`` — observed per-token latency /
        ``slo_tpot_ms`` once two tokens exist; ``deadline`` — elapsed /
        the ``deadline_ms`` budget while unfinished.  1.0 = the budget
        is spent.  Empty for a request that declared no targets."""
        out: Dict[str, float] = {}
        if self.t_enqueue_ns is None:
            return out
        if self.slo_ttft_ms is not None and \
                self.t_first_token_ns is None:
            out["ttft"] = ((now_ns - self.t_enqueue_ns) / 1e6) \
                / self.slo_ttft_ms
        if self.slo_tpot_ms is not None and \
                self.t_first_token_ns is not None:
            n_out = len(self.output_ids) + self._absorbed
            if n_out > 1:
                tpot_ms = (now_ns - self.t_first_token_ns) / 1e6 \
                    / (n_out - 1)
                out["tpot"] = tpot_ms / self.slo_tpot_ms
        if self._deadline_ns is not None and self.state != "done":
            budget = self._deadline_ns - self.t_enqueue_ns
            if budget > 0:
                out["deadline"] = (now_ns - self.t_enqueue_ns) / budget
        return out

    @property
    def slo_met(self) -> bool:
        """Completed ("eos"/"length") with no declared target missed."""
        return self.state == "done" and \
            self.finish_reason in ("eos", "length") and \
            not self.slo_violations

    def cancel(self):
        """Cancel wherever the request is: a queued request leaves the
        queue, a running one gives its slot and pages back.
        ``finish_reason`` reads "cancelled"; a finished request is left
        alone."""
        if self.state == "done":
            return
        if self._engine is None:
            raise ValueError("request is on no live engine: never "
                             "enqueued, or its engine is gone")
        if self.state == "queued":
            self._engine._cancel_queued(self)
        else:
            self._engine._cancel_running(self)


def _req_span_args(req: "Request", **extra) -> dict:
    """Span args of a request-carrying span: its id, and its fleet trace
    id when it has one."""
    args = {"request": req.request_id}
    if req.trace_id is not None:
        args["trace"] = req.trace_id
    args.update(extra)
    return args


# ---------------------------------------------------------------------------
# Functional GPT steps
# ---------------------------------------------------------------------------
# Weight leaves `_quantize_gpt_params` folds to int8: every [in, out]
# matmul weight of the steps.  Embeddings (wte is gathered, and the tied
# head needs its f32 transpose), position tables, LayerNorm parameters
# and biases stay f32.
_QUANT_WEIGHT_KEYS = ("qkv_w", "out_w", "fc1_w", "fc2_w")


def _quantize_gpt_params(params):
    """The params tree with every matmul weight leaf ``name`` (and an
    untied ``head_w``) REPLACED by an int8 ``name + "_q"`` leaf
    (per-out-channel symmetric, `quantize_weight` with quant_axis=1) and
    an f32 ``name + "_s"`` leaf holding ``absmax / Q_MAX``, the
    multiplier `_wmm` applies after the product.  Returns ``(params,
    mats, bytes_saved)``: the new tree, the matrices folded, and the
    device bytes the fold reclaims net of the scale leaves."""
    def fold(d):
        mats = saved = 0
        out = dict(d)
        for name in _QUANT_WEIGHT_KEYS + ("head_w",):
            w = out.get(name)
            if w is None:
                continue
            q, scale = quantize_weight(w, quant_axis=1)
            s = (scale / Q_MAX).float()
            del out[name]
            out[name + "_q"] = q
            out[name + "_s"] = s
            mats += 1
            saved += w.numel() * w.element_size() - q.numel() \
                - s.numel() * s.element_size()
        return out, mats, saved

    top, mats, saved = fold({k: v for k, v in params.items()
                             if k != "blocks"})
    top["blocks"] = []
    for blk in params["blocks"]:
        b, m, n = fold(blk)
        top["blocks"].append(b)
        mats += m
        saved += n
    return top, mats, saved


def _wmm(x, container, name):
    """Weight matmul of every step: ``x @ container[name]`` with the f32
    leaf present (serve_weights off: the product the steps always ran),
    else ``(x @ q.to(x.dtype)) * s`` over the int8 pair — JAX's
    ``dot_general(f32, s8, preferred f32) * s``; the per-out-channel scale
    commutes past the contraction."""
    w = container.get(name)
    if w is not None:
        return x @ w
    return (x @ container[name + "_q"].to(x.dtype)) * container[name + "_s"]


def _ln(x2d, w, b, eps):
    # the plain form, as serving's `_ln` is in the JAX package, whatever
    # FLAGS_use_pallas_layernorm says
    return layer_norm(x2d, w, b, eps)


def _logits_of(params, h):
    if "head_w" in params or "head_w_q" in params:
        out = _wmm(h, params, "head_w")
        if params.get("head_b") is not None:
            out = out + params["head_b"]
        return out
    # the tied head: wte stays f32 in every serve_weights mode
    return h @ params["wte"].T


def _guard_tokens(logits, tokens):
    """Rows whose logits are not all finite sample `NAN_TOKEN`."""
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, tokens, torch.full_like(tokens, NAN_TOKEN))


def _sample(params, h, eps, generator, sampling):
    h = _ln(h, params["lnf_w"], params["lnf_b"], eps)
    logits = _logits_of(params, h).float()
    nxt = sample_logits(logits, generator=generator, **sampling)
    return _guard_tokens(logits, nxt)


def _identity(t):
    return t


def _block_tail(x, blk, attn, eps, reduce=None):
    """Everything of a block after attention: out projection, residual,
    LN2, tanh-GELU MLP, residual.  x: [..., h]; attn: [..., h] (a rank's
    heads, [..., h / mp], on a mesh).  ``reduce`` (a mesh's all-reduce)
    finishes the row-split out and fc2 products before their biases,
    which add once; off the mesh it is absent and the ops are the
    unsharded step's."""
    red = reduce or _identity
    shape = x.shape
    x = x + red(_wmm(attn, blk, "out_w")) + blk["out_b"]
    y = _ln(x.reshape(-1, shape[-1]), blk["ln2_w"], blk["ln2_b"], eps)
    y = F.gelu(_wmm(y, blk, "fc1_w") + blk["fc1_b"], approximate="tanh")
    return x + (red(_wmm(y, blk, "fc2_w")) + blk["fc2_b"]).reshape(shape)


def _write_kv(k_pages, v_pages, k_scales, v_scales, li, rows, k, v):
    """Write one layer's new K and V rows in place: unquantized pages
    take the rows as they are, int8 pages (``k_scales`` given) through
    `paged_quant_write`.  Returns ``(refolds or None, the scale arguments
    of that layer's paged attention)``."""
    if k_scales is None:
        pa.paged_write(k_pages[li], rows, k)
        pa.paged_write(v_pages[li], rows, v)
        return None, {}
    refolds = pa.paged_quant_write(k_pages[li], k_scales[li], rows, k) + \
        pa.paged_quant_write(v_pages[li], v_scales[li], rows, v)
    return refolds, dict(k_scales=k_scales[li], v_scales=v_scales[li])


def _pack(tokens, refolds):
    """The step's output: the tokens, and after them the refold count when
    the pages are int8 (JAX's ``[B+1]`` form; ``[B+1, Q]`` with the count
    in column 0 for per-position targets), so one fetch brings both."""
    if refolds is None:
        return tokens
    row = torch.zeros_like(tokens[:1])
    row.view(-1)[0] = refolds.to(tokens.dtype)
    return torch.cat([tokens, row])


@torch.no_grad()
def _gpt_decode_step(params, k_pages, v_pages, block_tables, seq_lens,
                     tokens, active, generator, *, num_heads, head_dim, eps,
                     sampling, k_scales=None, v_scales=None):
    """One batched decode step over every slot: write the incoming
    token's K/V into its page (in place), paged attention over the pool,
    sample the next token.  Inactive slots write nowhere and read length
    0.  block_tables: [B, pages_max] int32; seq_lens, tokens: [B] int32;
    active: [B] bool; k_scales/v_scales: [L, Hkv, P] f32 with int8 pages
    (`_gpt_decode_step_q` of the JAX package).  Returns [B] int32 (0 for
    inactive slots), and with int8 pages [B+1]: the refold count last.
    The pools hold the drop page last (`_pool_shape`)."""
    b = tokens.shape[0]
    h = num_heads * head_dim
    num_pages_total, page = k_pages.shape[2] - 1, k_pages.shape[3]
    pos = seq_lens.long()
    # gathers clamp their index explicitly (JAX clamps, torch raises)
    wpe = params["wpe"]
    x = params["wte"][tokens.long()] + wpe[pos.clamp(max=wpe.shape[0] - 1)]
    bt_col = (pos // page).clamp(max=block_tables.shape[1] - 1)
    page_idx = torch.where(
        active, block_tables.long()[torch.arange(b, device=pos.device),
                                    bt_col], num_pages_total)
    # one row per sequence: the rows' pages are the refold set
    rows = pa.paged_write_rows(page_idx, pos % page)
    lens_now = seq_lens + active.to(seq_lens.dtype)
    refolds = None

    for li, blk in enumerate(params["blocks"]):
        y = _ln(x, blk["ln1_w"], blk["ln1_b"], eps)
        qkv = (_wmm(y, blk, "qkv_w") + blk["qkv_b"]).reshape(
            b, 3, num_heads, head_dim)
        r, scales = _write_kv(k_pages, v_pages, k_scales, v_scales, li, rows,
                              qkv[:, 1], qkv[:, 2])
        refolds = r if refolds is None else refolds + r
        attn = pa.paged_attention(qkv[:, 0], k_pages[li],
                                  v_pages[li], block_tables, lens_now,
                                  **scales)
        x = _block_tail(x, blk, attn.reshape(b, h), eps)

    nxt = _sample(params, x, eps, generator, sampling)
    return _pack(torch.where(active, nxt, torch.zeros_like(nxt)), refolds)


def _forward_rows(params, k_pages, v_pages, block_tables, seq_lens, tokens,
                  write_caps, *, num_heads, head_dim, eps, k_scales=None,
                  v_scales=None, reduce=None):
    """The ragged body the mixed, ragged and verify steps share: row ``i``
    of slot ``b`` holds ``tokens[b, i]`` at position ``seq_lens[b] + i``;
    the K/V of rows ``i < write_caps[b]`` is written into the slot's pages
    (in place; with ``k_scales``/``v_scales`` through the quantized
    write, which refolds each page a write touches once), and attention
    runs with per-sequence causal offsets ``q_offsets = seq_lens``.
    Rows past a slot's cap are computed and left to the caller to ignore.
    On a mesh ``num_heads`` is a rank's heads, its weights and pools
    hold those heads, and ``reduce`` sums the row-split products and the
    refold count over the ranks (`_block_tail`).
    Returns ``(x [B, Q, h] before the final LayerNorm, refolds or None)``."""
    b, qn = tokens.shape
    h = params["wte"].shape[1]
    hl = num_heads * head_dim
    num_pages_total, page = k_pages.shape[2] - 1, k_pages.shape[3]
    offs = torch.arange(qn, dtype=torch.int64, device=tokens.device)
    pos = seq_lens.long()[:, None] + offs[None, :]
    wpe = params["wpe"]
    x = params["wte"][tokens.long()] + wpe[pos.clamp(max=wpe.shape[0] - 1)]
    page_idx, slot = pa.paged_write_indices(
        block_tables, seq_lens, write_caps, qn, num_pages_total, page)
    rows = pa.paged_write_rows(page_idx, slot, None if k_scales is None
                               else pa.paged_write_spans(
                                   block_tables, seq_lens, write_caps, qn,
                                   num_pages_total, page))
    lens_now = seq_lens + write_caps
    refolds = None

    for li, blk in enumerate(params["blocks"]):
        y = _ln(x.reshape(b * qn, h), blk["ln1_w"], blk["ln1_b"], eps)
        qkv = (_wmm(y, blk, "qkv_w") + blk["qkv_b"]).reshape(
            b, qn, 3, num_heads, head_dim)
        r, scales = _write_kv(
            k_pages, v_pages, k_scales, v_scales, li, rows,
            qkv[:, :, 1].reshape(b * qn, num_heads, head_dim),
            qkv[:, :, 2].reshape(b * qn, num_heads, head_dim))
        refolds = r if refolds is None else refolds + r
        attn = pa.paged_attention(qkv[:, :, 0], k_pages[li],
                                  v_pages[li], block_tables, lens_now,
                                  q_offsets=seq_lens, **scales)
        x = _block_tail(x, blk, attn.reshape(b, qn, hl), eps, reduce)
    if reduce is not None and refolds is not None:
        refolds = reduce(refolds.reshape(1)).reshape(())
    return x, refolds


@torch.no_grad()
def _gpt_mixed_step(params, k_pages, v_pages, block_tables, seq_lens,
                    tokens, write_caps, sample_idx, sample_mask, generator,
                    *, num_heads, head_dim, eps, sampling, k_scales=None,
                    v_scales=None):
    """One mixed prefill+decode step over every slot: a prefilling slot
    contributes a prompt chunk (rows 0..cap-1 of its ``tokens`` row), a
    decoding slot its last sampled token (cap 1), an idle slot nothing
    (cap 0); `_forward_rows` writes and attends, and one token per slot
    is sampled from row ``sample_idx``; ``sample_mask`` zeroes slots
    still mid-prefill.

    tokens: [B, Q_max] int32; write_caps, sample_idx: [B] int32;
    sample_mask: [B] bool; k_scales/v_scales: [L, Hkv, P] f32 with int8
    pages (`_gpt_mixed_step_q` of the JAX package).  Returns [B] int32,
    and with int8 pages [B+1]: the refold count last."""
    b = tokens.shape[0]
    x, refolds = _forward_rows(
        params, k_pages, v_pages, block_tables, seq_lens, tokens,
        write_caps, num_heads=num_heads, head_dim=head_dim, eps=eps,
        k_scales=k_scales, v_scales=v_scales)
    # sample ONE row per slot: the head matmul runs over [B, h]
    sel = x[torch.arange(b, device=x.device), sample_idx.long()]
    nxt = _sample(params, sel, eps, generator, sampling)
    return _pack(torch.where(sample_mask, nxt, torch.zeros_like(nxt)),
                 refolds)


@torch.no_grad()
def _gpt_ragged_step(params, k_pages, v_pages, block_tables, seq_lens,
                     tokens, write_caps, generator, *, num_heads, head_dim,
                     eps, sampling, k_scales=None, v_scales=None,
                     reduce=None):
    """The unified ragged step: score up to Q_r incoming tokens a slot in
    one pass — a decode row (cap 1), a prompt chunk (cap C) or a
    speculative verify window (cap K+1) — and draw a target token at
    EVERY position with the engine's `sample_logits`.  The rows of
    `_forward_rows`; a cap of 0 sits the slot out, and its targets, like
    those past any cap, are garbage the host ignores.

    tokens: [B, Q_r] int32; write_caps: [B] int32 in [0, Q_r];
    k_scales/v_scales as for `_gpt_mixed_step` (`_gpt_ragged_step_q` of
    the JAX package).  Returns [B, Q_r] int32 targets, and with int8
    pages [B+1, Q_r]: the refold count in column 0 of the last row.
    Every row pays the head's matmul, as in JAX; greedy targets are the
    split path's tokens.  ``reduce``: rank 0's shard of a sharded step
    (`_forward_rows`)."""
    b, qn = tokens.shape
    x, refolds = _forward_rows(
        params, k_pages, v_pages, block_tables, seq_lens, tokens,
        write_caps, num_heads=num_heads, head_dim=head_dim, eps=eps,
        k_scales=k_scales, v_scales=v_scales, reduce=reduce)
    nxt = _sample(params, x.reshape(b * qn, x.shape[-1]), eps, generator,
                  sampling)
    return _pack(nxt.reshape(b, qn), refolds)


def _prefill_rows(params, k_pages, v_pages, ids, true_len, bt_row, *,
                  num_heads, head_dim, eps, k_scales=None, v_scales=None,
                  reduce=None):
    """The body of `_gpt_prefill`: the prompt's rows through every block,
    their K/V written.  Returns ``(x [S_pad, h], refolds or None)``; on a
    mesh as `_forward_rows`."""
    s_pad = ids.shape[1]
    hl = num_heads * head_dim
    num_pages_total, page = k_pages.shape[2] - 1, k_pages.shape[3]
    pos = torch.arange(s_pad, dtype=torch.int64, device=ids.device)
    x = params["wte"][ids[0].long()] + params["wpe"][pos]
    bt_idx = (pos // page).clamp(max=bt_row.shape[0] - 1)
    page_idx = torch.where(pos < true_len.long(), bt_row.long()[bt_idx],
                           num_pages_total)
    spans = None
    if k_scales is not None:
        spans = pa.paged_write_spans(bt_row[None], torch.zeros_like(true_len),
                                     true_len, s_pad, num_pages_total, page)
    rows = pa.paged_write_rows(page_idx, pos % page, spans)
    refolds = None

    for li, blk in enumerate(params["blocks"]):
        y = _ln(x, blk["ln1_w"], blk["ln1_b"], eps)
        qkv = (_wmm(y, blk, "qkv_w") + blk["qkv_b"]).reshape(
            s_pad, 3, num_heads, head_dim)
        r, _ = _write_kv(k_pages, v_pages, k_scales, v_scales, li, rows,
                         qkv[:, 1], qkv[:, 2])
        refolds = r if refolds is None else refolds + r
        q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
        attn = _sdpa_reference(q, k, v, None, 0.0, None, True)[0]
        x = _block_tail(x, blk, attn.transpose(0, 1).reshape(s_pad, hl),
                        eps, reduce)
    if reduce is not None and refolds is not None:
        refolds = reduce(refolds.reshape(1)).reshape(())
    return x, refolds


@torch.no_grad()
def _gpt_prefill(params, k_pages, v_pages, ids, true_len, bt_row, generator,
                 *, num_heads, head_dim, eps, sampling, k_scales=None,
                 v_scales=None, reduce=None):
    """The legacy one-shot prompt pass for ONE request: causal attention
    over the bucket-padded prompt in plain PyTorch (`_sdpa_reference`, as
    JAX's `_gpt_prefill` attends with the XLA reference), every valid
    row's K/V written into the request's pages (int8 pages through the
    quantized write, `_gpt_prefill_q` of the JAX package), and the first
    token sampled from the last valid row, picked on the device.

    ids: [1, S_pad] int32; true_len: [1] int32, so one graph serves every
    prompt of a bucket; bt_row: [pages_max] int32.  Rows at or past
    ``true_len`` write into the drop page.  Returns [1] int32 (`NAN_TOKEN`
    on non-finite logits), and with int8 pages [2]: the refold count
    after the token."""
    x, refolds = _prefill_rows(
        params, k_pages, v_pages, ids, true_len, bt_row,
        num_heads=num_heads, head_dim=head_dim, eps=eps, k_scales=k_scales,
        v_scales=v_scales, reduce=reduce)
    last = x.index_select(0, (true_len - 1).long())       # [1, h]
    return _pack(_sample(params, last, eps, generator, sampling), refolds)


# a worker's shard of each kind of sharded step (`parallel.mesh`): the
# body alone, nothing sampled (rank 0 samples)
_MESH_WORKER_STEPS = {"ragged": _forward_rows, "prefill": _prefill_rows}


def _reset_kv_scales(k_scales, v_scales, fresh_idx):
    """Zero the scale entries of pages handed out since the last step
    (counterpart: `_reset_kv_scales` of the JAX package).  ``fresh_idx``
    is a fixed [num_pages] int64 index padded with ``num_pages``, the
    drop page, so every call has one signature.  A fill, not an indexed
    assignment of 0.0, which would copy the scalar from the host (a
    capture refuses that)."""
    k_scales.index_fill_(2, fresh_idx, 0.0)
    v_scales.index_fill_(2, fresh_idx, 0.0)


def _scale_reset_graph(k_scales, v_scales, device, memory,
                       owner="DecodeEngine") -> "_StepGraph":
    """The `_StepGraph` of one pool pair's `_reset_kv_scales`
    (``kv_quant_compiles``): a draft model's pools get their own, as
    their layer count may differ from the target's."""
    return _StepGraph(lambda idx: _reset_kv_scales(k_scales, v_scales, idx),
                      "kv_quant_compiles", device, memory,
                      site=f"{owner} scale reset (_reset_kv_scales)",
                      cost=((k_scales,), None))


def _pool_shape(layers, heads, num_pages, page, head_dim):
    """A KV pool for ``num_pages`` allocatable pages: one more, the drop
    page (`ops.paged_attention`), where the rows JAX drops land."""
    return (layers, heads, num_pages + 1, page, head_dim)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
_STAT_KEYS = ("steps", "tokens", "mixed_steps", "prefill_chunks",
              "prefix_hits", "prefix_misses", "prefix_cached_tokens",
              "kv_quant_pages", "kv_quant_refolds", "weight_quant_mats",
              "weight_quant_bytes_saved", "ragged_steps", "spec_steps",
              "spec_slot_steps", "spec_proposed", "spec_accepted",
              "spec_emitted", "spec_k_shrinks", "spec_k_grows")
_STAT_SECONDS = ("mixed_step_s", "decode_step_s", "draft_time_s",
                 "verify_time_s")
# the decode_stats counter each finish reason counts under
_FINISH_COUNTER = {"eos": "finished_eos", "length": "finished_length",
                   "evicted": "evicted", "cancelled": "cancelled",
                   "fault": "finished_fault", "deadline": "deadline_expired"}


class DecodeEngine:
    """Continuous-batching decode over a paged KV cache.

    ``model`` is a `models.gpt.GPT`.  Requests are admitted in arrival
    order into ``max_batch_size`` slots and leave the step they finish.
    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path.  The KV pages take the
    weights' dtype, which K1 needs of q and pages alike, or int8 with
    ``kv_quant="int8"`` (kernel K2); ``serve_weights="int8"`` folds the
    matmul weights to int8.  ``ragged_step`` serves every step through
    `_gpt_ragged_step`; ``spec_decode_k`` (with ``drafter`` and
    ``spec_adaptive_k``) speculates K tokens a round.
    ``chunked_prefill=False`` admits each request with one legacy
    prompt pass (`_gpt_prefill`) between steps instead of feeding its
    prompt through the mixed steps; it takes no prefix cache, as in JAX.
    On the card every step kind runs as a CUDA graph per signature
    (`_StepGraph`), captured at its first call; `disable_capture` runs
    them eagerly.  ``scheduler`` ("fifo" | "slo" | a `frontend.Scheduler`)
    orders admission; ``fault_plan`` (a `resilience.FaultPlan` or its
    spec string) arms fault injection; ``journal_dir`` arms the
    write-ahead journal and ``step_timeout_ms`` the hung-step watchdog
    (`inference.durability`).  ``dtype``, when given, must name the
    weights' dtype (the KV pages take it).  The telemetry plane:
    ``flight_window`` (0 = no flight recorder) and ``flight_dir`` (its
    dump directory, default ``<journal_dir>/flight``), ``cost_model``
    (seeded by ``cost_calibration``), ``alerts`` (True = the default
    rules, a rule sequence = a custom table), ``profile`` and
    ``profile_sample_steps``.  The flags of `core.flags`
    fill every argument left None.  ``_adopt`` (`resilience.recover`'s
    handoff) is a retired engine of this configuration whose weights,
    pools, generator and captured graphs this one takes over
    (`_take_over`) instead of allocating its own.

    ``serve_mesh="mp=N"`` (or ``FLAGS_serve_mesh``; the argument wins)
    serves tensor-parallel over N ranks (`paddle_tpu_torch.parallel`):
    this process is rank 0, the mesh's workers hold the other shards, and
    the engine serves through the ragged step.  ``""`` is the unsharded
    engine, unchanged."""

    _next_engine_id = itertools.count()
    # what a step graph reads: `_take_over` moves them with the graphs
    _GRAPH_ATTRS = ("_decode_fn", "_mixed_fn", "_ragged_fn",
                    "_scale_reset_fn")
    _DEVICE_ATTRS = ("_params", "_k_pages", "_v_pages", "_k_scales",
                     "_v_scales", "_generator", "_graph_memory",
                     "_mesh_shards")

    def __init__(self, model, max_batch_size=4, max_seq_len=None,
                 page_size=None, num_pages=None, sampler="greedy",
                 temperature=1.0, top_k=0, top_p=1.0, seed=0,
                 eos_token_id=None, spec_decode_k=None, drafter=None,
                 chunked_prefill=None, prefill_chunk_tokens=None,
                 prefill_q_max=None, prefix_cache=None,
                 cache_generated_pages=None, kv_quant=None,
                 serve_weights=None, ragged_step=None, spec_adaptive_k=None,
                 scheduler=None, fault_plan=None, journal_dir=None,
                 step_timeout_ms=None, dtype=None, device=None,
                 flight_window=None, flight_dir=None, cost_model=None,
                 cost_calibration=None, alerts=None, profile=None,
                 profile_sample_steps=None, serve_mesh=None, _adopt=None):
        cfg = model.cfg
        if getattr(cfg, "dropout", 0.0) and model.training:
            # dropout is not part of the step functions: refuse rather
            # than flip the caller's train/eval mode
            raise ValueError(
                "DecodeEngine serves inference only: call model.eval() "
                "first (cfg.dropout > 0 and the model is in train mode)")
        self.device = resolve_device(device)
        self._mesh_shards = None
        self._init_mesh(serve_mesh, cfg.num_heads, ragged_step)
        if _adopt is not None:
            if _adopt._abandoned or _adopt._k_pages is None:
                raise ValueError(
                    "an abandoned or released engine hands nothing over")
            for a in self._DEVICE_ATTRS + ("_fp_wrows",):
                setattr(self, a, getattr(_adopt, a))
        else:
            self._params = _tree_to(model.params(), self.device)
        weight_dtype = _dtype_name(self._params["wte"].dtype)
        if dtype is not None and _dtype_name(dtype) != weight_dtype:
            raise ValueError(
                f"dtype {dtype} differs from the weights' {weight_dtype}: "
                f"the KV pages take the weights' dtype")
        if kv_quant is None:
            kv_quant = str(_flags.flag("kv_quant"))
        if kv_quant not in ("off", "int8"):
            raise ValueError(
                f"kv_quant must be 'off' or 'int8', got {kv_quant!r}")
        self._kv_quant = kv_quant == "int8"
        if serve_weights is None:
            serve_weights = str(_flags.flag("serve_weights"))
        if serve_weights not in ("off", "int8"):
            raise ValueError(
                f"serve_weights must be 'off' or 'int8', got "
                f"{serve_weights!r}")
        # the fingerprint's qkv rows, sampled before a weight fold renames
        # the leaf: the prefix-cache root is the same in every mode
        if _adopt is None:
            self._fp_wrows = [
                blk["qkv_w"][0].float().cpu().numpy().tobytes()
                for blk in self._params["blocks"]]
        self._num_heads = cfg.num_heads
        self._head_dim = cfg.hidden_size // cfg.num_heads
        self._eps = float(model.ln_f._epsilon)
        self._num_layers = cfg.num_layers
        self._slots = int(max_batch_size)
        self._max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self._max_seq_len > cfg.max_seq_len:
            # positions past the wpe table would clamp in the embedding
            # gather (wrong logits, no error) — refuse instead
            raise ValueError(
                f"max_seq_len {self._max_seq_len} exceeds the model's "
                f"position table ({cfg.max_seq_len})")
        kv_dtype = self._params["wte"].dtype
        if self.device.type == "cuda":
            # f32 serving means f32 matmuls: keep TF32 off explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
        self._page = int(page_size or pa.default_page_size(self._max_seq_len))
        # block tables round UP: a horizon that does not tile leaves the
        # last page partly used (ragged lengths mask the rest)
        self._pages_per_seq = -(-self._max_seq_len // self._page)
        n_pages = int(num_pages or self._slots * self._pages_per_seq)
        self.pool = KVBlockPool(n_pages)
        # a mesh rank's pools hold its heads of every page
        shape = _pool_shape(self._num_layers, self._local_heads, n_pages,
                            self._page, self._head_dim)
        if self._kv_quant:
            kv_dtype = torch.int8
        if _adopt is None:
            self._k_pages = torch.zeros(shape, dtype=kv_dtype,
                                        device=self.device)
            self._v_pages = torch.zeros(shape, dtype=kv_dtype,
                                        device=self.device)
            # per-page, per-head dequant scales of int8 pages
            self._k_scales = self._v_scales = None
            if self._kv_quant:
                sshape = shape[:3]
                self._k_scales = torch.zeros(sshape, dtype=torch.float32,
                                             device=self.device)
                self._v_scales = torch.zeros(sshape, dtype=torch.float32,
                                             device=self.device)
        # pages handed out since the last step: their scales zero before
        # any quantized write folds into them (`_flush_fresh_scales`)
        self._fresh_pages: List[int] = []

        self._bt = np.zeros((self._slots, self._pages_per_seq), np.int32)
        self._lens = np.zeros(self._slots, np.int32)
        self._active = np.zeros(self._slots, bool)
        self._last = np.zeros(self._slots, np.int32)
        self._by_slot: List[Optional[Request]] = [None] * self._slots
        # prompt tokens consumed per slot (the chunked-prefill cursor)
        self._prefill_pos = np.zeros(self._slots, np.int32)
        self._free_slots = list(range(self._slots))
        heapq.heapify(self._free_slots)

        self._sampling = dict(sampler=sampler,
                              temperature=float(temperature),
                              top_k=int(top_k), top_p=float(top_p))
        self._eos = eos_token_id
        if _adopt is None:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._queue: "deque[Request]" = deque()
        self._stats = dict.fromkeys(_STAT_KEYS, 0)
        self._stats.update(dict.fromkeys(_STAT_SECONDS, 0.0))
        self._evictions_seen = 0
        # the step trackers, made at each kind's first step: graphs of one
        # engine (its draft model's too) share one memory pool
        if _adopt is None:
            self._graph_memory = _GraphMemory()
        self._decode_fn = self._mixed_fn = self._ragged_fn = None
        self._scale_reset_fn = None
        self._prefill_fns: Dict[int, _StepGraph] = {}
        self._weight_quant = serve_weights == "int8"
        if self._weight_quant:
            if _adopt is None:
                self._params, mats, saved = _quantize_gpt_params(
                    self._params)
            else:  # folded already; counted as JAX's rebuilt engine does
                mats = _adopt._stats["weight_quant_mats"]
                saved = _adopt._stats["weight_quant_bytes_saved"]
            self._add(weight_quant_mats=mats, weight_quant_bytes_saved=saved)
        if self._mesh is not None and _adopt is None:
            self._shard_onto_mesh()

        # the legacy one-shot prefill (chunked_prefill=False) stays the
        # chunked path's greedy oracle, as in JAX
        if chunked_prefill is None:
            chunked_prefill = bool(_flags.flag("chunked_prefill"))
        self._chunked = bool(chunked_prefill)
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = int(_flags.flag("prefill_chunk_tokens"))
        if prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got "
                f"{prefill_chunk_tokens}")
        # per-step prompt-token budget
        self._chunk_budget = min(int(prefill_chunk_tokens),
                                 self._max_seq_len)
        # Q_max, the mixed step's row width and a chunk's largest span:
        # the budget, or less when the caller caps the step's compute
        q_max_explicit = prefill_q_max is not None
        if prefill_q_max is None:
            prefill_q_max = self._chunk_budget
        if prefill_q_max < 1:
            raise ValueError(
                f"prefill_q_max must be >= 1, got {prefill_q_max}")
        self._q_max = min(int(prefill_q_max), self._chunk_budget)
        # the prefix cache needs chunked prefill: the one-shot pass cannot
        # start mid-prompt
        if prefix_cache is None:
            prefix_cache = bool(_flags.flag("prefix_cache")) and \
                self._chunked
        elif prefix_cache and not self._chunked:
            raise ValueError(
                "prefix_cache needs chunked prefill: the legacy one-shot "
                "prefill cannot start mid-prompt (set chunked_prefill=1, "
                "or drop prefix_cache)")
        self._prefix_cache = bool(prefix_cache)
        self._model_salt = self._model_fingerprint() \
            if self._prefix_cache else b""
        if cache_generated_pages is None:
            cache_generated_pages = bool(_flags.flag("cache_generated_pages"))
        self._cache_generated = bool(cache_generated_pages) and \
            self._prefix_cache
        # FLAGS_kv_pool_debug: audit the pool partition and refcounts at
        # every step boundary (host-only cost)
        self._pool_debug = bool(_flags.flag("kv_pool_debug"))

        # speculative decoding, with JAX's refusals of a drafter or an
        # adaptive depth without it
        if spec_decode_k is None:
            spec_decode_k = int(_flags.flag("spec_decode_k"))
        if drafter is not None and not spec_decode_k:
            raise ValueError(
                "drafter passed but speculative decoding is off: set "
                "spec_decode_k >= 1 (or FLAGS_spec_decode_k)")
        if spec_adaptive_k and not spec_decode_k:
            raise ValueError(
                "spec_adaptive_k passed but speculative decoding is off: "
                "set spec_decode_k >= 1 (or FLAGS_spec_decode_k)")
        if spec_adaptive_k is None:
            spec_adaptive_k = bool(_flags.flag("spec_adaptive_k"))
        self._spec = None
        if spec_decode_k:
            from .speculative import SpeculativeDecoder

            self._spec = SpeculativeDecoder(self, k=int(spec_decode_k),
                                            drafter=drafter,
                                            adaptive=bool(spec_adaptive_k))
        if ragged_step is None:
            ragged_step = bool(_flags.flag("ragged_step"))
        # the mesh shards the ONE step a KV mode: it implies the ragged step
        self._ragged = bool(ragged_step) or self._mesh is not None
        # the ragged grid's row width Q_r fits the widest span of any
        # phase: a decode row, a chunk (Q_max), a verify window (K+1).
        # Every step pays the whole grid, so an unpinned Q_max shrinks
        # to one page of span (never below the verify window)
        window = self._spec.k + 1 if self._spec is not None else 1
        if self._ragged and self._chunked and not q_max_explicit:
            self._q_max = min(self._q_max, max(self._page, window))
        self._q_ragged = max(self._q_max if self._chunked else 1, window)

        # the admission scheduler (inference.frontend)
        from .frontend import make_scheduler

        if scheduler is None:
            scheduler = str(_flags.flag("sched_policy"))
        self._scheduler = make_scheduler(scheduler)
        self._scheduler.bind(self)
        # fault injection + the containment ladder (inference.resilience)
        from .resilience import FaultPlan, ResilienceManager

        if fault_plan is None:
            fault_plan = FaultPlan.parse(str(_flags.flag("fault_inject")))
        elif isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan)
        self._fault = fault_plan
        self._resilience = ResilienceManager(self)
        # what the degradation ladder may flip and its probe restores
        self._chunked_cfg = self._chunked
        self._prefix_cache_cfg = self._prefix_cache
        # RNG-free step counters, JAX's fold counters: the engine step a
        # fault verdict lands on, and the legacy prefills run
        self._step_no = 0
        self._prefill_no = 0
        self._engine_id = next(DecodeEngine._next_engine_id)
        # FLAGS_metrics_report_interval_s > 0: the periodic reporter
        _obs.maybe_start_reporter()
        if self._weight_quant:
            _obs.WEIGHT_QUANT_SAVED_BYTES.set(
                self._stats["weight_quant_bytes_saved"],
                engine=self._engine_id)

        # durable serving + the hung-step watchdog (inference.durability)
        if journal_dir is None:
            journal_dir = str(_flags.flag("journal_dir")) or None
        if step_timeout_ms is None:
            step_timeout_ms = float(_flags.flag("step_timeout_ms"))
        self._journal_dir = journal_dir
        self._step_timeout_ms = float(step_timeout_ms)
        # set by the watchdog's abandon path: a step still running in a
        # worker thread must change nothing when it returns
        self._abandoned = False
        self._config_fp: Optional[bytes] = None
        self._durability = None
        self._watchdog = None
        # the resolved construction config: `resilience.recover` rebuilds
        # this engine from it, `wire_config` journals its serializable
        # part.  Scheduler, drafter and fault plan instances are reused.
        self._ctor = dict(
            model=model, max_batch_size=self._slots,
            max_seq_len=self._max_seq_len, page_size=self._page,
            num_pages=self.pool.num_pages,
            sampler=self._sampling["sampler"],
            temperature=self._sampling["temperature"],
            top_k=self._sampling["top_k"], top_p=self._sampling["top_p"],
            seed=seed, eos_token_id=self._eos, dtype=weight_dtype,
            spec_decode_k=(self._spec.k if self._spec else 0),
            drafter=(self._spec.drafter if self._spec else None),
            chunked_prefill=self._chunked,
            prefill_chunk_tokens=self._chunk_budget,
            prefill_q_max=self._q_max, prefix_cache=self._prefix_cache,
            cache_generated_pages=self._cache_generated,
            scheduler=self._scheduler, fault_plan=self._fault,
            journal_dir=self._journal_dir,
            step_timeout_ms=self._step_timeout_ms,
            kv_quant=kv_quant, serve_weights=serve_weights,
            ragged_step=self._ragged,
            spec_adaptive_k=(self._spec.adaptive
                             if self._spec is not None else False),
            serve_mesh=self._serve_mesh, device=self.device)
        if _adopt is not None:
            if _adopt.config_fingerprint() != self.config_fingerprint():
                raise ValueError(
                    "_adopt: the donor's configuration differs")
            self._take_over(_adopt)
        self._init_telemetry(flight_window, flight_dir, cost_model,
                             cost_calibration, alerts, profile,
                             profile_sample_steps)
        if self._journal_dir:
            from .durability import DurabilityManager

            self._durability = DurabilityManager(self, self._journal_dir)
        if self._step_timeout_ms > 0:
            from .durability import StepWatchdog

            self._watchdog = StepWatchdog(self, self._step_timeout_ms)
        from .durability import set_health

        set_health(self._engine_id, "live", span=False)
        from ..observability import opsserver as _opsserver

        _opsserver.register_engine(self)
        _opsserver.maybe_start_ops_server()

    def _init_mesh(self, serve_mesh, num_heads: int, ragged_step):
        """Resolve ``serve_mesh`` (the argument, else its flag) and check
        it as JAX does: a malformed spec, an axis other than ``mp``, more
        ranks than the host has places for, heads that do not divide, or
        an explicit ``ragged_step=False`` raise ValueError.  Builds (or
        reuses) the process's mesh; the weights shard later
        (`_shard_onto_mesh`), after any int8 fold."""
        if serve_mesh is None:
            serve_mesh = str(_flags.flag("serve_mesh"))
        self._serve_mesh = str(serve_mesh or "").strip()
        self._mesh = None
        self._mesh_mp = 1
        self._local_heads = num_heads
        if not self._serve_mesh:
            return
        from ..parallel.mesh import rank_capacity
        from ..parallel.partition import build_mesh, parse_mesh_spec

        axes = parse_mesh_spec(self._serve_mesh)
        if [a for a, _ in axes] != ["mp"]:
            raise ValueError(
                f"serve_mesh supports a single tensor-parallel axis "
                f"'mp=N', got {self._serve_mesh!r}")
        mp = axes[0][1]
        have = rank_capacity()
        if have < mp:
            raise ValueError(
                f"serve_mesh {self._serve_mesh!r} needs {mp} devices, "
                f"have {have}")
        if num_heads % mp:
            raise ValueError(
                f"serve_mesh {self._serve_mesh!r}: num_heads {num_heads} "
                f"not divisible by mp={mp}")
        if ragged_step is not None and not ragged_step:
            raise ValueError(
                "serve_mesh requires the unified ragged step (the mesh "
                "shards the ONE step a KV mode): drop ragged_step=0, or "
                "the mesh")
        self._mesh = build_mesh(self._serve_mesh, self.device)
        self._mesh_mp = mp
        self._local_heads = num_heads // mp

    def _shard_onto_mesh(self):
        """Cut the weights by `gpt_serving_rules`: this rank keeps shard
        0, each worker gets its own with the pools' geometry
        (`parallel.mesh.Mesh.open`)."""
        from ..parallel.partition import (gpt_serving_rules,
                                          match_partition_rules,
                                          shard_params)

        specs = match_partition_rules(gpt_serving_rules(), self._params)
        shards = shard_params(self._params, specs, self._mesh_mp)
        self._params = shards[0]
        cfg = dict(layers=self._num_layers, heads=self._local_heads,
                   pages=self.pool.num_pages, page=self._page,
                   head_dim=self._head_dim, eps=self._eps,
                   kv_dtype=_dtype_name(self._k_pages.dtype),
                   kv_quant=self._kv_quant)
        host = [_tree_to(sh, torch.device("cpu")) for sh in shards[1:]]
        self._mesh_shards = self._mesh.open(host, cfg)

    def _kv_gather(self, ids) -> Dict[str, np.ndarray]:
        """Pages ``ids`` of the KV pools (and int8 scales) on the host,
        every head: on a mesh the workers' heads join rank 0's."""
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        out = {"k": self._k_pages.index_select(2, idx).cpu().numpy(),
               "v": self._v_pages.index_select(2, idx).cpu().numpy()}
        if self._kv_quant:
            out["ks"] = self._k_scales.index_select(2, idx).cpu().numpy()
            out["vs"] = self._v_scales.index_select(2, idx).cpu().numpy()
        if self._mesh_shards is not None:
            parts = self._mesh_shards.gather(np.asarray(ids))
            out = {k: np.concatenate([v] + [p[k] for p in parts], axis=1)
                   for k, v in out.items()}
        return out

    def _kv_put(self, ids, arrays: Dict[str, np.ndarray]):
        """Write every head of pages ``ids`` (`_kv_gather`'s layout): on
        a mesh each rank its own heads."""
        n = self._local_heads
        if self._mesh_shards is not None:
            self._mesh_shards.put(np.asarray(ids), [
                {k: v[:, r * n:(r + 1) * n] for k, v in arrays.items()}
                for r in range(1, self._mesh_mp)])
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        for name, dst in (("k", self._k_pages), ("v", self._v_pages),
                          ("ks", self._k_scales), ("vs", self._v_scales)):
            if dst is not None and name in arrays:
                dst.index_copy_(2, idx, torch.from_numpy(
                    np.ascontiguousarray(arrays[name][:, :n])).to(
                        self.device))

    def _init_telemetry(self, flight_window, flight_dir, cost_model,
                        cost_calibration, alerts, profile,
                        profile_sample_steps):
        """Arm the telemetry plane as JAX resolves it (an explicit
        argument wins over its flag), before the journal's config record
        snapshots `wire_config`."""
        # the flight recorder: a bounded ring of per-step records
        # (flight_window=0 turns it off); dumps default beside the journal
        if flight_window is None:
            flight_window = int(_flags.flag("flight_window"))
        if flight_dir is None:
            flight_dir = str(_flags.flag("flight_dir")) or None
        self._flight = None
        if int(flight_window) > 0:
            from ..observability.flight import FlightRecorder

            fdir = flight_dir or (
                os.path.join(self._journal_dir, "flight")
                if self._journal_dir else None)
            self._flight = FlightRecorder(self, window=int(flight_window),
                                          flight_dir=fdir)
        self._ctor["flight_window"] = int(flight_window)
        self._ctor["flight_dir"] = flight_dir
        # the cost observatory; an explicit opt-in against a disabled
        # flag arms profile counting too
        if cost_model is not None and bool(cost_model) and \
                not bool(_flags.flag("cost_model")):
            _costmodel._force_enable()
        if cost_model is None:
            cost_model = bool(_flags.flag("cost_model"))
        self._cost = None
        if bool(cost_model):
            self._cost = _costmodel.CostModel(
                self, calibration=cost_calibration)
        self._cost_admission = self._cost is not None and \
            bool(_flags.flag("sched_cost_admission"))
        self._ctor["cost_model"] = bool(cost_model)
        self._ctor["cost_calibration"] = None
        # the profiling plane
        from ..observability import profiling as _profiling_mod

        if profile is not None and bool(profile) and \
                not bool(_flags.flag("profile")):
            _profiling_mod._force_enable()
        if profile is None:
            profile = bool(_flags.flag("profile"))
        self._profiling = None
        if bool(profile):
            self._profiling = _profiling_mod.Profiler(
                self, sample_steps=profile_sample_steps)
        self._ctor["profile"] = bool(profile)
        self._ctor["profile_sample_steps"] = (
            self._profiling.sample_steps
            if self._profiling is not None else profile_sample_steps)
        # the alert engine: armed by FLAGS_ops_port or an explicit alerts=
        from ..observability import alerts as _alerts_mod

        if alerts is None:
            alerts = int(_flags.flag("ops_port")) != 0
        self._alerts = None
        if alerts is not False and alerts != 0:
            rules = None if alerts is True else alerts
            self._alerts = _alerts_mod.AlertEngine(self, rules=rules)
            self._ctor["alerts"] = tuple(self._alerts.rules)
        else:
            self._ctor["alerts"] = False

    def _phase(self, name: str):
        """Context manager timing a leaf flight-recorder phase (a step
        dispatch, the fetch, cache work); a no-op with the recorder off."""
        fr = self._flight
        return fr.phase(name) if fr is not None else _NULL_CTX

    def _excl_phase(self, name: str):
        """Like `_phase` for the composite host phases (admit, draft,
        emit): recorded exclusive of the leaf phases inside them."""
        fr = self._flight
        return fr.exclusive_phase(name) if fr is not None else _NULL_CTX

    def _model_fingerprint(self) -> bytes:
        """The chain-hash root: the embedding's first row, one qkv row
        per block and the architecture dims (paddle_tpu's scheme)."""
        h = hashlib.blake2b(digest_size=16)
        p = self._params
        h.update(p["wte"][0].float().cpu().numpy().tobytes())
        for row in self._fp_wrows:
            h.update(row)
        h.update(str((tuple(p["wte"].shape), len(p["blocks"]),
                      self._num_heads, self._head_dim,
                      self._page)).encode())
        return h.digest()

    def config_fingerprint(self) -> bytes:
        """Digest of everything that fixes this engine's step signatures
        and numerics: the `_model_fingerprint` weight sample, the
        architecture dims, every shape-determining constructor knob and
        the sampling config, hashed as the JAX package hashes them (its
        dtype strings, its key order), so the same weights and
        configuration give equal digests in both packages and a journal
        can move between them.  Gates `adopt_executables` and
        `durability.restore_from_dir`.  Memoized."""
        if self._config_fp is None:
            h = hashlib.blake2b(digest_size=16)
            p = self._params
            h.update(p["wte"][0].float().cpu().numpy().tobytes())
            for row in self._fp_wrows:
                h.update(row)
            h.update(str((
                tuple(int(d) for d in p["wte"].shape), len(p["blocks"]),
                self._num_heads, self._head_dim, self._eps,
                self._slots, self._max_seq_len, self._page,
                self.pool.num_pages, self._q_max,
                int(self._ctor["prefill_chunk_tokens"]),
                _dtype_name(self._k_pages.dtype),
                tuple(sorted(self._sampling.items())),
                self._spec.k if self._spec else 0,
                self._chunked_cfg)).encode())
            if self._ragged:
                h.update(str(("ragged", self._q_ragged)).encode())
            if self._mesh is not None:
                # folded only when armed, as JAX does: an unsharded
                # engine's digest is the one it always had
                h.update(str(("mesh", self._serve_mesh)).encode())
            if self._weight_quant:
                h.update(str(("serve_weights", "int8")).encode())
            self._config_fp = h.digest()
        return self._config_fp

    def wire_config(self) -> dict:
        """The serializable part of the resolved constructor config, the
        journal's config record: every key is one the JAX engine takes
        too, so either package can rebuild the engine (the model, the
        scheduler, drafter and fault plan, and the device stay with the
        process)."""
        kw = {k: v for k, v in self._ctor.items()
              if k not in ("model", "scheduler", "drafter", "fault_plan",
                           "journal_dir", "device")}
        if kw.get("eos_token_id") is not None:
            kw["eos_token_id"] = int(kw["eos_token_id"])
        if kw.get("alerts"):
            kw["alerts"] = [r.to_wire() for r in kw["alerts"]]
        if self._cost is not None:
            # the LIVE calibration: a rebuilt engine predicts warm
            kw["cost_calibration"] = self._cost.calibration_wire()
        return kw

    def _trackers(self) -> List[_StepGraph]:
        """Every live `_StepGraph` of this engine and its speculative
        decoder: the watchdog's compile detector."""
        ts = [self._decode_fn, self._mixed_fn, self._ragged_fn,
              self._scale_reset_fn, *self._prefill_fns.values()]
        if self._spec is not None:
            ts += self._spec.trackers()
        return [t for t in ts if t is not None]

    def adopt_executables(self, donor) -> int:
        """Graph handoff: take a retired engine's captured step graphs
        instead of capturing them again (`_take_over`), discarding this
        engine's own weights and pools; `resilience.recover` hands over
        through the constructor's ``_adopt`` instead, which allocates
        none.  Only a fresh engine (no step run yet) adopts, only from a
        donor with an equal `config_fingerprint` and graphs to give, and
        never from a donor the watchdog abandoned: its worker may still
        be in a step that writes those pools.  Returns the graphs'
        trackers adopted (``exec_handoffs``); 0 leaves the engine to
        capture its own."""
        fresh = not any(getattr(self, a) is not None
                        for a in self._GRAPH_ATTRS) and \
            not self._prefill_fns and \
            (self._spec is None or self._spec._verify_fn is None)
        has = any(getattr(donor, a) is not None
                  for a in self._GRAPH_ATTRS) or donor._prefill_fns or \
            (self._spec is not None and donor._spec is not None and
             donor._spec._verify_fn is not None)
        if donor is self or donor._abandoned or not fresh or not has or \
                donor._k_pages is None or \
                donor.config_fingerprint() != self.config_fingerprint():
            return 0
        return self._take_over(donor)

    def _take_over(self, donor) -> int:
        """Move ``donor``'s step graphs here with what they read: a graph
        reads the addresses of its engine's weights, pools, scales,
        generator and graph memory.  The pools and scales are zeroed, the
        state a rebuilt engine starts from (stale page contents would
        reach masked attention probabilities), and the donor lets go of
        all of it.  A draft model's graphs are rebuilt at its rebind, as
        the JAX drafter's executables are.  Returns the trackers taken,
        counted as ``exec_handoffs``."""
        for a in self._GRAPH_ATTRS + self._DEVICE_ATTRS:
            setattr(self, a, getattr(donor, a))
        self._prefill_fns = dict(donor._prefill_fns)
        n = sum(getattr(self, a) is not None for a in self._GRAPH_ATTRS) + \
            len(self._prefill_fns)
        if self._spec is not None and donor._spec is not None and \
                donor._spec._verify_fn is not None:
            self._spec._verify_fn = donor._spec._verify_fn
            n += 1
        for t in (self._k_pages, self._v_pages, self._k_scales,
                  self._v_scales):
            if t is not None:
                t.zero_()
        if self._mesh_shards is not None:
            self._mesh_shards.zero()
        donor._release_device_state()
        if n:
            _stats_add(exec_handoffs=n)
        return n

    def _release_device_state(self):
        """Drop this engine's references to its graphs, pools and
        weights (a retired engine: recovery hands them over or lets them
        go, so two recoveries never hold three engines' memory)."""
        self._decode_fn = self._mixed_fn = self._ragged_fn = None
        self._scale_reset_fn = None
        self._prefill_fns = {}
        self._k_pages = self._v_pages = None
        self._k_scales = self._v_scales = None
        self._params = None
        self._mesh_shards = None  # the workers free this engine's shards
        if self._spec is not None:
            self._spec._verify_fn = None

    def _abandon_inflight(self):
        """Watchdog abandonment: a step still running in a worker thread
        must change nothing visible when it returns, since its requests
        now belong to the rebuilt engine.  The journal detaches first
        (the successor owns the directory), the graph memory is marked
        abandoned so the late step launches nothing (`_StepGraph`
        raises before staging), and every slot and the queue clear.  The
        pools stay with this engine: the late worker may still hold
        them, so the successor allocates its own and captures anew.  The
        alert engine evaluates once more and the flight recorder dumps
        its window first: the last consistent look at the engine."""
        self._abandoned = True
        self._graph_memory.abandoned = True
        for t in self._trackers():  # a draft model's graphs too
            t._memory.abandoned = True
        dur, self._durability = self._durability, None
        if dur is not None:
            try:
                dur.close()
            except Exception:
                pass  # best effort: the hung worker may hold the handle
        self._watchdog = None
        if self._alerts is not None:
            try:
                self._alerts.evaluate()
            except Exception:
                pass  # best effort: recovery must not wait on an alert
        fl = self._flight
        if fl is not None:
            fl.event("abandon", step=int(self._step_no))
            fl.end_step()
            try:
                fl.dump("abandoned")
            except Exception:
                pass
        _obs.record_span("engine", "abandoned", _obs.now_ns(), 0,
                         tid=self._engine_id,
                         args={"step": int(self._step_no)})
        from .durability import retire_engine_series

        retire_engine_series(self._engine_id)
        self._by_slot = [None] * self._slots
        self._active = np.zeros(self._slots, bool)
        self._queue.clear()
        self._free_slots = list(range(self._slots))
        heapq.heapify(self._free_slots)

    def decode_stats(self) -> dict:
        """This engine's counters: steps, tokens, mixed_steps,
        prefill_chunks, prefix_hits, prefix_misses, prefix_cached_tokens;
        kv_quant_pages (pages whose scales were reset when handed out)
        and kv_quant_refolds (page-head scales that grew over written
        rows) with int8 pages; weight_quant_mats and
        weight_quant_bytes_saved with int8 weights; ragged_steps; the
        speculative counters spec_steps (rounds), spec_slot_steps (slots
        verified), spec_proposed, spec_accepted, spec_emitted,
        spec_k_shrinks and spec_k_grows, with acceptance_rate and
        mean_accepted_per_step from them as in JAX; and the host wall
        seconds spent in mixed and in decode steps, drafting and
        verifying (each step ends in the token fetch, which waits for the
        device)."""
        out = dict(self._stats)
        out["acceptance_rate"] = out["spec_accepted"] / max(
            out["spec_proposed"], 1)
        out["mean_accepted_per_step"] = out["spec_emitted"] / max(
            out["spec_slot_steps"], 1)
        return out

    def _add(self, **deltas):
        """Add counter deltas to this engine's counters (the keys it
        keeps) and to the process-wide ones (the keys of JAX's schema)."""
        for k, v in deltas.items():
            if k in self._stats:
                self._stats[k] += v
        _stats_add(**{k: v for k, v in deltas.items() if k in _STATS})

    def _observe_step(self, t0_ns: int, dt: float, n_active: int,
                      name: str, extra_args=None, observe_hist=True):
        """Per-step observability: a step span on this engine's trace
        lane, the step-latency histogram (``observe_hist=False`` for a
        speculative round's chunk step, which the round observes), the
        pool and occupancy gauges, and the cached pages the pool
        recycled since the last step.  Nothing on an abandoned
        engine."""
        if self._abandoned:
            return
        args = {"step": self._step_no, "active": n_active}
        if extra_args:
            args.update(extra_args)
        _obs.record_span("engine", name, t0_ns, int(dt * 1e9),
                         tid=self._engine_id, args=args)
        if observe_hist:
            _obs.STEP_SECONDS.observe(dt)
        eid = self._engine_id
        _obs.KV_FREE_PAGES.set(self.pool.free_count, engine=eid)
        _obs.KV_UTIL.set(self.pool.utilization(), engine=eid)
        _obs.SLOT_OCCUPANCY.set(n_active / self._slots, engine=eid)
        _obs.KV_QUANT_BYTES_PER_TOKEN.set(
            self._kv_byte_occupancy()["bytes_per_token"], engine=eid)
        if self._prefix_cache:
            _obs.PREFIX_CACHED_PAGES.set(self.pool.cached_count,
                                         engine=eid)
            d = self.pool.evictions - self._evictions_seen
            if d:
                self._evictions_seen = self.pool.evictions
                self._add(prefix_evictions=d)
                _obs.PREFIX_EVICTIONS.inc(d)

    def _dispatch(self, kind: str, fn, *host):
        """One step dispatch (a graph replay, a capture, or an eager
        step), bracketed by the profiling plane's probe on a sampled
        step.  The probe's events are read after the step's fetch."""
        prof = self._profiling
        if prof is None:
            return fn(*host)
        p = prof.probe_begin(kind, _obs.now_ns())
        if self._mesh_shards is not None:
            # the workers stamp a probed step's end (the chip skew)
            self._mesh_shards.probe = p is not None
        out = fn(*host)
        prof.probe_end(p)
        return out

    def _cost_dims(self, params=None, pages=None, num_heads=None) -> dict:
        """`costmodel.analytical_gpt_cost`'s model dimensions for this
        engine (or a draft model's ``params``, ``pages`` and heads)."""
        p = self._params if params is None else params
        quant = any(k.endswith("_q") for k in p["blocks"][0])
        kv = self._k_pages if pages is None else pages
        return dict(layers=len(p["blocks"]),
                    hidden=int(p["wte"].shape[1]),
                    vocab=int(p["wte"].shape[0]),
                    num_heads=num_heads or self._num_heads,
                    weight_bytes=1 if quant else p["wte"].element_size(),
                    kv_bytes=kv.element_size())

    def _site(self, what: str, fn: str) -> str:
        """The JAX tracker's site label of a step (its ``_q`` variant
        over int8 pages)."""
        return f"{what} ({fn}{'_q' if self._kv_quant else ''})"

    def _tracker(self, step, compile_key, site=None, params=None,
                 pools=None, dims=None) -> _StepGraph:
        """A `_StepGraph` of ``step`` over this engine's weights, pools,
        generator and sampling (or a draft model's ``params`` and
        ``pools``).  Its cost profile's bytes are the analytical GPT
        stream at the call's rows, query width and mean KV length."""
        own = params is None and pools is None
        params = self._params if params is None else params
        kp, vp, kw = (self._k_pages, self._v_pages, self._step_kwargs()) \
            if pools is None else pools
        gen = self._generator
        sampled = self._sampling["sampler"] != "greedy" and pools is None
        dims = self._cost_dims() if dims is None else dims

        def bytes_of(host):
            if compile_key == "prefill_compiles" or \
                    (compile_key == "draft_compiles" and len(host) == 3):
                batch, q = host[0].shape
                kv_len = int(host[1][0])
            else:
                lens = host[1]
                toks = host[2]
                batch = toks.shape[0]
                q = toks.shape[1] if toks.ndim == 2 else 1
                kv_len = int(lens.mean()) + q
            return _costmodel.analytical_gpt_cost(
                batch=batch, q=q, kv_len=max(kv_len, 1),
                **dims)["bytes_accessed"]

        def fn(*inputs):
            return step(params, kp, vp, *inputs, gen, **kw)

        if self._mesh is None or not own:
            return _StepGraph(fn, compile_key, self.device,
                              self._graph_memory, gen if sampled else None,
                              site=site, cost=((params, kp, vp), bytes_of))
        # rank 0 of a sharded step: the ragged step, or a legacy prefill
        kind = {"ragged_compiles": "ragged",
                "prefill_compiles": "prefill"}[compile_key]
        from ..parallel.partition import collective_bytes

        def collective_of(host):
            rows = host[0].size if kind == "prefill" else host[2].size
            return collective_bytes(
                rows=rows, hidden=dims["hidden"], layers=dims["layers"],
                mp=self._mesh_mp, dtype_bytes=params["wte"].element_size(),
                kv_int8=self._kv_quant)

        return _MeshStep(fn, compile_key, self.device, self._graph_memory,
                         self._mesh_shards, kind,
                         generator=gen if sampled else None, site=site,
                         cost=((params, kp, vp, self._serve_mesh), bytes_of,
                               collective_of))

    def _decode_tracker(self) -> _StepGraph:
        if self._decode_fn is None:
            self._decode_fn = self._tracker(
                _gpt_decode_step, "decode_compiles",
                self._site("DecodeEngine decode step", "_gpt_decode_step"))
        return self._decode_fn

    def _mixed_tracker(self) -> _StepGraph:
        if self._mixed_fn is None:
            self._mixed_fn = self._tracker(
                _gpt_mixed_step, "mixed_compiles",
                self._site("DecodeEngine mixed step", "_gpt_mixed_step"))
        return self._mixed_fn

    def _ragged_tracker(self) -> _StepGraph:
        """The ONE step a ragged engine runs for decode rows, prompt
        chunks and verify windows alike (``ragged_compiles``)."""
        if self._ragged_fn is None:
            self._ragged_fn = self._tracker(
                _gpt_ragged_step, "ragged_compiles",
                self._site("DecodeEngine ragged step", "_gpt_ragged_step"))
        return self._ragged_fn

    def _prefill_tracker(self, bucket: int) -> _StepGraph:
        """One prefill graph per prompt bucket: a new bucket is a
        compile, never a retrace, as in JAX."""
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._prefill_fns[bucket] = self._tracker(
                _gpt_prefill, "prefill_compiles",
                self._site(f"DecodeEngine prefill bucket {bucket}",
                           "_gpt_prefill"))
        return fn

    def graph_captures(self) -> int:
        """CUDA graphs this engine and its draft model captured so far (0
        on the CPU and inside `disable_capture`)."""
        fns = [self._decode_fn, self._mixed_fn, self._ragged_fn,
               self._scale_reset_fn, *self._prefill_fns.values()]
        if self._spec is not None:
            fns += self._spec.trackers()
        return sum(f.captures for f in fns if f is not None)

    def _kv_byte_occupancy(self) -> dict:
        """Device bytes the KV pool holds in pages that are not free
        (payload and quant scales), and the storage cost per token."""
        per_page_payload = 2 * self._num_layers * self._num_heads * \
            self._page * self._head_dim * self._k_pages.element_size()
        per_page_scales = 2 * self._num_layers * self._num_heads * 4 \
            if self._kv_quant else 0
        used = self.pool.num_pages - self.pool.free_count
        return {"dtype": str(self._k_pages.dtype).replace("torch.", ""),
                "payload_bytes": used * per_page_payload,
                "scale_bytes": used * per_page_scales,
                "bytes_per_token": (per_page_payload + per_page_scales)
                / self._page}

    # -- live introspection ---------------------------------------------------
    def _snapshot_queue(self) -> List[Request]:
        """Best-effort copy of the admission queue, safe from a
        non-engine thread (a deque mutated mid-iteration raises; the
        retry makes statusz robust instead of crashy)."""
        for _ in range(8):
            try:
                return list(self._queue)
            except RuntimeError:
                continue
        return []

    def statusz(self, flight_records: int = 8) -> dict:
        """Live JSON-serializable state snapshot: queue, slots,
        degraded modes, health, pool/cache occupancy, SLO burn, and
        the last ``flight_records`` flight records.  Callable
        MID-SERVE from any thread — it only reads host state (per-field
        reads are atomic under the GIL, the queue copy retries around
        concurrent mutation, the flight ring is read under its lock,
        and the cost section reports the ledger residue the engine
        thread last published), so a statusz poller can never perturb
        outputs and makes no CUDA call.  The fields are the
        machine-readable form of `statusz_text`; `ServingFrontend
        .debug_dump` wraps both with the frontend's own state."""
        from .durability import _health_state

        now = _obs.now_ns()

        def _req(r: Request, slot=None) -> dict:
            d = {
                "request": r.request_id,
                "state": r.state,
                "priority": r.priority,
                "prompt_len": len(r.prompt_ids),
                "out_tokens": len(r.output_ids) + r._absorbed,
                "max_new": r.max_new_tokens,
                # total generation cap, stable across preemption folds
                # (the fold moves budget into _absorbed one for one)
                "out_cap": r._absorbed + r.max_new_tokens,
                "preemptions": r.preemptions,
            }
            if r.t_enqueue_ns is not None:
                d["age_s"] = round((now - r.t_enqueue_ns) / 1e9, 6)
            if slot is not None:
                d["slot"] = slot
                d["phase"] = "prefill" \
                    if int(self._prefill_pos[slot]) < len(r.prompt_ids) \
                    else "decode"
                d["kv_len"] = int(self._lens[slot])
            burn = r.slo_burn(now)
            if burn:
                d["slo_burn"] = {k: round(v, 4)
                                 for k, v in burn.items()}
            if r.finish_reason is not None:
                d["finish_reason"] = r.finish_reason
            return d

        by_slot = list(self._by_slot)
        res = self._resilience
        pool = self.pool
        out = {
            "engine": self._engine_id,
            "step": int(self._step_no),
            "time_ns": now,
            "health": _health_state.get(self._engine_id, "live"),
            "abandoned": bool(self._abandoned),
            "scheduler": self._scheduler.name,
            "degraded": {"spec_off": bool(res.spec_disabled),
                         "legacy_prefill": bool(res.legacy_mode)},
            "config": {
                "slots": self._slots,
                "max_seq_len": self._max_seq_len,
                "page_size": self._page,
                "chunked_prefill": bool(self._chunked),
                "prefix_cache": bool(self._prefix_cache),
                "kv_quant": self._ctor["kv_quant"],
                "serve_weights": self._ctor["serve_weights"],
                "chunk_budget": int(self._chunk_budget),
                "spec_k": self._spec.k if self._spec is not None else 0,
                "spec_adaptive_k": bool(
                    self._spec.adaptive if self._spec is not None
                    else False),
                "ragged_step": bool(self._ragged),
                "serve_mesh": self._serve_mesh,
                "mesh_devices": self._mesh_mp if self._mesh is not None
                else 1,
                "sampling": dict(self._sampling),
            },
            "queue": [_req(r) for r in self._snapshot_queue()],
            "slots": [_req(r, slot=s) for s, r in enumerate(by_slot)
                      if r is not None],
            "pool": {
                "num_pages": pool.num_pages,
                "free": pool.free_count,
                "reserved": pool.reserved,
                "cached": pool.cached_count,
                "cached_unreferenced": pool.cached_unreferenced_count,
                "utilization": round(pool.utilization(), 4),
                "evictions": pool.evictions,
            },
            "durability": {
                "journal_dir": self._journal_dir,
                "armed": self._durability is not None,
            },
            "watchdog": {
                "armed": self._watchdog is not None,
                "timeout_ms": self._step_timeout_ms,
            },
        }
        fl = self._flight
        if fl is not None:
            out["flight"] = {
                "totals": fl.window_stats(),
                "records": fl.records(flight_records),
            }
        if self._alerts is not None:
            # the alert engine: rule states, firing set, recent
            # transitions — the same dict /alertz serves
            out["alerts"] = self._alerts.snapshot()
        if self._cost is not None:
            # the cost observatory: static profiles, calibration +
            # error tables, roofline peaks, the HBM ledger, and the
            # capacity-headroom estimate a fleet router admits on
            out["cost"] = self._cost.statusz()
        if self._profiling is not None:
            # the profiling plane: probe accounting, capture status,
            # measured device time / MFU drift, hot-op tables — the
            # same dict the /profilez endpoint serves
            out["profiling"] = self._profiling.statusz()
        if self._mesh is not None:
            # the mesh's backend, placement and the rule that chose them
            out["mesh"] = self._mesh.describe()
        return out

    def statusz_text(self, flight_records: int = 4) -> str:
        """Human-readable rendering of `statusz` — the text half of
        the JSON+text introspection surface."""
        z = self.statusz(flight_records=flight_records)
        lines = [
            f"engine {z['engine']} — step {z['step']} — "
            f"health {z['health']}"
            + (" (ABANDONED)" if z["abandoned"] else ""),
            f"scheduler {z['scheduler']} | chunked="
            f"{int(z['config']['chunked_prefill'])} prefix_cache="
            f"{int(z['config']['prefix_cache'])} spec_k="
            f"{z['config']['spec_k']} | degraded: spec_off="
            f"{int(z['degraded']['spec_off'])} legacy="
            f"{int(z['degraded']['legacy_prefill'])}",
            f"pool: {z['pool']['free']}/{z['pool']['num_pages']} free, "
            f"{z['pool']['cached']} cached "
            f"({z['pool']['cached_unreferenced']} reclaimable), "
            f"util {z['pool']['utilization']}, "
            f"{z['pool']['evictions']} evictions",
            f"queue ({len(z['queue'])}):",
        ]
        for q in z["queue"]:
            lines.append(
                f"  req {q['request']} prio {q['priority']} "
                f"age {q.get('age_s', 0):.3f}s "
                f"out {q['out_tokens']}"
                + (f" burn {q['slo_burn']}" if "slo_burn" in q else ""))
        lines.append(f"slots ({len(z['slots'])}/"
                     f"{z['config']['slots']}):")
        for s in z["slots"]:
            lines.append(
                f"  slot {s['slot']} req {s['request']} {s['phase']} "
                f"kv {s['kv_len']} out {s['out_tokens']}/"
                f"{s['out_cap']}"
                + (f" burn {s['slo_burn']}" if "slo_burn" in s else ""))
        fl = z.get("flight")
        if fl:
            t = fl["totals"]
            lines.append(
                f"flight: {t['records']}/{t['window']} records, "
                f"{t['tokens_per_second']:.1f} tok/s over window, "
                f"goodput {t['goodput']}, {t['dumps']} dumps")
            for rec in fl["records"]:
                phases = " ".join(
                    f"{k}={v * 1e3:.2f}ms"
                    for k, v in sorted(rec.get("phases", {}).items()))
                evs = "".join(f" [{e['kind']}]"
                              for e in rec.get("events", []))
                lines.append(
                    f"  step {rec.get('step')} {rec.get('kind')} "
                    f"{rec.get('dur_s', 0) * 1e3:.2f}ms "
                    f"emitted {sum(rec.get('emitted', {}).values())} "
                    f"{phases}{evs}")
        cost = z.get("cost")
        if cost:
            hr = cost["headroom"]
            led = cost["ledger"]
            lines.append(
                f"cost: predicted "
                f"{hr['predicted_step_s'] * 1e3:.2f}ms/step, "
                f"headroom {hr['admissible_slots']} slots, ledger "
                f"{led['attributed_bytes']}B attributed + "
                f"{led['unattributed_bytes']}B unattributed")
        return "\n".join(lines)

    # -- admission ------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=32,
                    eos_token_id=..., priority=None, deadline_ms=None,
                    slo_ttft_ms=None, slo_tpot_ms=None,
                    on_token=None, trace_id=None) -> Request:
        # sentinel default: eos_token_id=None opts out of the engine eos
        req = Request(prompt_ids, max_new_tokens,
                      self._eos if eos_token_id is ... else eos_token_id,
                      priority=priority, deadline_ms=deadline_ms,
                      slo_ttft_ms=slo_ttft_ms, slo_tpot_ms=slo_tpot_ms,
                      on_token=on_token)
        if trace_id is not None:
            req.trace_id = str(trace_id)
        self._validate(req)
        self._enqueue(req)
        return req

    def _validate(self, req: Request):
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(req.prompt_ids) + req.max_new_tokens > self._max_seq_len:
            raise ValueError(
                f"prompt ({len(req.prompt_ids)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq_len "
                f"{self._max_seq_len}")
        if self._pages_for(req.total_kv_tokens()) > self.pool.num_pages:
            raise ValueError(
                "request needs more KV pages than the pool holds")

    def _enqueue(self, req: Request):
        req._engine = self
        req.t_enqueue_ns = _obs.now_ns()
        if req.deadline_ms is not None:
            req._deadline_ns = req.t_enqueue_ns + \
                int(req.deadline_ms * 1e6)
        self._queue.append(req)
        _obs.REQUESTS_ENQUEUED.inc()
        if self._durability is not None:
            self._durability.on_admit(req)

    def admit_restored(self, req: Request, on_token=None) -> Request:
        """Admit a request another engine's journal materialized
        (`durability.adopt_from_dir`): a fresh id in this engine's id
        space, validated like any admission, journaled here under its
        restored identity with its streamed watermark."""
        if req.state == "done":
            raise ValueError(
                "admit_restored takes an in-flight materialized "
                "request, not a finished one")
        self._validate(req)
        req.request_id = next(Request._next_id)
        req.on_token = on_token
        self._enqueue(req)
        if self._durability is not None and req._absorbed + req._emit_gate:
            # the adopted watermark must be durable here too
            self._durability.on_emit(req)
        return req

    # -- fleet export hooks ---------------------------------------------------
    def route_prefix_hashes(self, prompt_ids) -> List[str]:
        """The fleet router's affinity key: hex chain hashes of every
        full page of ``prompt_ids`` under this engine's salt (the digests
        `_probe_prefix` matches, so a router keyed on them lands a
        request where its pages are cached).  Empty when the prefix cache
        is off or the prompt spans no full page."""
        if not self._prefix_cache:
            return []
        return [h.hex() for h in self._prefix_hashes(list(prompt_ids))]

    def journal_info(self) -> Optional[dict]:
        """Where this engine journals (the fleet failover donor surface):
        directory, record count, on-disk bytes, fsync policy; None
        without durability."""
        if self._durability is None:
            return None
        d = self._durability
        try:
            size = os.path.getsize(d.path)
        except OSError:
            size = 0
        return {"dir": d.journal_dir, "path": d.path,
                "records": int(d.seq), "bytes": int(size),
                "fsync": d.fsync}

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self._page)

    def _prefix_hashes(self, prompt_ids) -> List[bytes]:
        page = self._page
        hashes = []
        h = self._model_salt
        for i in range(len(prompt_ids) // page):
            h = _chain_hash(h, prompt_ids[i * page:(i + 1) * page])
            hashes.append(h)
        return hashes

    def _probe_prefix(self, req: Request):
        """Longest page-aligned cached prefix of ``req`` (read-only).
        At least one prompt token is always recomputed — the first
        sampled token needs the last position's logits — so a whole-
        prompt match is capped one page short."""
        if not self._prefix_cache:
            return []
        if req._page_hashes is None:
            req._page_hashes = self._prefix_hashes(req.prompt_ids)
        limit = (len(req.prompt_ids) - 1) // self._page
        hit_pages = []
        for h in req._page_hashes[:limit]:
            p = self.pool.lookup(h)
            if p is None:
                break
            hit_pages.append(p)
        return hit_pages

    def _admit(self):
        """Between-steps admission, delegated to the scheduler
        (`frontend.Scheduler`); every bind goes through `_admit_one`."""
        self._scheduler.schedule()

    def _capacity_ok(self, req: Request, extra_pages: int = 0) -> bool:
        """Would the pool see ``req`` through to completion with
        ``extra_pages`` more pages reclaimable (the pages a preemption
        would free)?  Running requests' pages still to come are
        reserved; hit pages need no allocation but must not count as
        evictable capacity."""
        total_pages = self._pages_for(req.total_kv_tokens())
        hit_pages = self._probe_prefix(req)
        need = total_pages - len(hit_pages)
        avail = self.pool.free_count + \
            self.pool.cached_unreferenced_count + extra_pages - \
            sum(1 for p in hit_pages if self.pool.refcount(p) == 0)
        return avail - self.pool.reserved >= need

    def _admit_one(self, req: Request) -> bool:
        """Admit one queued request if a slot is free and the pool can
        see it through; False leaves it queued."""
        if not self._free_slots or not self._capacity_ok(req):
            return False
        if self._cost_admission and not self._cost.admission_ok(req):
            # FLAGS_sched_cost_admission: the predicted step cost would
            # blow the tightest declared per-token SLO; it stays queued
            return False
        total_pages = self._pages_for(req.total_kv_tokens())
        hit_pages = self._probe_prefix(req)
        if self._queue and self._queue[0] is req:
            self._queue.popleft()
        else:
            self._queue.remove(req)
        slot = heapq.heappop(self._free_slots)
        try:
            if self._chunked:
                self._bind_slot(req, slot, total_pages, hit_pages)
            else:
                self._prefill_into(req, slot, total_pages)
        except PoolExhausted:
            # the pool could not deliver what the capacity probe
            # promised (or the "pool" fault site fired): backpressure
            self._unwind_failed_admit(req, slot)
            return False
        return True

    def _unwind_failed_admit(self, req: Request, slot: int):
        """Roll back a bind that raised `PoolExhausted`: release the
        partial claim, clear the slot, requeue the request at the head."""
        self.pool.release_pages(req.pages)
        req.pages = []
        req.cached_page_count = req.cached_prefix_len = 0
        req.slot = None
        req.state = "queued"
        self._release_slot(slot)
        self._queue.appendleft(req)

    def _stamp_admit(self, req: Request):
        """The admission stamp; a re-admission after a preemption counts
        a resume instead."""
        first = req.t_admit_ns is None
        req.t_admit_ns = _obs.now_ns()
        if not first:
            _stats_add(resumes=1)
            if self._flight is not None:
                self._flight.event("resume", request=req.request_id)
            return
        if req.t_enqueue_ns is not None:
            _obs.REQUEST_QUEUE_WAIT.observe(
                (req.t_admit_ns - req.t_enqueue_ns) / 1e9)
            _obs.record_span("requests", "queued", req.t_enqueue_ns,
                             req.t_admit_ns - req.t_enqueue_ns,
                             tid=req.request_id,
                             args=_req_span_args(req))

    def _alloc_prompt_pages(self, req: Request, slot: int,
                            total_pages: int, hit_pages=()):
        """Map the cached prefix (refcount+1) and allocate fresh pages
        for the rest of the prompt, reserve the decode tail, and point
        the slot's block-table row at them.  May raise `PoolExhausted`
        (organically or at the "pool" fault site)."""
        if self._fault is not None:
            self._resilience.fault_point("pool")
        for p in hit_pages:
            self.pool.ref_page(p)
            req.pages.append(p)
        req.cached_page_count = len(req.pages)
        req.cached_prefix_len = len(req.pages) * self._page
        for _ in range(len(req.pages), self._pages_for(len(req.prompt_ids))):
            req.pages.append(self._alloc_page())
        self.pool.reserved += total_pages - len(req.pages)
        row = np.zeros(self._pages_per_seq, np.int32)
        row[:len(req.pages)] = req.pages
        self._bt[slot] = row

    def _bind_slot(self, req: Request, slot: int, total_pages: int,
                   hit_pages=()):
        """Bind the request to a slot; the next mixed steps feed its
        prompt chunk by chunk, starting at the first token past the
        cached prefix."""
        # alloc before the admit stamp: an unwind must leave the request
        # looking never admitted
        self._alloc_prompt_pages(req, slot, total_pages, hit_pages)
        self._stamp_admit(req)
        req.state = "running"
        req.slot = slot
        self._by_slot[slot] = req
        start = req.cached_prefix_len
        self._lens[slot] = start
        self._last[slot] = 0
        self._prefill_pos[slot] = start
        self._active[slot] = True
        if self._prefix_cache:
            n_probe = (len(req.prompt_ids) - 1) // self._page
            self._add(prefix_hits=len(hit_pages),
                      prefix_misses=n_probe - len(hit_pages),
                      prefix_cached_tokens=start)
            if hit_pages:
                _obs.PREFIX_HITS.inc(len(hit_pages))
            if n_probe > len(hit_pages):
                _obs.PREFIX_MISSES.inc(n_probe - len(hit_pages))
            _obs.PREFIX_CACHED_TOKENS.observe(start)
        if self._spec is not None:
            self._spec.on_admit(slot, req)

    def _prefill_bucket(self, p_len: int) -> int:
        """Power-of-two prompt bucket (floor 16, capped at the horizon),
        so prompt lengths share prefill graphs; a draft model's one-shot
        prefill buckets with this method too."""
        bucket = 16
        while bucket < p_len:
            bucket *= 2
        return min(bucket, self._max_seq_len)

    def _prefill_into(self, req: Request, slot: int, total_pages: int):
        """Legacy admission: allocate the prompt's pages and run its whole
        prompt pass now, between steps (every decoding slot stalls for
        it: ``stalled_decode_steps``), emitting the first token.  A NaN
        sentinel finishes the request as "fault" with nothing emitted."""
        self._alloc_prompt_pages(req, slot, total_pages)
        if self._active.any():
            self._add(stalled_decode_steps=1)
        self._stamp_admit(req)
        p_len = len(req.prompt_ids)
        bucket = self._prefill_bucket(p_len)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :p_len] = req.prompt_ids
        fn = self._prefill_tracker(bucket)
        t0 = time.perf_counter()
        t0_ns = _obs.now_ns()
        self._prefill_no += 1
        self._flush_fresh_scales()
        with self._phase("prefill"):
            out = fn(ids, np.asarray([p_len], np.int32), self._bt[slot])
        tok = int(self._fetch(out)[0])
        self._add(prefill_time_s=time.perf_counter() - t0)
        _obs.record_span("engine", "prefill", t0_ns,
                         _obs.now_ns() - t0_ns, tid=self._engine_id,
                         args=_req_span_args(req, bucket=bucket,
                                             slot=slot))

        req.state = "running"
        req.slot = slot
        self._by_slot[slot] = req
        self._lens[slot] = p_len
        self._prefill_pos[slot] = p_len  # the prompt is consumed whole
        self._last[slot] = max(tok, 0)
        self._active[slot] = True
        if tok < 0:
            # non-finite logits in the prompt pass: quarantine this
            # request only, nothing was emitted
            self._quarantine_slot(slot, "nan_logits")
            return
        self._add(prefills=1, tokens=1)
        self._stamp_first_token(req, prompt_len=p_len, bucket=bucket)
        self._emit(req, [tok])
        if self._spec is not None:
            self._spec.on_admit(slot, req)
        reason = self._done(req, tok)
        if reason:
            self._finish(slot, reason)

    def _release_slot(self, slot: int):
        self._by_slot[slot] = None
        self._active[slot] = False
        self._lens[slot] = 0
        self._last[slot] = 0
        self._bt[slot] = 0
        self._prefill_pos[slot] = 0
        heapq.heappush(self._free_slots, slot)

    def _is_prefilling(self, slot: int) -> bool:
        req = self._by_slot[slot]
        return req is not None and \
            int(self._prefill_pos[slot]) < len(req.prompt_ids)

    def _prefilling_any(self) -> bool:
        return any(self._is_prefilling(s) for s in range(self._slots)
                   if self._active[s])

    # -- finishing ------------------------------------------------------------
    def _done(self, req: Request, tok: int) -> Optional[str]:
        if req.eos_token_id is not None and tok == req.eos_token_id:
            return "eos"
        if len(req.output_ids) >= req.max_new_tokens:
            return "length"
        return None

    def _emit(self, req: Request, toks):
        """Land generated tokens on the request and fire its streaming
        callback: the one place ``output_ids`` grows.  The journal's
        watermark is appended first (write-ahead); ``req._emit_gate``
        holds back tokens an earlier life already streamed.  A callback
        that raises (the "host_callback" site) is recorded on
        ``req.fault_info`` and dropped; generation goes on."""
        req.output_ids.extend(toks)
        if self._flight is not None and toks:
            self._flight.note_emit(req.request_id, len(toks))
        gate = req._emit_gate
        if gate:
            skip = min(gate, len(toks))
            req._emit_gate = gate - skip
            toks = toks[skip:]
        if self._durability is not None:
            self._durability.on_emit(req)
        cb = req.on_token
        if cb is None:
            return
        for t in toks:
            try:
                if self._fault is not None:
                    self._resilience.fault_point("host_callback")
                cb(int(t))
            except Exception as e:  # containment, not policy
                req.on_token = None
                if req.fault_info is None:
                    req.fault_info = FaultInfo(
                        site="host_callback", step=self._step_no,
                        recovered=True, message=str(e))
                break

    def _slo_violation(self, req: Request, kind: str):
        """One SLO miss ("ttft" | "tpot" | "deadline"): accounting only."""
        req.slo_violations.append(kind)
        _stats_add(slo_violations=1)
        _obs.SCHED_SLO_VIOLATIONS.inc(kind=kind)

    def _stamp_first_token(self, req: Request, **span_args):
        """Stamp TTFT once per request (a resumed request keeps its
        stamp), check a declared TTFT target, and record the request's
        prefill span."""
        if req.t_first_token_ns is not None:
            return
        req.t_first_token_ns = _obs.now_ns()
        if req.t_enqueue_ns is not None:
            ttft_s = (req.t_first_token_ns - req.t_enqueue_ns) / 1e9
            _obs.REQUEST_TTFT.observe(ttft_s)
            if req.slo_ttft_ms is not None and \
                    ttft_s * 1e3 > req.slo_ttft_ms:
                self._slo_violation(req, "ttft")
        if req.t_admit_ns is not None:
            _obs.record_span("requests", "prefill", req.t_admit_ns,
                             req.t_first_token_ns - req.t_admit_ns,
                             tid=req.request_id,
                             args=_req_span_args(req, **span_args))

    def _register_prompt_pages(self, req: Request):
        """Prefill complete: content-address every freshly computed full
        prompt page (later writes land past the prompt)."""
        if not self._prefix_cache:
            return
        with self._phase("cache"):
            for i in range(req.cached_page_count, len(req._page_hashes)):
                self.pool.register_page(req.pages[i], req._page_hashes[i])
        req._reg_pages = len(req._page_hashes)

    def _register_generated_pages(self, slot: int, req: Request):
        """With ``cache_generated_pages``: content-address each page of
        generated tokens the moment it fills, extending the prompt's
        chain hash over the decode stream."""
        if not self._cache_generated or not self._prefix_cache or \
                req.t_first_token_ns is None:
            return
        full = int(self._lens[slot]) // self._page
        if full <= req._reg_pages:
            return
        toks = req.prompt_ids + req.output_ids
        hashes = req._page_hashes
        if hashes is None:
            hashes = req._page_hashes = self._prefix_hashes(req.prompt_ids)
        while len(hashes) < full:
            i = len(hashes)
            prev = hashes[-1] if hashes else self._model_salt
            hashes.append(_chain_hash(
                prev, toks[i * self._page:(i + 1) * self._page]))
        with self._phase("cache"):
            for i in range(max(req._reg_pages, req.cached_page_count),
                           full):
                self.pool.register_page(req.pages[i], hashes[i])
        req._reg_pages = full

    def _finish(self, slot: int, reason: str):
        req = self._by_slot[slot]
        self.pool.release_pages(req.pages)
        self.pool.reserved -= max(
            self._pages_for(req.total_kv_tokens()) - len(req.pages), 0)
        req.state = "done"
        req.finish_reason = reason
        req.slot = None
        req.pages = []
        self._release_slot(slot)
        self._add(**{_FINISH_COUNTER[reason]: 1})
        req.t_finish_ns = _obs.now_ns()
        _obs.REQUESTS_FINISHED.inc(reason=reason)
        if self._durability is not None:
            self._durability.on_finish(req)
        # preemption-stable: tokens folded into the replay prompt count
        n_out = len(req.output_ids) + req._absorbed
        if req.t_enqueue_ns is not None:
            _obs.REQUEST_E2E.observe(
                (req.t_finish_ns - req.t_enqueue_ns) / 1e9)
        if req.t_first_token_ns is not None:
            if n_out > 1:
                tpot_s = (req.t_finish_ns - req.t_first_token_ns) / 1e9 \
                    / (n_out - 1)
                _obs.REQUEST_TPOT.observe(tpot_s)
                if reason in ("eos", "length") and \
                        req.slo_tpot_ms is not None and \
                        tpot_s * 1e3 > req.slo_tpot_ms:
                    self._slo_violation(req, "tpot")
            _obs.record_span(
                "requests", "decode", req.t_first_token_ns,
                req.t_finish_ns - req.t_first_token_ns,
                tid=req.request_id,
                args=_req_span_args(req, tokens=n_out,
                                    finish_reason=reason))
        if reason in ("eos", "length") and req._deadline_ns is not None \
                and req.t_finish_ns > req._deadline_ns:
            self._slo_violation(req, "deadline")
        if self._spec is not None:
            self._spec.on_finish(slot, req)
        if self._flight is not None:
            # after the SLO checks: slo_met is final here
            self._flight.note_finish(req)

    def evict(self, req: Request):
        """Cancel a request on the engine's initiative: a queued request
        leaves the queue, a running one gives its slot and pages back;
        ``finish_reason`` reads "evicted"."""
        if req.state == "queued":
            self._retire_queued(req, "evicted")
            return
        if req.state == "running" and req.slot is not None and \
                0 <= req.slot < self._slots and \
                self._by_slot[req.slot] is req:
            self._finish(req.slot, "evicted")
            return
        if req.state == "done":
            return
        raise ValueError("request is not owned by this engine")

    def preempt(self, req: Request):
        """Preempt a running request between steps: release its slot and
        pages and requeue it at the head.  Its generated tokens fold into
        ``prompt_ids`` (``max_new_tokens`` shrinks one for one) and the
        next admission replays them as a prompt; with the prefix cache
        every full page of that replay is registered here first, so the
        resume maps them and recomputes at most one page.  ``on_token``
        only ever sees novel tokens."""
        if req.state != "running" or req.slot is None or \
                self._by_slot[req.slot] is not req:
            raise ValueError(
                f"preempt() is for running requests; this one is "
                f"{req.state!r}")
        slot = req.slot
        total_pages = self._pages_for(req.total_kv_tokens())
        n_gen = len(req.output_ids)
        kv_len = int(self._lens[slot])
        replay_hashes = None
        if self._prefix_cache and req.t_first_token_ns is not None:
            # rows below kv_len are final: their full pages can freeze
            replay_hashes = self._prefix_hashes(
                req.prompt_ids + req.output_ids)
            full = min(kv_len // self._page, len(replay_hashes))
            for i in range(req.cached_page_count, full):
                self.pool.register_page(req.pages[i], replay_hashes[i])
            req._reg_pages = max(req._reg_pages, full)
        req.prompt_ids = req.prompt_ids + req.output_ids
        req.max_new_tokens -= n_gen
        req._absorbed += n_gen
        req.output_ids = []
        req._page_hashes = replay_hashes
        req.preemptions += 1
        self.pool.release_pages(req.pages)
        self.pool.reserved -= max(total_pages - len(req.pages), 0)
        req.pages = []
        req.cached_page_count = 0
        req.cached_prefix_len = 0
        req.slot = None
        req.state = "queued"
        self._release_slot(slot)
        if self._spec is not None:
            self._spec.on_finish(slot, req)
        self._queue.appendleft(req)
        _stats_add(preemptions=1)
        _obs.SCHED_PREEMPTIONS.inc()
        if self._flight is not None:
            self._flight.event("preempt", request=req.request_id,
                               slot=slot, generated=n_gen)
        if req.t_admit_ns is not None:
            _obs.record_span("requests", "preempted", req.t_admit_ns,
                             _obs.now_ns() - req.t_admit_ns,
                             tid=req.request_id,
                             args=_req_span_args(req, generated=n_gen))

    def _cancel_running(self, req: Request):
        if req.state != "running" or req.slot is None or \
                self._by_slot[req.slot] is not req:
            raise ValueError("request is not running on this engine")
        self._finish(req.slot, "cancelled")

    def _retire_queued(self, req: Request, reason: str):
        """Take a queued request out of the queue for good ("evicted",
        "cancelled", "deadline", or "fault" from the bisect quarantine)."""
        try:
            self._queue.remove(req)
        except ValueError:
            raise ValueError(
                "request is not queued on this engine") from None
        req.state = "done"
        req.finish_reason = reason
        req.t_finish_ns = _obs.now_ns()
        _stats_add(**{_FINISH_COUNTER[reason]: 1})
        _obs.REQUESTS_FINISHED.inc(reason=reason)
        if self._durability is not None:
            self._durability.on_finish(req)
        if reason == "deadline":
            _obs.SCHED_DEADLINE_EXPIRED.inc()
        if req.t_enqueue_ns is not None:
            _obs.REQUEST_E2E.observe(
                (req.t_finish_ns - req.t_enqueue_ns) / 1e9)
            _obs.record_span("requests", "queued", req.t_enqueue_ns,
                             req.t_finish_ns - req.t_enqueue_ns,
                             tid=req.request_id,
                             args=_req_span_args(req,
                                                 finish_reason=reason))
        if self._flight is not None:
            self._flight.note_finish(req)

    def _cancel_queued(self, req: Request):
        if req.state != "queued":
            raise ValueError(
                f"cancel() is for still-queued requests; this one is "
                f"{req.state!r} — use DecodeEngine.evict to cancel a "
                f"running request")
        self._retire_queued(req, "cancelled")

    def _quarantine_slot(self, slot: int, site: str, message: str = ""):
        """Containment verdict for one slot: its request finishes
        "fault" with a `FaultInfo`, every other slot keeps serving."""
        req = self._by_slot[slot]
        if req.fault_info is None:
            req.fault_info = FaultInfo(
                site=site, step=self._step_no, recovered=False,
                message=message or "non-finite logits: slot quarantined")
        else:
            req.fault_info.history.append(req.fault_info.site)
            req.fault_info.site = site
            req.fault_info.recovered = False
        _obs.record_span("engine", "quarantine", _obs.now_ns(), 0,
                         tid=self._engine_id,
                         args=_req_span_args(req, slot=slot, site=site))
        if self._flight is not None:
            self._flight.event("quarantine", request=req.request_id,
                               slot=slot, site=site)
        self._finish(slot, "fault")

    def _on_first_token(self, slot: int, req: Request, tok: int) -> bool:
        """The slot's last prompt chunk landed and sampled its first
        token: register its prompt pages and switch it to decoding.  A
        NaN sentinel finishes the slot as "fault" and registers nothing
        (K/V computed under non-finite activations must not be cached)."""
        if tok < 0:
            self._quarantine_slot(slot, "nan_logits")
            return False
        self._register_prompt_pages(req)
        self._emit(req, [tok])
        self._last[slot] = tok
        self._add(prefills=1)
        self._stamp_first_token(req, prompt_len=len(req.prompt_ids),
                                chunks=req.prefill_chunks)
        reason = self._done(req, tok)
        if reason:
            self._finish(slot, reason)
        return True

    def _grow_block_tables(self, writes=None):
        """Ensure pages exist for every KV row the next step writes:
        positions ``lens[slot] .. lens[slot] + writes[slot] - 1`` (one
        row per active slot by default)."""
        with self._phase("cache"):
            if self._fault is not None:
                self._resilience.fault_point("pool")
            for slot in range(self._slots):
                if not self._active[slot]:
                    continue
                req = self._by_slot[slot]
                w = 1 if writes is None else int(writes[slot])
                if w == 0:
                    continue
                pidx = (int(self._lens[slot]) + w - 1) // self._page
                while pidx >= len(req.pages):
                    req.pages.append(self._alloc_page())
                    self.pool.reserved -= 1
                    self._bt[slot, len(req.pages) - 1] = req.pages[-1]

    def _alloc_page(self) -> int:
        """Every page the engine claims comes through here, so that with
        int8 pages its scale entries zero (`_flush_fresh_scales`) before
        any quantized write folds into them: a recycled page's stale
        scale must not change its next owner's quantization."""
        p = self.pool.alloc_page()
        if self._kv_quant:
            self._fresh_pages.append(p)
        return p

    # -- steps ----------------------------------------------------------------
    def _step_kwargs(self):
        kw = dict(num_heads=self._local_heads, head_dim=self._head_dim,
                  eps=self._eps, sampling=self._sampling)
        if self._kv_quant:
            kw.update(k_scales=self._k_scales, v_scales=self._v_scales)
        if self._mesh is not None:
            kw.update(reduce=self._mesh.all_reduce)
        return kw

    def _scale_reset_tracker(self) -> _StepGraph:
        if self._scale_reset_fn is None:
            self._scale_reset_fn = _scale_reset_graph(
                self._k_scales, self._v_scales, self.device,
                self._graph_memory)
        return self._scale_reset_fn

    def _flush_fresh_scales(self):
        """Zero the scale entries of the pages handed out since the last
        step, in the target's pools and a draft model's (they share the
        page ids): one fixed-shape reset each; runs before each step, and
        only with int8 pages."""
        if not self._fresh_pages:
            return
        # an id can repeat (alloc, unwind, alloc): the reset is idempotent
        ids = list(dict.fromkeys(self._fresh_pages))
        self._fresh_pages = []
        buf = np.full(self.pool.num_pages, self.pool.num_pages, np.int64)
        buf[:len(ids)] = ids
        if self._mesh_shards is not None:
            # the workers reset their heads with the next sharded step
            self._mesh_shards.fresh.append(buf)
        with self._phase("cache"):
            self._scale_reset_tracker()(buf)
            if self._spec is not None and \
                    getattr(self._spec.drafter, "_k_scales", None) \
                    is not None:
                self._spec.drafter._scale_reset_tracker()(buf)
        self._add(kv_quant_pages=len(ids))
        _obs.KV_QUANT_PAGES.inc(len(ids))

    def _debug_check_pool(self):
        """FLAGS_kv_pool_debug / FLAGS_sanitize: the full pool audit at a
        step boundary — every live request's page list against the
        pool's free/private/cached partition and refcounts."""
        self.pool.assert_consistent(
            live_pages=[p for r in self._by_slot if r is not None
                        for p in r.pages])

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """A step's packed output on the host (the step's one wait for
        the device, the flight recorder's ``fetch`` phase); with int8
        pages the refold count it carries is counted and dropped.  The
        sanitizer counts each call as a host sync."""
        san = _san.active()
        if san is not None:
            san.count_host_sync()
        fr = self._flight
        if fr is None:
            out = out.cpu().numpy()
        else:
            t0 = time.perf_counter()
            out = out.cpu().numpy()
            fr.add_phase("fetch", time.perf_counter() - t0)
        if self._mesh_shards is not None:
            self._mesh_shards.stamp()
        if self._kv_quant:
            n = int(out[-1].flat[0])
            if n:
                self._add(kv_quant_refolds=n)
                _obs.KV_QUANT_REFOLDS.inc(n)
            out = out[:-1]
        return out

    def _mixed_step(self, decode_rows=True) -> bool:
        """One fused prefill+decode step over the fixed ``[slots, Q_max]``
        batch (``[slots, Q_r]`` through `_gpt_ragged_step` with
        ``ragged_step``).  The step's prompt-token budget splits evenly
        across prefilling slots (remainder to the lower slots), so a
        short prompt next to a long one finishes its prefill without
        queueing behind the long prompt's stream.  ``decode_rows=False``
        (a speculative engine) feeds prompt chunks only: decoding slots
        advance in the round that follows."""
        slots, qmax = self._slots, self._q_max
        width = self._q_ragged if self._ragged else qmax
        tokens = np.zeros((slots, width), np.int32)
        caps = np.zeros(slots, np.int32)
        sample_idx = np.zeros(slots, np.int32)
        sample_mask = np.zeros(slots, bool)
        prefilling = [s for s in range(slots)
                      if self._active[s] and self._is_prefilling(s)]
        budget = self._chunk_budget
        chunk_of = {}
        for i, s in enumerate(prefilling):
            req = self._by_slot[s]
            cur = int(self._prefill_pos[s])
            share = -(-budget // (len(prefilling) - i))  # ceil
            c = min(len(req.prompt_ids) - cur, share, qmax)
            if c == 0:
                continue  # budget spent: the slot waits one step
            budget -= c
            tokens[s, :c] = req.prompt_ids[cur:cur + c]
            caps[s] = c
            chunk_of[s] = c
            if cur + c == len(req.prompt_ids):
                # last chunk: this step samples the first token
                sample_idx[s] = c - 1
                sample_mask[s] = True
        if decode_rows:
            for s in range(slots):
                if self._active[s] and s not in chunk_of and \
                        not self._is_prefilling(s):
                    tokens[s, 0] = self._last[s]
                    caps[s] = 1
                    sample_idx[s] = 0
                    sample_mask[s] = True
        self._grow_block_tables(writes=caps)
        fn = self._ragged_tracker() if self._ragged else self._mixed_tracker()
        if self._fault is not None:
            # before the step: an injected raise leaves nothing half done
            self._resilience.step_fault_point("mixed_step")
        self._step_no += 1
        # the flight phase: a chunk-only step is prompt work ("prefill"),
        # a chunk-carrying full step "mixed", a chunkless one "decode"
        phase_name = "prefill" if not decode_rows else \
            ("mixed" if chunk_of else "decode")
        self._flush_fresh_scales()

        t0 = time.perf_counter()
        t0_ns = _obs.now_ns()
        kind = "ragged" if self._ragged else "mixed"
        if self._ragged:
            # a target at every position: the host picks each slot's
            # span-end row, and keeps NAN_TOKEN where the row faulted
            with RecordEvent("serving.mixed_step"), \
                    self._phase(phase_name):
                out = self._dispatch(kind, fn, self._bt, self._lens,
                                     tokens, caps)
            toks = self._fetch(out)
            toks = np.where(sample_mask, toks[np.arange(slots), sample_idx],
                            0)
        else:
            with RecordEvent("serving.mixed_step"), \
                    self._phase(phase_name):
                out = self._dispatch(kind, fn, self._bt, self._lens, tokens,
                                     caps, sample_idx, sample_mask)
            toks = self._fetch(out)
        dt = time.perf_counter() - t0
        if self._fault is not None:
            toks = self._resilience.corrupt_tokens(
                toks, [s for s in range(slots) if sample_mask[s]])
        n_active = int(self._active.sum())
        if decode_rows:
            self._add(mixed_steps=1, prefill_chunks=len(chunk_of), steps=1,
                      ragged_steps=int(self._ragged), mixed_step_s=dt,
                      decode_time_s=dt, occupancy_sum=n_active / slots,
                      kv_util_sum=self.pool.utilization())
        else:
            # a chunk-only step is prompt work: the round that follows
            # counts the engine step
            self._add(mixed_steps=1, prefill_chunks=len(chunk_of),
                      ragged_steps=int(self._ragged), mixed_step_s=dt,
                      prefill_time_s=dt)
        for c in chunk_of.values():
            _obs.PREFILL_CHUNK_TOKENS.observe(c)
        self._observe_step(t0_ns, dt, n_active, "mixed_step",
                           extra_args={"prefilling": len(chunk_of),
                                       "chunk_tokens": sum(
                                           chunk_of.values())},
                           observe_hist=decode_rows)
        if self._spec is not None and chunk_of:
            self._spec.drafter.ingest_chunks(tokens, caps)

        emitted = 0
        with self._excl_phase("emit"):
            for s in range(slots):
                if not self._active[s]:
                    continue
                req = self._by_slot[s]
                c = chunk_of.get(s)
                if c is not None:
                    self._prefill_pos[s] += c
                    self._lens[s] += c
                    req.prefill_chunks += 1
                    if int(self._prefill_pos[s]) == len(req.prompt_ids):
                        if self._on_first_token(s, req, int(toks[s])):
                            emitted += 1
                elif caps[s] == 1:
                    emitted += self._land_decode_token(s, req,
                                                       int(toks[s]))
        self._add(tokens=emitted)
        return True

    def _land_decode_token(self, slot: int, req: Request, tok: int) -> int:
        """A decoding slot sampled ``tok``: emit it (or finish the slot
        as "fault" on the NaN sentinel).  Returns the tokens emitted."""
        if tok < 0:
            # non-finite logits on this row only: quarantine the slot,
            # never the batch
            self._quarantine_slot(slot, "nan_logits")
            return 0
        self._lens[slot] += 1
        self._last[slot] = tok
        self._emit(req, [tok])
        self._register_generated_pages(slot, req)
        reason = self._done(req, tok)
        if reason:
            self._finish(slot, reason)
        return 1

    def _decode_step(self) -> bool:
        self._grow_block_tables()
        fn = self._decode_tracker()
        if self._fault is not None:
            self._resilience.step_fault_point("decode_step")
        self._step_no += 1
        self._flush_fresh_scales()
        t0 = time.perf_counter()
        t0_ns = _obs.now_ns()
        with RecordEvent("serving.decode_step"), self._phase("decode"):
            out = self._dispatch("decode", fn, self._bt, self._lens,
                                 self._last, self._active)
        toks = self._fetch(out)
        dt = time.perf_counter() - t0
        if self._fault is not None:
            toks = self._resilience.corrupt_tokens(
                toks, [s for s in range(self._slots) if self._active[s]])
        n_active = int(self._active.sum())
        kv_util = self.pool.utilization()  # before the step's finishes
        self._observe_step(t0_ns, dt, n_active, "decode_step")
        emitted = 0
        with self._excl_phase("emit"):
            for slot in range(self._slots):
                if self._active[slot]:
                    emitted += self._land_decode_token(
                        slot, self._by_slot[slot], int(toks[slot]))
        self._add(steps=1, tokens=emitted, decode_step_s=dt,
                  decode_time_s=dt, occupancy_sum=n_active / self._slots,
                  kv_util_sum=kv_util)
        return True

    def step(self) -> bool:
        """Admit what fits (a legacy engine runs each admitted prompt's
        one-shot prefill here), then run one batched step under the
        containment ladder (`resilience.ResilienceManager.run_step`): a
        speculative round with ``spec_decode_k``; else a mixed
        prefill+decode step while any slot is mid-prefill, and a decode
        step otherwise — the ragged step in both cases with
        ``ragged_step``.  Returns False when nothing is left.  A fault
        that survives the ladder raises a fatal `errors.StepFault`; only
        `resilience.recover` goes on from there.  On the card an
        exception the fault plan did not inject leaves here unchanged
        (`resilience.ResilienceManager.contain`).  The journal flushes and
        snapshots at the step boundary, and the watchdog judges the step
        (`durability.StepWatchdog`).  The flight recorder opens a record
        before admission and seals it after the step; the cost model
        predicts the step before it runs and calibrates after; the
        alert engine evaluates between steps.  A fatal fault leaves the
        flight window on disk before it escapes.  Under FLAGS_sanitize
        (or FLAGS_kv_pool_debug alone) the pool is audited first; the
        sanitizer also counts the step."""
        san = _san.active()
        if san is not None:
            san.count_step()
        if san is not None or self._pool_debug:
            self._debug_check_pool()
        fr = self._flight
        if fr is not None:
            fr.begin_step()
        if self._profiling is not None:
            self._profiling.note_step_begin()
        try:
            # "admit" is exclusive of a legacy prefill's leaf phases
            with self._excl_phase("admit"):
                self._admit()
            if not self._abandoned and _obs.enabled():
                # admission pressure, sampled after the admission pass
                eid = self._engine_id
                _obs.QUEUE_DEPTH.set(len(self._queue), engine=eid)
                _obs.QUEUE_OLDEST_AGE.set(
                    (_obs.now_ns() - min(r.t_enqueue_ns
                                         for r in self._queue))
                    / 1e9 if self._queue else 0.0, engine=eid)
            if fr is not None:
                fr.note_batch()
            if self._cost is not None and fr is not None and \
                    self._active.any():
                self._cost.note_step_begin(fr)
            if not self._active.any():
                if self._durability is not None:
                    self._durability.on_step_boundary()
                if fr is not None:
                    fr.end_step(idle=True)
                if self._alerts is not None:
                    self._alerts.maybe_step()
                return bool(self._queue)
            wd = self._watchdog
            if wd is not None:
                wd.arm()
                t0 = time.perf_counter()
            try:
                out = self._resilience.run_step()
                if self._durability is not None:
                    self._durability.on_step_boundary()
            finally:
                if wd is not None:
                    dt = time.perf_counter() - t0
                    wd.disarm()
            if wd is not None and wd.classify(dt):
                # the step completed (its tokens are emitted and
                # journaled) but ran this slow with nothing to excuse
                # it: hand the fatal HungStep to the recovery supervision
                wd.on_hung(dt)
        except StepFault as e:
            # a fault that survived the ladder is escaping: the alerts
            # evaluate and the black box dumps before the supervisor
            # tears this engine down (an abandoned engine dumped already)
            if self._alerts is not None and not self._abandoned:
                try:
                    self._alerts.evaluate()
                except Exception:
                    pass
            if fr is not None and not self._abandoned:
                fr.note_fault(e)
            raise
        if self._profiling is not None:
            self._profiling.note_step_end(fr)
        if fr is not None:
            rec = fr.end_step()
            if self._cost is not None and rec is not None:
                self._cost.observe(rec)
            if self._profiling is not None and rec is not None:
                self._profiling.observe(rec)
        if self._alerts is not None:
            self._alerts.maybe_step()
        return out

    def _step_inner(self) -> bool:
        """One batched step over the admitted batch: the containment
        ladder's unit of retry (`step` wraps it).  ``_step_kind`` records
        the subsystem it runs, "spec", "mixed" (a slot mid-prefill) or
        "decode", before any of its work: the ladder counts a failure
        against it."""
        spec = self._spec is not None and self._resilience.spec_active()
        prefilling = not spec and self._chunked and self._prefilling_any()
        self._step_kind = "spec" if spec else \
            "mixed" if prefilling else "decode"
        if self._fault is not None:
            # a deterministic injected stall: SLO metrics see it
            self._resilience.fault_point("slow_step")
        if spec:
            return self._spec.step()
        if prefilling or self._ragged:
            return self._mixed_step()
        return self._decode_step()

    def run(self, max_steps=100000) -> int:
        """Serve until every queued and running request finishes;
        raises when ``max_steps`` runs out with work pending."""
        steps = 0
        while self._queue or self._active.any():
            if steps >= max_steps:
                raise RuntimeError(
                    f"run(max_steps={max_steps}) exhausted with "
                    f"{len(self._queue)} queued and "
                    f"{int(self._active.sum())} running requests")
            self.step()
            steps += 1
        return steps

    def generate(self, prompts, max_new_tokens=32, return_meta=False):
        """Submit all prompts, serve to completion, return one token
        list per prompt (and, with ``return_meta``, the finish reasons)."""
        reqs = [self.add_request(p, max_new_tokens) for p in prompts]
        self.run()
        outs = [list(r.generated_ids) for r in reqs]
        if return_meta:
            return outs, [r.finish_reason for r in reqs]
        return outs


def _dtype_name(dtype) -> str:
    """A dtype's numpy name ("float32", "int8", "bfloat16"), as the JAX
    package prints it: the fingerprint and the journal's config record
    hash and carry these strings."""
    return str(dtype).replace("torch.", "")


def _tree_to(params: dict, device: torch.device) -> dict:
    def leaf(t):
        return None if t is None else t.detach().to(device)

    out = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: leaf(v) for k, v in b.items()}
                     for b in params["blocks"]]
    return out
