"""SLO-aware serving front-end: pluggable admission scheduling and
async streaming over the decode engine (counterpart:
paddle_tpu/inference/frontend.py).

Both halves are host-side control: neither changes a step's shape, so
the zero-warm-retrace contract and greedy parity hold (scheduling
changes when a request runs, never what it emits).

* `FIFOScheduler` (FLAGS_sched_policy="fifo", the default): strict
  arrival order, the bit-exact parity oracle;
* `SLOScheduler` ("slo"): priority class, then earliest deadline, then
  arrival; a never-admitted request past its ``deadline_ms`` retires
  with ``finish_reason="deadline"``; a smaller request may jump a
  capacity-blocked head up to ``hol_skip_limit`` times; a more urgent
  candidate preempts a less urgent running request that has emitted
  ``preempt_min_output`` tokens (resume replays through the prefix
  cache); the per-step prefill budget follows the TPOT histogram.

`ServingFrontend` is the asyncio entry point: ``submit()`` returns a
`TokenStream` fed per token through the engine's ``on_token`` hook, a
background driver task owns the engine (steps run in a worker thread),
submission and stream backpressure bound the buffers, cancellation
reaches queued and running requests, ``close(drain=True)`` serves
everything first, and a fault that survives the containment ladder
rebuilds the engine (`resilience.recover`) with every stream intact.
With the watchdog armed (``step_timeout_ms``) a worker still stuck past
the budget is abandoned and the engine rebuilt from the pre-step
snapshot.  The ops-plane registry and ``debug_dump`` wait for the
telemetry plane.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from .. import observability as _obs
from .serving import _EngineRef

__all__ = ["Scheduler", "FIFOScheduler", "SLOScheduler", "make_scheduler",
           "TokenStream", "ServingFrontend"]


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------
class Scheduler:
    """Owns `DecodeEngine._admit`'s between-steps decision.  Bound to
    exactly one engine (`bind`); per step the engine calls `schedule`,
    which admits queued requests through `DecodeEngine._admit_one` (the
    single place the capacity arithmetic lives) and may retire or
    preempt.  Everything runs on the host between steps — a scheduler
    can never change an executable shape."""

    name = "base"
    engine = _EngineRef()

    def __init__(self):
        self.engine = None

    def bind(self, engine):
        if Scheduler.engine.bound(self) and self.engine is not engine:
            # scheduler state (starvation fences, budget controller) is
            # per-engine; silently rebinding would cross-wire two queues
            raise ValueError(
                "scheduler is already bound to another engine: construct "
                "one scheduler per DecodeEngine")
        self.engine = engine

    def schedule(self):
        raise NotImplementedError


class FIFOScheduler(Scheduler):
    """Strict arrival order, the historical default: admit the queue
    head while it fits, stop at the first that does not.  No expiry, no
    reordering, no preemption — the bit-exact parity oracle for the SLO
    scheduler (greedy outputs and admission order are identical to the
    pre-scheduler engine)."""

    name = "fifo"

    def schedule(self):
        eng = self.engine
        while eng._queue:
            if not eng._admit_one(eng._queue[0]):
                return


class SLOScheduler(Scheduler):
    """Priority + earliest-deadline-first admission with deadline
    expiry, bounded head-of-line skip, preempt/resume, and an adaptive
    prefill chunk budget.  See the module docstring for the policy;
    every decision routes through the engine's existing primitives
    (`_admit_one`, `_retire_queued`, `preempt`), so the capacity
    arithmetic and telemetry stay in one place.

    Knobs:

    * ``hol_skip_limit`` — how many smaller requests may jump a
      capacity-blocked best candidate before admission freezes until
      the blocked request fits (the anti-starvation fence);
    * ``preempt_min_output`` — a running request only becomes a
      preemption victim after emitting this many tokens ("over
      budget": its TTFT is stamped and its replay pages can register
      in the prefix cache, so resume is cheap).  Mid-prefill requests
      are never preempted;
    * ``adapt_chunk_budget`` — steer the engine's per-step prefill
      budget from the live TTFT/TPOT histograms (chunked engines
      only); ``chunk_budget_min`` floors the shrink.
    """

    name = "slo"

    def __init__(self, hol_skip_limit: int = 4,
                 preempt_min_output: int = 1,
                 adapt_chunk_budget: bool = True,
                 chunk_budget_min: int = 8):
        super().__init__()
        if hol_skip_limit < 0:
            raise ValueError(
                f"hol_skip_limit must be >= 0, got {hol_skip_limit}")
        if preempt_min_output < 1:
            # a victim with zero output has no replay to fold and no
            # pages worth caching — preempting it is pure waste
            raise ValueError(
                f"preempt_min_output must be >= 1, got "
                f"{preempt_min_output}")
        if chunk_budget_min < 1:
            raise ValueError(
                f"chunk_budget_min must be >= 1, got {chunk_budget_min}")
        self.hol_skip_limit = int(hol_skip_limit)
        self.preempt_min_output = int(preempt_min_output)
        self.adapt_chunk_budget = bool(adapt_chunk_budget)
        self.chunk_budget_min = int(chunk_budget_min)
        self._base_budget: Optional[int] = None
        # TTFT/TPOT histogram cursors: the adaptive controller reacts
        # to observations SINCE its last look, not the all-time mean
        self._tpot_seen = (0, 0.0)

    def bind(self, engine):
        super().bind(engine)
        if self._base_budget is None:
            self._base_budget = engine._chunk_budget

    @staticmethod
    def _order_key(req):
        # priority class first, earliest deadline inside a class (no
        # deadline sorts last), arrival id as the stable tie-break —
        # request_id survives preemption, so a resumed request keeps
        # its age-derived position inside its class
        return (req.priority,
                req._deadline_ns if req._deadline_ns is not None
                else float("inf"),
                req.request_id)

    def _expire_deadlines(self, now_ns: int):
        """Retire never-admitted requests whose deadline already
        passed — no slot is ever taken for a request that cannot win.
        A RESUMED request (preempted earlier) is exempt: it already
        held a slot, so it runs to completion and a missed deadline is
        recorded as a violation at finish instead."""
        eng = self.engine
        expired = [r for r in eng._queue
                   if r.t_admit_ns is None and r._deadline_ns is not None
                   and now_ns >= r._deadline_ns]
        for r in expired:
            eng._retire_queued(r, "deadline")

    def _pick_victim(self, candidate):
        """Lowest-priority over-budget running request strictly less
        urgent than ``candidate``, or None.  Among equals: the one
        with the most generation left (it would hold the slot longest,
        so preempting it buys the candidate the most), then newest."""
        eng = self.engine
        victims = [r for r in eng._by_slot
                   if r is not None and r.priority > candidate.priority
                   and len(r.output_ids) >= self.preempt_min_output]
        if not victims:
            return None
        return max(victims, key=lambda r: (
            r.priority, r.max_new_tokens - len(r.output_ids),
            r.request_id))

    def _adapt_budget(self):
        """Steer ``engine._chunk_budget`` from the TTFT/TPOT
        histograms: recent TPOT above the tightest declared target of a
        RUNNING request halves the budget (prefill is stealing decode
        latency); recent TPOT comfortably under target — or no target
        at all — with queued prefill work doubles it back toward the
        configured ceiling.  Data-only: caps arrays change, shapes
        never do.

        The signal is the process-global ``paddle_request_tpot_seconds``
        histogram (it carries no engine label), so in a multi-engine
        process another engine's observations blend into the delta —
        conservative for latency (a slow sibling can only SHRINK this
        engine's budget, trading its own TTFT), but per-engine
        steering needs one engine per process today."""
        eng = self.engine
        if not self.adapt_chunk_budget or not eng._chunked:
            return
        st = _obs.REQUEST_TPOT.series_state()
        if st["count"] < self._tpot_seen[0]:
            # the registry was reset since our last look (bench warmup
            # / test fixtures): re-anchor the cursor instead of acting
            # on a negative delta
            self._tpot_seen = (st["count"], st["sum"])
            return
        d_count = st["count"] - self._tpot_seen[0]
        d_sum = st["sum"] - self._tpot_seen[1]
        if d_count <= 0:
            return  # nothing new observed since the last look
        self._tpot_seen = (st["count"], st["sum"])
        recent_tpot_ms = d_sum / d_count * 1e3
        targets = [r.slo_tpot_ms for r in eng._by_slot
                   if r is not None and r.slo_tpot_ms is not None]
        tightest = min(targets) if targets else None
        floor = min(self.chunk_budget_min, self._base_budget)
        if tightest is not None and recent_tpot_ms > tightest:
            eng._chunk_budget = max(floor, eng._chunk_budget // 2)
        elif eng._queue and (tightest is None
                             or recent_tpot_ms < 0.5 * tightest):
            eng._chunk_budget = min(self._base_budget,
                                    eng._chunk_budget * 2)

    def schedule(self):
        eng = self.engine
        now = _obs.now_ns()
        self._expire_deadlines(now)

        # admission sweep: best-first with bounded head-of-line skip.
        # ``blocked`` is the most urgent candidate that did not fit;
        # every later admission jumps it and costs one skip, and once
        # its fence trips nothing may be admitted past it.
        blocked = None
        for req in sorted(eng._queue, key=self._order_key):
            if blocked is not None and \
                    blocked._hol_skips >= self.hol_skip_limit:
                break
            if eng._admit_one(req):
                if blocked is not None:
                    blocked._hol_skips += 1
                continue
            if not eng._free_slots:
                break  # no slot for anyone: skipping cannot help
            if blocked is None:
                blocked = req  # pool-blocked: smaller ones may still fit

        # preemption: the most urgent still-queued candidate may claim
        # a slot from a strictly less urgent over-budget runner.  One
        # victim at a time, re-testing admission after each, so we
        # never preempt more than the candidate actually needs; a
        # freshly preempted victim re-enters the queue and is only
        # reconsidered NEXT step, which breaks preempt/resume ping-pong
        # inside a single pass.
        if eng._queue:
            top = min(eng._queue, key=self._order_key)
            while True:
                victim = self._pick_victim(top)
                if victim is None:
                    break
                # feasibility gate: preempting EVERY eligible victim
                # must be able to admit `top`, else evicting buys
                # nothing — the victims would resume next step, emit a
                # token, and get preempted again (zero-gain thrash).
                # `freeable` counts each victim's full KV budget (its
                # held pages plus its reservation); pages shared with
                # another live request are an overestimate, which the
                # per-iteration re-check corrects as victims run out.
                freeable = sum(
                    eng._pages_for(v.total_kv_tokens())
                    for v in eng._by_slot
                    if v is not None and v.priority > top.priority
                    and len(v.output_ids) >= self.preempt_min_output)
                if not eng._capacity_ok(top, extra_pages=freeable):
                    break
                eng.preempt(victim)
                if eng._admit_one(top):
                    break

        self._adapt_budget()


_SCHEDULERS = {"fifo": FIFOScheduler, "slo": SLOScheduler}


def make_scheduler(spec) -> Scheduler:
    """Resolve a scheduler: an instance passes through, a name
    constructs with defaults (FLAGS_sched_policy supplies the engine's
    default name)."""
    if isinstance(spec, Scheduler):
        return spec
    try:
        return _SCHEDULERS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler {spec!r}: pass one of "
            f"{sorted(_SCHEDULERS)} or a Scheduler instance") from None


# ---------------------------------------------------------------------------
# Async streaming front-end
# ---------------------------------------------------------------------------
_DONE = object()  # end-of-stream sentinel on a TokenStream's queue


class TokenStream:
    """Async iterator over one request's generated tokens, produced by
    `ServingFrontend.submit`.  Iterate to stream; after exhaustion
    ``finish_reason`` / ``generated_ids`` read the request's final
    state.  ``cancel()`` stops the request wherever it is (queued or
    running) — already-buffered tokens still drain, then the stream
    ends with ``finish_reason == "cancelled"``."""

    def __init__(self, frontend: "ServingFrontend", request):
        self.request = request
        self._frontend = frontend
        self._queue: asyncio.Queue = asyncio.Queue()
        self._ended = False

    # -- producer side (driver / engine) ------------------------------------
    def _push(self, item):
        # runs as an event-loop callback (call_soon / _threadsafe):
        # put_nowait on an unbounded queue never raises; boundedness is
        # enforced by the driver pausing between steps (_stream_space)
        self._queue.put_nowait(item)

    # -- consumer side -------------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self._ended:
            raise StopAsyncIteration
        item = await self._queue.get()
        self._frontend._notify_drained()
        if item is _DONE:
            self._ended = True
            raise StopAsyncIteration
        return item

    async def collect(self) -> List[int]:
        """Drain the stream to completion and return every token."""
        return [t async for t in self]

    async def cancel(self):
        """Cancel the underlying request (queued or running) and wait
        for the engine to acknowledge; the stream then ends after any
        already-buffered tokens."""
        await self._frontend._cancel(self.request)

    @property
    def pending(self) -> int:
        """Tokens buffered but not yet consumed."""
        return self._queue.qsize()

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    @property
    def fault_info(self):
        """Structured fault record (`inference.errors.FaultInfo`) when
        the request was quarantined (``finish_reason == "fault"``),
        rode an engine recovery (``recovered=True`` — it still
        finished normally), or had its callback dropped; None for a
        fault-free request.  The stream itself never raises
        mid-iteration for an engine fault: it ends, and the terminal
        state is read here."""
        return self.request.fault_info

    @property
    def generated_ids(self) -> List[int]:
        return self.request.generated_ids


class ServingFrontend:
    """Asyncio front-end over a `DecodeEngine`: a background driver
    task owns the engine (every mutation happens between steps on the
    driver; steps run in a worker thread so the event loop never
    blocks), ``submit()`` returns a per-token `TokenStream`, and
    shutdown drains or cancels cleanly.

    ::

        async with ServingFrontend(engine) as fe:
            stream = await fe.submit(prompt, max_new_tokens=64,
                                     priority=PRIORITY_INTERACTIVE,
                                     slo_ttft_ms=200.0)
            async for tok in stream:
                ...

    Backpressure, two layers:

    * **admission** — ``submit()`` awaits while the engine's queue
      already holds ``max_queue_depth`` requests (offered load beyond
      that waits in the caller, not in the engine);
    * **streaming** — the driver does not start a step while any open
      stream buffers ``stream_buffer`` or more unconsumed tokens (a
      stalled consumer pauses generation between steps; other
      consumers' buffered tokens stay available throughout).

    ``step_in_thread=False`` runs steps inline on the event loop —
    deterministic for tests, but a long step blocks the loop.
    """

    def __init__(self, engine, max_queue_depth: int = 64,
                 stream_buffer: int = 256, step_in_thread: bool = True,
                 max_recoveries: Optional[int] = None):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if stream_buffer < 1:
            raise ValueError(
                f"stream_buffer must be >= 1, got {stream_buffer}")
        self.engine = engine
        self.max_queue_depth = int(max_queue_depth)
        self.stream_buffer = int(stream_buffer)
        self._step_in_thread = bool(step_in_thread)
        # crash recovery budget (None = FLAGS_engine_recoveries): how
        # many times the driver may rebuild a fatally faulted engine
        # (inference.resilience.recover) before giving up and failing
        # the open streams
        self.max_recoveries = max_recoveries
        self._recoveries = 0
        self._streams: dict = {}  # request -> TokenStream (open only)
        self._control: list = []  # (action, payload, future)
        self._wake: Optional[asyncio.Event] = None
        self._drained: Optional[asyncio.Event] = None
        self._driver: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closing = False
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    async def start(self):
        """Start the background driver (idempotent; ``submit`` starts
        it lazily)."""
        if self._closed:
            raise RuntimeError("frontend is closed")
        if self._driver is None:
            self._loop = asyncio.get_running_loop()
            self._wake = asyncio.Event()
            self._drained = asyncio.Event()
            self._driver = asyncio.create_task(self._drive(),
                                               name="serving-frontend")

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb):
        await self.close(drain=exc_type is None)

    async def close(self, drain: bool = True):
        """Stop the front-end.  ``drain=True`` serves every
        outstanding request to completion first; ``drain=False``
        cancels queued and running requests and returns as soon as the
        engine is idle.  Either way every open stream ends."""
        if self._closed:
            return
        if self._driver is None:
            self._closed = True
            return
        self._closing = True  # reject new submissions from here on
        if not drain:
            # submissions still sitting in the control queue never
            # became engine requests — fail them with the same error a
            # post-close submit() gets, instead of letting the driver
            # apply and serve them to completion during a no-drain
            # close
            keep = []
            for action, payload, fut in self._control:
                if action == "submit" and not fut.done():
                    fut.set_exception(RuntimeError(
                        "frontend is closing; no new requests"))
                else:
                    keep.append((action, payload, fut))
            self._control = keep
            for req in list(self._streams):
                if req.state != "done":
                    await self._cancel(req)
        self._kick()
        await self._driver
        self._closed = True

    # -- submission / cancellation -------------------------------------------
    async def submit(self, prompt_ids, max_new_tokens: int = 32,
                     **request_kwargs) -> TokenStream:
        """Submit one request and stream its tokens.  Keyword
        arguments pass through to `DecodeEngine.add_request`
        (``priority``, ``deadline_ms``, ``slo_ttft_ms``,
        ``slo_tpot_ms``, ``eos_token_id``).  Awaits while the admission
        queue is at ``max_queue_depth`` (submission backpressure) and
        raises whatever ``add_request`` would (validation happens on
        the driver, the error surfaces here)."""
        if self._closing or self._closed:
            raise RuntimeError("frontend is closing; no new requests")
        await self.start()
        # the bound counts not-yet-applied submissions too: N concurrent
        # submit() calls race ahead of the driver's next _apply_control
        # pass, and without the pending term they would all read an
        # empty engine queue and overshoot the bound together
        while len(self.engine._queue) + \
                sum(1 for a, _, _ in self._control
                    if a == "submit") >= self.max_queue_depth:
            # a dead driver will never drain the queue — check BEFORE
            # parking on the event (its final wakeup may already have
            # fired, and nothing else will ever set _drained again)
            self._check_driver()
            # bounded admission queue: wait for a step to drain it
            self._drained.clear()
            await self._drained.wait()
            if self._closing or self._closed:
                raise RuntimeError("frontend is closing; no new requests")
        self._check_driver()
        fut = self._loop.create_future()
        self._control.append(
            ("submit", (prompt_ids, max_new_tokens, request_kwargs), fut))
        self._kick()
        return await fut

    async def adopt(self, journal_dir: str,
                    delivered: Optional[Dict[int, int]] = None,
                    traces: Optional[Dict[int, str]] = None) -> dict:
        """Fleet failover entry: replay a dead sibling replica's
        journal (`durability.adopt_from_dir`) into THIS frontend's
        engine, between steps on the driver like any other mutation,
        and open a `TokenStream` per adopted request.  Returns a dict
        keyed by DONOR request id: ``{"stream": TokenStream,
        "request_id": <fresh id>, "start_index": <tokens the consumer
        already holds>, "backfill": [snapshot-known undelivered
        tokens], "done": bool}`` — the edge relays backfill first,
        then drains the stream, and the reconnected consumer sees
        token-for-token continuity.  ``traces`` (optional) maps donor
        ids to fleet trace ids, the `durability.adopt_from_dir`
        fallback for trace-less journals."""
        if self._closing or self._closed:
            raise RuntimeError("frontend is closing; no new requests")
        await self.start()
        self._check_driver()
        fut = self._loop.create_future()
        self._control.append(
            ("adopt", (journal_dir, delivered, traces), fut))
        self._kick()
        return await fut

    async def _cancel(self, req):
        if self._driver is None or self._driver.done() or \
                req.state == "done":
            # a dead/never-started driver already ended every stream
            # (the _drive finally); there is nothing left to cancel
            return
        fut = self._loop.create_future()
        self._control.append(("cancel", req, fut))
        self._kick()
        await fut

    def _kick(self):
        """Wake the driver wherever it sleeps: ``_wake`` covers the
        idle wait, ``_drained`` covers the stream-backpressure pause —
        a control action (submit/cancel/close) must interrupt BOTH, or
        a cancel aimed at the very stream the driver is paused on would
        deadlock."""
        self._wake.set()
        self._drained.set()

    def _check_driver(self):
        """Surface a dead driver instead of queueing work it will
        never apply (its exception re-raises on `close`)."""
        if self._driver is not None and self._driver.done():
            raise RuntimeError(
                "serving frontend driver has exited; no new requests")

    def _notify_drained(self):
        # a consumer took a token: wake a driver paused on stream
        # backpressure (and submitters waiting on the queue bound)
        if self._drained is not None:
            self._drained.set()

    # -- driver --------------------------------------------------------------
    def _apply_control(self):
        """Apply queued submissions/cancellations — engine idle here
        (between steps, on the loop), the only place besides step()
        that mutates the engine."""
        control, self._control = self._control, []
        for action, payload, fut in control:
            if fut.cancelled():
                continue
            try:
                if action == "submit":
                    prompt_ids, max_new_tokens, kwargs = payload
                    stream_box = []

                    def on_token(tok, _box=stream_box,
                                 _loop=self._loop):
                        # engine worker thread -> event loop; MUST NOT
                        # raise into the serve loop (a closed loop can
                        # only mean shutdown mid-step: drop the token)
                        try:
                            _loop.call_soon_threadsafe(
                                _box[0]._push, tok)
                        except RuntimeError:
                            pass
                    req = self.engine.add_request(
                        prompt_ids, max_new_tokens, on_token=on_token,
                        **kwargs)
                    stream = TokenStream(self, req)
                    stream_box.append(stream)
                    self._streams[req] = stream
                    fut.set_result(stream)
                elif action == "adopt":
                    journal_dir, delivered, traces = payload
                    from . import durability

                    boxes: dict = {}

                    def factory(rid, _boxes=boxes, _loop=self._loop):
                        box: list = []
                        _boxes[rid] = box

                        def on_token(tok, _box=box, _loop=_loop):
                            try:
                                _loop.call_soon_threadsafe(
                                    _box[0]._push, tok)
                            except RuntimeError:
                                pass
                        return on_token
                    # admission happens HERE, between steps on the
                    # driver — no step can emit before the stream
                    # boxes below are filled
                    reqs, meta = durability.adopt_from_dir(
                        journal_dir, self.engine, delivered=delivered,
                        on_token_factory=factory, traces=traces)
                    out = {}
                    for rid, req in reqs.items():
                        stream = TokenStream(self, req)
                        if rid in boxes:
                            boxes[rid].append(stream)
                        # done-state adoptees flush a _DONE on the
                        # next _flush_finished pass like any other
                        # terminal request
                        self._streams[req] = stream
                        out[rid] = {"stream": stream, **meta[rid]}
                    fut.set_result(out)
                else:  # cancel
                    payload.cancel()
                    fut.set_result(None)
            except Exception as e:  # surface on the caller, keep driving
                fut.set_exception(e)

    def _flush_finished(self):
        """End the stream of every request that left the engine
        (finished, cancelled, evicted, deadline-expired).  The sentinel
        goes through ``call_soon`` — the same FIFO callback queue the
        worker thread's token pushes land in — so it can never overtake
        a token emitted by the step that just ran."""
        done = [r for r in self._streams if r.state == "done"]
        for req in done:
            stream = self._streams.pop(req)
            self._loop.call_soon(stream._push, _DONE)

    def _stream_space(self) -> bool:
        """False while any open stream's buffer is at the cap — the
        driver must not step again until a consumer drains."""
        return all(s.pending < self.stream_buffer
                   for s in self._streams.values())

    def _has_work(self) -> bool:
        eng = self.engine
        return bool(eng._queue) or bool(eng._active.any())

    def _recover_engine(self, fault, snapshot=None) -> bool:
        """Supervision: a step fault survived the engine's whole
        containment ladder — rebuild the engine
        (`inference.resilience.recover`, which snapshots the dead
        engine's host state: the fatal raise happens at a between-
        steps-consistent boundary, with every emitted token already
        recorded on its request) and keep every open stream alive:
        the same `Request` objects re-admit with their generated
        tokens folded into the replay prompt, so the ``on_token``
        hooks keep feeding the same `TokenStream`s and no already-
        emitted token is ever re-emitted.  The watchdog's abandon path
        passes its PRE-STEP ``snapshot`` instead (the hung worker may
        still hold the engine mid-step, so its live state cannot be
        trusted); tokens emitted past that snapshot are recomputed
        behind the `_emit` gate — streamed once, never twice.  False
        once the recovery budget (``max_recoveries`` /
        FLAGS_engine_recoveries) is spent — the caller lets the fault
        fail the frontend."""
        from ..core import flags as _flags
        from . import resilience

        limit = int(_flags.flag("engine_recoveries")) \
            if self.max_recoveries is None else int(self.max_recoveries)
        if self._recoveries >= limit:
            return False
        self._recoveries += 1
        self.engine = resilience.recover(self.engine, snapshot=snapshot,
                                         fault=fault)
        return True

    async def _drive(self):
        from .errors import StepFault

        try:
            while True:
                self._apply_control()
                self._flush_finished()  # control may cancel/expire
                if not self._has_work():
                    if self._closing and not self._control:
                        break
                    self._wake.clear()
                    if self._control:
                        continue
                    await self._wake.wait()
                    continue
                if not self._closing and not self._stream_space():
                    # a consumer is behind: pause BETWEEN steps until
                    # it drains (or a control action / close kicks the
                    # event).  A draining shutdown skips the pause —
                    # close() must finish even if nobody consumes, so
                    # the buffers may overshoot the cap there.
                    self._drained.clear()
                    if not self._stream_space():
                        await self._drained.wait()
                    continue
                # hung-step watchdog (FLAGS_step_timeout_ms): once the
                # engine is warm, steps run under an abandon timeout —
                # a worker thread still stuck past the budget is
                # ABANDONED (it may never return; awaiting it would
                # hang the whole frontend) and the engine rebuilds from
                # the pre-step snapshot, streams intact.  The snapshot
                # costs one host-state copy per step and exists only
                # while the watchdog is armed.
                wd = self.engine._watchdog
                arm_abandon = wd is not None and self._step_in_thread \
                    and wd.engine_warm()
                pre = None
                if arm_abandon:
                    from .resilience import EngineSnapshot

                    pre = EngineSnapshot(self.engine)
                try:
                    if arm_abandon:
                        pre_sig = wd.sig()
                        loop = asyncio.get_running_loop()
                        fut = loop.run_in_executor(None, self.engine.step)
                        # the abandoned thread's late raise must not
                        # surface as "exception never retrieved"
                        fut.add_done_callback(
                            lambda f: f.cancelled() or f.exception())
                        try:
                            # shield: wait_for must NOT await the
                            # worker's cancellation — an executor job
                            # cannot be interrupted, so awaiting it
                            # would re-introduce the very hang the
                            # watchdog exists to bound
                            await asyncio.wait_for(asyncio.shield(fut),
                                                   wd.timeout_s)
                        except asyncio.TimeoutError:
                            from . import durability
                            from .errors import HungStep

                            if wd.compiled_since(pre_sig):
                                # the worker is capturing a new step
                                # graph (or compiling one): an expected
                                # warmup stall, not a hang: wait it out
                                await asyncio.shield(fut)
                            else:
                                from .serving import _stats_add

                                e = HungStep(
                                    f"step still running after "
                                    f"{wd.timeout_ms:.1f}ms — "
                                    f"abandoning the hung worker")
                                _stats_add(hung_steps=1)
                                self.engine._abandon_inflight()
                                durability.set_health(
                                    self.engine._engine_id, "hung")
                                if self._recover_engine(e, snapshot=pre):
                                    continue
                                raise e
                    elif self._step_in_thread:
                        await asyncio.get_running_loop() \
                            .run_in_executor(None, self.engine.step)
                    else:
                        self.engine.step()
                except StepFault as e:
                    if self._recover_engine(e):
                        continue
                    raise
                self._flush_finished()
                self._notify_drained()  # queue may have drained: wake
                # submitters
        except StepFault as e:
            # an UNRECOVERED fatal step fault (the recovery budget is
            # spent — a recovered one was contained above): mark the
            # terminal state BEFORE the finally ends the streams, so a
            # consumer reads finish_reason="fault" + a structured
            # FaultInfo instead of a silently truncated stream (the
            # exception itself re-raises on close()).  Requests that
            # ever held a slot (running, or preempted back to the
            # queue by the containment ladder) died with the engine; a
            # NEVER-admitted queued request keeps its state — it never
            # entered the engine, only its stream ends — but records
            # the fault context too.  Other exception classes
            # (cancellation, sanitizer invariants, host bugs) fall
            # straight to the finally: fabricating a fault verdict for
            # them would misreport what happened.
            from .errors import FaultInfo

            for req in list(self._streams):
                if req.state == "done":
                    continue  # finished normally before the crash
                if req.fault_info is None:
                    req.fault_info = FaultInfo(
                        site=getattr(e, "site", "engine"),
                        recovered=False,
                        message="serving driver died; engine recovery "
                                "budget exhausted")
                else:
                    req.fault_info.recovered = False
                if req.t_admit_ns is not None:
                    req.state = "done"
                    req.finish_reason = "fault"
            raise
        finally:
            # shutdown — clean (drain mode served everything above;
            # cancel mode already retired them) OR an exception out of
            # step(): either way no caller may be left hanging.  Fail
            # whatever control was never applied, end every open
            # stream, and wake blocked submitters so they observe the
            # dead driver (the exception itself re-raises on close()).
            control, self._control = self._control, []
            for _action, _payload, fut in control:
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "serving frontend driver exited before applying "
                        "this action"))
            self._flush_finished()
            for stream in self._streams.values():
                self._loop.call_soon(stream._push, _DONE)
            self._streams.clear()
            self._notify_drained()
