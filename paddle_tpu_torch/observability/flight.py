"""Serving flight recorder: a bounded, always-cheap ring buffer of
per-step records the decode engine feeds as it serves (counterpart:
paddle_tpu/observability/flight.py, copied, not imported).

When something goes wrong, aggregate counters are not enough evidence.
The flight recorder is the black box: one structured record
per `DecodeEngine.step` holding

* the **batch composition** the step ran over (per-slot request id,
  phase prefill|decode, KV length, output progress);
* the **phase-time breakdown** (`PHASES`): host timers around the
  existing sites, surfaced as the ``paddle_step_phase_seconds{phase}``
  histogram — the measurement prerequisite for the quantized-KV /
  adaptive-speculation density work (a phase you cannot attribute you
  cannot optimize);
* **ladder events** from the containment machinery (retry, degrade,
  quarantine, preempt/resume, recovery, restore, fault, abandon);
* **pool / prefix-cache occupancy** and queue depth at the step
  boundary;
* per-request **SLO burn**: budget consumed vs the declared
  ``slo_ttft_ms`` / ``slo_tpot_ms`` / ``deadline_ms`` while the
  request is live — the ``paddle_slo_burn{engine,kind}`` gauge and the
  ``paddle_slo_burn_exceeded_total{kind}`` leading-indicator counter a
  fleet router can admit against.

On any fatal `StepFault`, hung-step classification, or watchdog
abandonment the window **auto-dumps** crash-safely (tmp + fsync +
``os.replace``, the same discipline as durability snapshots) into
``FLAGS_flight_dir`` — defaulting beside the journal — so every
chaos/recovery event leaves a black box `tools/explain_request.py` can
reconstruct a request timeline from.

Phase disjointness: leaf phases (``prefill`` / ``mixed`` / ``decode`` /
``verify`` device dispatches, ``fetch`` blocking host syncs, ``cache``
page-table growth) are timed directly; composite host phases
(``admit``, ``draft``, ``emit``) are recorded EXCLUSIVE of the leaf
phases nested inside them (`FlightRecorder.exclusive_phase`), so a
step's phases sum to approximately its wall time and the histogram can
be read as a cost breakdown, not a pile of overlapping windows.

Threading: the engine thread is the only writer of the OPEN record
(`add_phase` / `note_batch` / `note_emit` mutate ``_cur`` lock-free —
nobody else ever reads it, which is what keeps the per-step cost in
microseconds), while everything CROSS-THREAD — the sealed-record ring,
the window totals, the open/closed swap itself — happens under the
module's designated ``_lock``: `records` / `snapshot` / `dump` / `DecodeEngine
.statusz` may run on any thread, and sealed records are immutable so
their shallow copies serialize safely.  Metric updates happen OUTSIDE
the lock, so the recorder never nests the observability lock under
its own.

No hook reads a device tensor: `note_batch` and `end_step` read the
engine's host mirrors (``_lens``, ``_prefill_pos``, ``_by_slot``, the
pool's host allocator), so the recorder adds no device sync to a step.
The recorder reads engine state and never mutates it.
"""
from __future__ import annotations

import json
import os
import threading
import weakref
import time
from collections import deque
from typing import List, Optional

from ..analysis.sanitizer import TrackedLock as _TrackedLock
from .metrics import _state

__all__ = ["PHASES", "BURN_KINDS", "FlightRecorder"]

# step-phase attribution vocabulary (the paddle_step_phase_seconds
# label set); see the module docstring for the disjointness contract
PHASES = ("admit", "prefill", "mixed", "decode", "draft", "verify",
          "fetch", "emit", "cache")

# per-request SLO budget kinds (Request.slo_burn)
BURN_KINDS = ("ttft", "tpot", "deadline")

# THE flight-recorder lock: every ring/open-record mutation across all
# recorders in the process happens under it (statusz reads from other
# threads).  An RLock so `_push` can re-assert the guard under a
# caller's hold.
# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
_lock = _TrackedLock(threading.RLock(), "flight._lock")


_obs_mod = None


def _obs():
    # the catalog module (paddle_tpu_torch.observability.__init__) — resolved
    # lazily so this module never participates in the package's import
    # cycle (by the time an engine constructs a recorder the catalog is
    # fully initialized), then cached: the hot path pays one global
    # read, not an import-machinery lookup per step
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod


class _Phase:
    """Plain timed phase: the wall between enter and exit lands on one
    phase of the open record."""

    __slots__ = ("fr", "name", "_t0")

    def __init__(self, fr, name):
        self.fr, self.name = fr, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.fr.add_phase(self.name, time.perf_counter() - self._t0)
        return False


class _ExclusivePhase:
    """Composite host phase: records wall MINUS whatever other phases
    were added inside it, so e.g. ``admit`` never double-counts a
    legacy prefill's device dispatch and ``draft`` never double-counts
    the drafter's blocking fetches."""

    __slots__ = ("fr", "name", "_t0", "_base")

    def __init__(self, fr, name):
        self.fr, self.name = fr, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._base = self.fr._phase_sum()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        inner = self.fr._phase_sum() - self._base
        self.fr.add_phase(self.name, max(0.0, wall - inner))
        return False


class FlightRecorder:
    """One engine's black box: a bounded ring of per-step records plus
    the goodput/throughput/burn accounting derived from them.

    ``window`` bounds the ring (FLAGS_flight_window); ``flight_dir``
    (FLAGS_flight_dir, defaulting beside the journal) is where `dump`
    writes crash-safe window snapshots — None disables auto-dumps while
    the in-memory ring and `statusz` keep working."""

    @property
    def engine(self):
        return self._engine()

    def __init__(self, engine, window: int = 64,
                 flight_dir: Optional[str] = None):
        if window < 1:
            raise ValueError(
                f"flight window must be >= 1 records, got {window}")
        # held weakly: an engine dies by reference counting, with its
        # graphs and pools, while its helpers may outlive it
        self._engine = weakref.ref(engine)
        self.window = int(window)
        self.flight_dir = str(flight_dir) if flight_dir else None
        self._ring: "deque[dict]" = deque()
        self._cur: Optional[dict] = None
        # running window totals (tokens + wall over the ring) so the
        # tokens-per-second gauge is O(1) per step, not O(window)
        self._win_tokens = 0
        self._win_time = 0.0
        # lifetime goodput accounting (finished / finished-with-SLO-met)
        self._fin_total = 0
        self._fin_met = 0
        self.dumps = 0
        # were the burn gauges nonzero last step?  lets a step with no
        # SLO-carrying requests skip three gauge writes instead of
        # re-zeroing every step (they still zero once after the last
        # SLO request leaves)
        self._burn_gauged = False

    # -- writer side (engine thread only) ------------------------------------
    def begin_step(self):
        """Open the step's record (called at the top of
        `DecodeEngine.step`, before admission)."""
        rec = {
            "step": None,  # stamped at end_step (the step increments)
            "t_ns": _obs().now_ns(),
            "_t0": time.perf_counter(),
            "kind": "step",
            "slots": [],
            "queued": 0,
            "phases": {},
            "emitted": {},
            "finished": [],
            "events": [],
        }
        with _lock:
            self._cur = rec

    def note_batch(self):
        """Capture the post-admission batch composition — what the
        device step is about to run over."""
        eng = self.engine
        slots = []
        by_slot = list(eng._by_slot)
        # the host mirrors as Python ints in one conversion each
        prefill_pos = eng._prefill_pos.tolist()
        lens = eng._lens.tolist()
        for s, req in enumerate(by_slot):
            if req is None:
                continue
            p_len = len(req.prompt_ids)
            pos = prefill_pos[s]
            rec = {
                "slot": s,
                "request": req.request_id,
                "phase": "prefill" if pos < p_len else "decode",
                "kv_len": lens[s],
                "prompt_len": p_len,
                "prefill_pos": pos,
                "out": len(req.output_ids) + req._absorbed,
            }
            if getattr(req, "trace_id", None) is not None:
                # fleet trace id (observability.fleettrace): the key
                # explain_request joins donor+adopter flight dumps on
                rec["trace"] = req.trace_id
            slots.append(rec)
        cur = self._cur  # open record: engine-thread-private, no lock
        if cur is None:
            return
        cur["slots"] = slots
        cur["queued"] = len(eng._queue)

    def add_phase(self, name: str, dt: float):
        cur = self._cur  # open record: engine-thread-private, no lock
        if cur is None:
            return
        cur["phases"][name] = cur["phases"].get(name, 0.0) + dt

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def exclusive_phase(self, name: str) -> _ExclusivePhase:
        return _ExclusivePhase(self, name)

    def _phase_sum(self) -> float:
        cur = self._cur  # engine thread is the only writer: plain read
        if cur is None:
            return 0.0
        return sum(cur["phases"].values())

    def note_cost(self, info: dict):
        """Cost-observatory stamp (observability.costmodel): the
        step's PRE-DISPATCH cost prediction lands on the open record;
        `end_step` completes the pair with the measured wall so every
        record carries predicted vs actual."""
        cur = self._cur  # open record: engine-thread-private, no lock
        if cur is None:
            return
        cur["cost"] = dict(info)

    def note_probe(self, info: dict):
        """Profiling-plane stamp (observability.profiling): the step's
        per-executable measured device seconds land on the open
        record; `end_step` completes the device/host split with the
        measured wall so every probed record carries the attribution
        pair (tools/explain_request.py renders the dev=/host=
        column)."""
        cur = self._cur  # open record: engine-thread-private, no lock
        if cur is None:
            return
        cur["probe"] = dict(info)

    def note_emit(self, request_id: int, n: int):
        """`DecodeEngine._emit` chokepoint: ``n`` tokens landed on one
        request this step."""
        cur = self._cur  # open record: engine-thread-private, no lock
        if cur is None:
            return
        em = cur["emitted"]
        em[request_id] = em.get(request_id, 0) + n

    def note_finish(self, req):
        """A request left the engine (any reason) — goodput accounting
        plus the record's finished list."""
        met = bool(req.slo_met)
        with _lock:
            self._fin_total += 1
            if met:
                self._fin_met += 1
            cur = self._cur
            if cur is not None:
                cur["finished"].append([req.request_id,
                                        req.finish_reason])
        if not self.engine._abandoned:
            _obs().ENGINE_GOODPUT.set(self._fin_met / self._fin_total,
                                      engine=self.engine._engine_id)

    def event(self, kind: str, **args):
        """Ladder/lifecycle event (retry, degrade, quarantine, preempt,
        resume, recovery, restore, fault, abandon).  Attached to the
        open step record, or appended to the ring as a standalone
        event record when none is open (recovery runs between steps)."""
        ev = {"kind": kind, **args}
        with _lock:
            cur = self._cur
            if cur is not None:
                cur["events"].append(ev)
                return
            self._push({
                "step": int(self.engine._step_no),
                "t_ns": _obs().now_ns(),
                "kind": "event",
                "events": [ev],
            })

    def _push(self, rec: dict):
        """Append one sealed record, maintaining the running window
        totals (reentrant under a caller's hold — _lock is an RLock)."""
        with _lock:
            self._ring.append(rec)
            self._win_tokens += sum(rec.get("emitted", {}).values())
            self._win_time += rec.get("dur_s", 0.0)
            while len(self._ring) > self.window:
                old = self._ring.popleft()
                self._win_tokens -= sum(old.get("emitted", {}).values())
                self._win_time -= old.get("dur_s", 0.0)

    def end_step(self, idle: bool = False) -> Optional[dict]:
        """Seal the open record: stamp duration, pool/queue occupancy
        and per-request SLO burn, push it into the ring, then observe
        the phase histogram and the throughput/burn gauges.  Returns
        the sealed record (None when no record was open) — the engine
        hands it to the cost observatory, which reads it and never
        mutates it (sealed records are immutable by contract)."""
        eng = self.engine
        now_ns = _obs().now_ns()
        # SLO burn over the live set — computed on the engine thread,
        # so the request fields are between-steps consistent
        burns = {}
        maxes = {}
        crossed: List[str] = []
        try:
            live = [r for r in list(eng._by_slot) if r is not None] + \
                list(eng._queue)
        except RuntimeError:  # pragma: no cover - engine thread only
            live = []
        for r in live:
            if r.slo_ttft_ms is None and r.slo_tpot_ms is None and \
                    r._deadline_ns is None:
                continue  # no declared target: nothing burns
            b = r.slo_burn(now_ns)
            if not b:
                continue
            burns[r.request_id] = {k: round(v, 4) for k, v in b.items()}
            for k, v in b.items():
                if v > maxes.get(k, 0.0):
                    maxes[k] = v
                if v >= 1.0 and k not in r._burn_noted:
                    r._burn_noted.add(k)
                    crossed.append(k)
        pool = eng.pool
        pool_stats = {
            "free": pool.free_count,
            "cached": pool.cached_count,
            "reserved": pool.reserved,
            "utilization": round(pool.utilization(), 4),
            # storage-dtype-aware byte occupancy (FLAGS_kv_quant): a
            # quantized and an fp32 engine at the same page counts
            # show their real device-byte difference per record
            "kv_bytes": eng._kv_byte_occupancy(),
        }
        with _lock:
            rec, self._cur = self._cur, None
            if rec is None:
                return None
            rec["step"] = int(eng._step_no)
            rec["dur_s"] = time.perf_counter() - rec.pop("_t0")
            if idle:
                rec["kind"] = "idle"
            if "cost" in rec:
                # complete the cost observatory's predicted/actual
                # pair BEFORE the record seals (after the push the
                # record is immutable and may serialize concurrently)
                rec["cost"]["actual_s"] = rec["dur_s"]
            if "probe" in rec:
                # complete the profiling plane's device/host split the
                # same way: device seconds were measured at the
                # dispatch sites, the host residue needs the wall
                pr = rec["probe"]
                pr["device_s"] = round(
                    sum(pr.get("device", {}).values()), 9)
                pr["host_s"] = round(
                    max(rec["dur_s"] - pr["device_s"], 0.0), 9)
            rec["queued"] = len(eng._queue)
            rec["pool"] = pool_stats
            if burns:
                rec["burn"] = burns
            self._push(rec)
            win_tokens, win_time = self._win_tokens, self._win_time
        # the decode-stat counts the RECORD (just pushed), so it stays
        # truthful even with the metric registry disabled
        from ..inference.serving import _stats_add

        _stats_add(flight_records=1)
        if not _state["enabled"] or eng._abandoned:
            # an abandoned engine must not repopulate its retired
            # gauges from a late-returning worker thread
            return rec
        obs = _obs()
        obs.STEP_PHASE_SECONDS.observe_batch(
            [({"phase": name}, dt)
             for name, dt in rec["phases"].items()])
        eid = eng._engine_id
        if win_time > 0:
            obs.ENGINE_TOKENS_PER_SECOND.set(win_tokens / win_time,
                                             engine=eid)
        if maxes or self._burn_gauged:
            for k in BURN_KINDS:
                obs.SLO_BURN.set(maxes.get(k, 0.0), engine=eid, kind=k)
        self._burn_gauged = bool(maxes)
        for k in crossed:
            obs.SLO_BURN_EXCEEDED.inc(kind=k)
        return rec

    def note_fault(self, exc: BaseException):
        """A fatal fault is escaping `DecodeEngine.step`: record it,
        seal the open record, and leave the black box on disk.  The
        dump is best-effort — a full disk (or any other dump failure)
        must never REPLACE the `StepFault` the recovery supervision is
        waiting for."""
        self.event("fault", site=getattr(exc, "site", "step"),
                   fatal=bool(getattr(exc, "fatal", False)),
                   error=type(exc).__name__, message=str(exc)[:200])
        self.end_step()
        try:
            self.dump("fault")
        except Exception:
            pass

    # -- reader side (any thread) --------------------------------------------
    def records(self, n: Optional[int] = None) -> List[dict]:
        """The last ``n`` sealed records (all of them by default),
        oldest first.  Sealed records are immutable, so the shallow
        copy is safe to serialize from any thread."""
        with _lock:
            recs = list(self._ring)
        return recs if n is None else recs[-int(n):]

    def window_stats(self) -> dict:
        with _lock:
            return {
                "records": len(self._ring),
                "window": self.window,
                "tokens": self._win_tokens,
                "wall_s": round(self._win_time, 6),
                "tokens_per_second": (self._win_tokens / self._win_time
                                      if self._win_time > 0 else 0.0),
                "finished": self._fin_total,
                "finished_slo_met": self._fin_met,
                "goodput": (self._fin_met / self._fin_total
                            if self._fin_total else None),
                "dumps": self.dumps,
            }

    def snapshot(self, n: Optional[int] = None) -> dict:
        """JSON-serializable window snapshot (what `dump` writes and
        telemetry_dump exports)."""
        out = {
            "flight": 1,  # format version
            "engine": self.engine._engine_id,
            "totals": self.window_stats(),
            "records": self.records(n),
        }
        al = getattr(self.engine, "_alerts", None)
        if al is not None:
            # the alert engine's live state rides every window
            # snapshot, so a crash auto-dump is a post-mortem that
            # SHOWS which alerts were firing at death — not just the
            # raw gauges they were watching
            out["alerts"] = al.snapshot()
        return out

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> Optional[str]:
        """Write the window crash-safely (tmp + fsync + os.replace —
        a crash mid-dump never leaves a torn black box) and return the
        path, or None when no flight_dir is configured and no explicit
        ``path`` given."""
        if path is None:
            if self.flight_dir is None:
                return None
            os.makedirs(self.flight_dir, exist_ok=True)
            path = os.path.join(
                self.flight_dir,
                f"flight_eng{self.engine._engine_id}"
                f"_step{int(self.engine._step_no):06d}_{reason}.json")
        data = self.snapshot()
        data["reason"] = reason
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with _lock:
            self.dumps += 1
        _obs().FLIGHT_DUMPS.inc(reason=reason)
        from ..inference.serving import _stats_add

        _stats_add(flight_dumps=1)
        return path
