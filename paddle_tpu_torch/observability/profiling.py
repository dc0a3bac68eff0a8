"""Profiling plane: measured device-time attribution, hot-op tables, and
bounded capture sessions (counterpart:
paddle_tpu/observability/profiling.py, copied and adapted, not imported).

* **Sampled device-time probes** — every
  ``FLAGS_profile_sample_steps``-th step (and every step during an
  armed capture) the engine brackets each step dispatch (a CUDA graph
  replay, or an eager step) with two ``torch.cuda.Event``s recorded on
  its stream (`Profiler.probe_begin` / `probe_end`).  The events are
  read after the token fetch the step already waits on
  (`note_step_end`), so a probe adds no sync: where the JAX package
  blocks on the output, the port reads the events' elapsed time.  An
  event is never recorded inside a capture (the engine records around
  the call that captures).  The device seconds feed
  ``paddle_executable_device_seconds{fn}``,
  ``paddle_host_overhead_ratio{engine}``, the measured
  ``paddle_phase_mfu_measured{phase}`` and the predicted-vs-measured
  ``paddle_mfu_drift{phase}`` the ``mfu_regression`` alert rule
  watches.  On an engine the caller put on the CPU, the probe is the
  host clock around the (synchronous) eager step, and `statusz` says
  so (``clock: "host"``); on the card it is never the host clock.
  On a sharded engine (``serve_mesh``) each probed step also yields the
  chip skew, JAX's `_block_and_skew` counterpart: every rank stamps the
  host's monotonic clock (one clock for every process of the host) when
  its step's output is complete — rank 0 after its token fetch, each
  worker after syncing its stream — and the skew is max minus min:
  ``paddle_chip_skew_seconds{engine}`` and `/profilez`'s
  ``chip_skew_seconds``.

* **Hot ops** — the cost observatory's dispatch-mode tally
  (observability.costmodel) keeps each step signature's top-K per-op
  FLOP/byte rows on its profile; K1/K2 appear as one row each with
  their work formula.  `hot_op_table` reads them.

* **Bounded capture sessions** — `request_capture(steps=N)` (any
  thread) arms a capture at the next step boundary on the engine
  thread: for the next N served steps every dispatch is probed and its
  span lands on a ``device`` track in the merged chrome trace, and
  with ``FLAGS_profile_dir`` set the window runs under
  ``torch.profiler`` (CPU and CUDA activity): its chrome trace and the
  merged chrome trace are written into ``<profile_dir>/eng<id>_capture<n>``
  when the session ends.

Arming: ``FLAGS_profile`` (default OFF) or the engine's ``profile=``.
Disarmed, every serve-loop hook is one ``is None`` check.

Threading: the open-step probe state is engine-thread-private; the
capture state and the tables `/profilez` renders mutate under
``_lock``.  The profiler reads engine state and never mutates it.
"""
from __future__ import annotations

import math
import os
import threading
import time
import weakref
from typing import Dict, Optional

from .metrics import _state

__all__ = ["Profiler", "enabled", "hot_op_table", "HOT_OP_TOP_K",
           "request_capture", "capture_status", "profiler_for",
           "deregister"]

_lock = threading.RLock()

# engine_id -> weakref(Profiler)
_PROFILERS: Dict[int, "weakref.ref"] = {}

HOT_OP_TOP_K = 8

_EWMA_ALPHA = 0.25

# the step kinds probes attribute device time to (the cost observatory's
# profile_for vocabulary): the DISPATCHED step, never the flight phase
PROBE_KINDS = ("decode", "mixed", "verify", "ragged")

_obs_mod = None


def _obs():
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod


def _stats_add(**kw):
    from ..inference.serving import _stats_add as add

    add(**kw)


_forced_engines = 0


def _force_enable():
    global _forced_engines
    with _lock:
        _forced_engines += 1


def enabled() -> bool:
    """FLAGS_profile, or any engine constructed with ``profile=True``."""
    if _forced_engines:
        return True
    from ..core import flags as _flags

    return bool(_flags.flag("profile"))


def hot_op_table(tracker) -> tuple:
    """The top-K per-op rows of a step tracker's counted profile (empty
    until its first call was counted)."""
    from . import costmodel

    key = getattr(tracker, "cost_sig", None)
    prof = costmodel.profile_by_key(key) if key is not None else None
    return tuple(prof.hot_ops) if prof is not None else ()


class Profiler:
    """One engine's profiling plane: probe cadence, capture sessions,
    and the measured device-time / MFU-drift tables."""

    @property
    def engine(self):
        return self._engine()

    def __init__(self, engine, sample_steps: Optional[int] = None):
        from ..core import flags as _flags

        # held weakly: an engine dies by reference counting, with its
        # graphs and pools, while its helpers may outlive it
        self._engine = weakref.ref(engine)
        if sample_steps is None:
            sample_steps = int(_flags.flag("profile_sample_steps"))
        self.sample_steps = max(int(sample_steps), 1)
        self.clock = "cuda_event" if engine.device.type == "cuda" \
            else "host"
        # engine-thread-private open-step state
        self._steps = 0
        self._probe_now = False
        self._probe: Optional[Dict[str, float]] = None
        self._open: list = []  # [kind, start, end, t0_ns] of this step
        self._events: list = []  # reusable CUDA events
        self.probes = 0
        self.probe_seconds = 0.0  # host seconds the probes cost
        with _lock:
            self._capture_pending = 0
            self._capture_remaining = 0
            self._capture_total = 0
            self._captures = 0
            self._device_s: Dict[str, dict] = {}
            self._host_ratio: Optional[float] = None
            self._mfu: Dict[str, float] = {}
            self._dev_calib: Dict[str, float] = {}
            self._drift: Dict[str, float] = {}
            # per-rank completion skew of probed sharded steps; None
            # until the first one
            self._skew: Optional[dict] = None
            _PROFILERS[int(engine._engine_id)] = weakref.ref(self)
        self._torch_prof = None
        self._trace_path: Optional[str] = None
        self._pending_sig = None

    # -- capture sessions (any thread arms, engine thread consumes) ----------
    def request_capture(self, steps: int) -> dict:
        steps = int(steps)
        if steps < 1:
            raise ValueError(
                f"capture needs steps >= 1, got {steps}")
        with _lock:
            self._capture_pending = max(self._capture_pending, steps)
        return self.capture_status()

    def capture_status(self) -> dict:
        with _lock:
            return {
                "pending_steps": int(self._capture_pending),
                "remaining_steps": int(self._capture_remaining),
                "capturing": bool(self._capture_remaining > 0),
                "captured_steps": int(self._capture_total),
                "captures_completed": int(self._captures),
                "torch_trace": self._torch_prof is not None,
                "trace_path": self._trace_path,
            }

    def _start_trace(self):
        if self._torch_prof is not None:
            return  # an extended capture keeps its running trace
        from ..core import flags as _flags

        d = str(_flags.flag("profile_dir"))
        if not d:
            return
        import torch

        path = os.path.join(d, f"eng{self.engine._engine_id}"
                               f"_capture{self._captures}")
        os.makedirs(path, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._torch_prof = prof
        with _lock:
            self._trace_path = path

    def _stop_trace(self):
        prof, self._torch_prof = self._torch_prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        path = self._trace_path
        if path is None:
            return
        prof.export_chrome_trace(os.path.join(path, "torch_trace.json"))
        _obs().export_chrome_trace(os.path.join(path, "merged_trace.json"))

    # -- engine-thread hooks (DecodeEngine.step) -----------------------------
    def note_step_begin(self):
        """Between steps, before admission: arm a pending capture and
        decide whether this step probes."""
        self._steps += 1
        if self._capture_pending:
            with _lock:
                pend, self._capture_pending = self._capture_pending, 0
                self._capture_remaining = max(
                    self._capture_remaining, pend)
            self._start_trace()
        capturing = self._capture_remaining > 0
        self._probe_now = capturing or \
            (self._steps % self.sample_steps == 0)
        self._probe = {} if self._probe_now else None
        self._open = []
        self._pending_sig = self._tracker_sig() if self._probe_now \
            else None

    def _tracker_sig(self):
        ts = self.engine._trackers()
        return (len(ts), sum(len(t._seen) for t in ts))

    def _event(self):
        import torch

        return self._events.pop() if self._events else \
            torch.cuda.Event(enable_timing=True)

    def probe_begin(self, kind: str, t0_ns: int):
        """Dispatch site, right before the step's graph replay (or eager
        step): the start of a probe, or None on an unprobed step."""
        if not self._probe_now:
            return None
        p0 = time.perf_counter()
        if self.clock == "cuda_event":
            start = self._event()
            start.record()
        else:
            start = p0
        self.probe_seconds += time.perf_counter() - p0
        return [kind, start, None, t0_ns]

    def probe_end(self, p):
        """Dispatch site, right after the call returned: the end event
        (the host clock on the CPU, where the step ran synchronously)."""
        if p is None:
            return
        p0 = time.perf_counter()
        if self.clock == "cuda_event":
            p[2] = self._event()
            p[2].record()
        else:
            p[2] = p0
        self._open.append(p)
        self.probe_seconds += time.perf_counter() - p0

    def _resolve(self):
        """Device seconds of this step's probes, after its token fetch:
        the end events are complete, so reading them waits for
        nothing."""
        for kind, start, end, t0_ns in self._open:
            if self.clock == "cuda_event":
                if not end.query():  # a fetchless dispatch: not expected
                    end.synchronize()
                dev = start.elapsed_time(end) / 1e3
                self._events += [start, end]
            else:
                dev = end - start
            self._probe[kind] = self._probe.get(kind, 0.0) + dev
            if self._capture_remaining > 0 and _state["enabled"]:
                _obs().record_span(
                    "device", kind, t0_ns, int(dev * 1e9),
                    tid=self.engine._engine_id,
                    args={"step": int(self.engine._step_no),
                          "device_ms": round(dev * 1e3, 4),
                          "clock": self.clock})
        self._open = []

    def note_step_end(self, fr):
        """Engine thread, after the step's fetch and before the flight
        record seals: read the probes, stamp them onto the open record,
        retire one captured step, and refresh the device-time table."""
        probed, self._probe_now = self._probe_now, False
        skew = None
        if probed and self._open:
            p0 = time.perf_counter()
            self._resolve()
            shards = self.engine._mesh_shards
            if shards is not None and shards.probes_sent:
                skew = max(shards.skews())
            self.probe_seconds += time.perf_counter() - p0
        probe, self._probe = self._probe, None
        if self._capture_remaining > 0:
            with _lock:
                self._capture_remaining -= 1
                self._capture_total += 1
                done = self._capture_remaining == 0
                if done:
                    self._captures += 1
            if done:
                self._stop_trace()
                _stats_add(profile_captures=1)
        if not probed or not probe:
            return
        self.probes += 1
        _stats_add(profile_probes=1)
        with _lock:
            for k, v in probe.items():
                e = self._device_s.setdefault(
                    k, {"last_s": 0.0, "total_s": 0.0, "probes": 0})
                e["last_s"] = v
                e["total_s"] += v
                e["probes"] += 1
            if skew is not None:
                if self._skew is None:
                    self._skew = {"last_s": 0.0, "max_s": 0.0,
                                  "total_s": 0.0, "probes": 0}
                self._skew["last_s"] = skew
                self._skew["max_s"] = max(self._skew["max_s"], skew)
                self._skew["total_s"] += skew
                self._skew["probes"] += 1
        if fr is not None:
            pr = {"device": {k: round(v, 9) for k, v in probe.items()}}
            if skew is not None:
                pr["chip_skew_s"] = round(skew, 9)
            fr.note_probe(pr)
        if _state["enabled"] and not self.engine._abandoned:
            obs = _obs()
            for k, v in probe.items():
                obs.EXEC_DEVICE_SECONDS.set(v, fn=k)
            if skew is not None:
                obs.CHIP_SKEW.set(skew, engine=self.engine._engine_id)

    def observe(self, rec: dict) -> None:
        """Score the sealed record's probe against its wall: host
        overhead, measured MFU, and the drift of a device-time
        prediction learned from earlier probes (JAX's arithmetic)."""
        pr = rec.get("probe") if rec.get("kind") == "step" else None
        pending, self._pending_sig = self._pending_sig, None
        if pr is None:
            return
        wall = float(rec.get("dur_s", 0.0))
        dev = float(pr.get("device_s", 0.0))
        if wall <= 0.0 or dev <= 0.0:
            return
        ratio = max(wall - dev, 0.0) / wall
        eng = self.engine
        cost = eng._cost
        calibrate = pending is not None and \
            pending == self._tracker_sig()
        mfus: Dict[str, float] = {}
        samples = []
        if cost is not None:
            for kind, dv in pr.get("device", {}).items():
                if kind not in PROBE_KINDS or dv <= 0.0:
                    continue
                prof = cost.profile_for(kind)
                mfus[kind] = prof.flops / dv / cost.peaks["flops"]
                raw = cost.raw_seconds(prof)
                if calibrate and raw > 0.0:
                    samples.append((kind, raw, dv))
        with _lock:
            self._host_ratio = ratio
            self._mfu.update(mfus)
            for kind, raw, dv in samples:
                sample = dv / raw
                prev = self._dev_calib.get(kind)
                if prev is None:
                    self._dev_calib[kind] = sample
                    continue
                err = abs(raw * prev - dv) / dv
                self._dev_calib[kind] = prev * math.exp(
                    _EWMA_ALPHA * math.log(max(sample, 1e-12) / prev))
                prev_e = self._drift.get(kind)
                self._drift[kind] = err if prev_e is None else \
                    prev_e + _EWMA_ALPHA * (err - prev_e)
            drifts = dict(self._drift)
        if not _state["enabled"] or eng._abandoned:
            return
        obs = _obs()
        obs.HOST_OVERHEAD_RATIO.set(ratio, engine=eng._engine_id)
        for p, v in mfus.items():
            obs.PHASE_MFU_MEASURED.set(v, phase=p)
        for p, v in drifts.items():
            obs.MFU_DRIFT.set(v, phase=p)

    # -- any-thread readers --------------------------------------------------
    def drift_table(self) -> Dict[str, float]:
        with _lock:
            return dict(self._drift)

    def device_table(self) -> Dict[str, dict]:
        with _lock:
            out = {}
            for k, e in self._device_s.items():
                out[k] = {
                    "last_s": e["last_s"],
                    "mean_s": e["total_s"] / max(e["probes"], 1),
                    "probes": e["probes"],
                }
            return out

    def statusz(self) -> dict:
        """The `/profilez` payload: probe config and accounting, capture
        status, the device-time table, measured MFU and drift, and the
        hot-op top-K per profiled step."""
        with _lock:
            host_ratio = self._host_ratio
            mfu = dict(self._mfu)
            drift = dict(self._drift)
            dev_calib = dict(self._dev_calib)
            skew = None
            if self._skew is not None:
                skew = {"last_s": self._skew["last_s"],
                        "max_s": self._skew["max_s"],
                        "mean_s": self._skew["total_s"]
                        / max(self._skew["probes"], 1),
                        "probes": self._skew["probes"]}
        hot = {}
        for t in self.engine._trackers():
            rows = hot_op_table(t)
            if rows:
                hot[t.site] = [dict(r) for r in rows]
        return {
            "engine": self.engine._engine_id,
            "sample_steps": self.sample_steps,
            "clock": self.clock,
            "steps": int(self._steps),
            "probes": int(self.probes),
            "probe_seconds": round(self.probe_seconds, 9),
            "capture": self.capture_status(),
            "device_seconds": self.device_table(),
            "chip_skew_seconds": skew,
            "host_overhead_ratio": host_ratio,
            "mfu_measured": mfu,
            "device_calibration": dev_calib,
            "mfu_drift": drift,
            "hot_ops": hot,
        }


# ---------------------------------------------------------------------------
# the module registry (request_capture / /profilez resolve engines here)
# ---------------------------------------------------------------------------
def profiler_for(engine=None) -> Profiler:
    """Resolve a live `Profiler`: by engine (object or id), or the
    single armed engine in the process; raises when none or several
    qualify."""
    want = None
    if engine is not None:
        want = int(getattr(engine, "_engine_id", engine))
    with _lock:
        items = sorted(_PROFILERS.items())
    live = []
    for eid, ref in items:
        p = ref()
        if p is None:
            continue
        if want is not None and eid == want:
            return p
        live.append((eid, p))
    if want is not None:
        raise ValueError(
            f"no armed profiler for engine {want} "
            f"(have {[e for e, _ in live]})")
    if len(live) == 1:
        return live[0][1]
    raise ValueError(
        f"need an explicit engine: {len(live)} armed profilers "
        f"({[e for e, _ in live]})")


def request_capture(steps: int, engine=None) -> dict:
    if int(steps) < 1:
        raise ValueError(f"capture needs steps >= 1, got {steps}")
    return profiler_for(engine).request_capture(steps)


def capture_status(engine=None) -> dict:
    return profiler_for(engine).capture_status()


def deregister(engine_id: int):
    """A retired engine's profiler leaves the registry, and an
    in-flight capture's trace stops (its engine thread is gone)."""
    with _lock:
        ref = _PROFILERS.pop(int(engine_id), None)
    p = ref() if ref is not None else None
    if p is not None:
        try:
            p._stop_trace()
        except Exception:
            pass
