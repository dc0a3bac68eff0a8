"""Request/step span tracing + merged chrome-trace export (counterpart:
paddle_tpu/observability/tracing.py, copied, not imported).

A Python-side span buffer on named **tracks**, merged into ONE
chrome://tracing JSON:

* track ``host``     — pid 0: the eager profiler's host events
  (``profiler.RecordEvent``, one tid a thread), recorded while
  ``profiler.start_profiler`` has the host tracer on.  The JAX package
  keeps them in its native tracer (csrc); the port's is the bounded,
  lock-guarded buffer below on the same clock as the spans;
* track ``engine``   — decode / prefill / draft / verify step spans and
  ladder markers (one tid per engine instance);
* track ``requests`` — per-request lifecycle spans, one tid per request
  id: ``queued`` (enqueue→admit), ``prefill`` (admit→first token),
  ``decode`` (first token→finish);
* track ``device``   — the profiling plane's measured dispatch spans
  during a capture session (observability.profiling).

Tracks map to chrome-trace *processes* (metadata ``process_name``
events).  The clock is ``time.monotonic_ns``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

import time

from ..analysis.sanitizer import TrackedLock as _TrackedLock
from .metrics import _state

__all__ = ["now_ns", "record_span", "span", "spans", "clear_spans",
           "span_count", "dropped_span_count", "merged_chrome_trace",
           "export_chrome_trace", "HOST_TRACK", "HOST_TRACER",
           "host_record", "host_events", "clear_host_events"]

HOST_TRACK = "host"

# span buffer cap: a long-lived serving process must not grow a trace
# without bound; beyond the cap spans are counted, not stored
MAX_SPANS = 200_000

# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
_lock = _TrackedLock(threading.Lock(), "tracing._lock")
_spans: list = []
_dropped = [0]

now_ns = time.monotonic_ns

_obs_mod = None


def _obs():
    # the catalog module, resolved lazily (the flight.py pattern):
    # tracing is imported while observability/__init__ is still
    # building the catalog, so the counter must bind at runtime
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod


def record_span(track: str, name: str, start_ns: int, dur_ns: int,
                tid: int = 0, args: Optional[dict] = None):
    """Append one completed span to ``track``.  ``args`` must be
    JSON-serializable (plain python scalars)."""
    if not _state["enabled"]:
        return
    with _lock:
        if len(_spans) >= MAX_SPANS:
            _dropped[0] += 1
            dropped = True
        else:
            _spans.append((track, name, int(start_ns), int(dur_ns),
                           int(tid), args))
            dropped = False
    if dropped:
        # the previously-silent overflow, surfaced as a first-class
        # counter (metric update OUTSIDE the lock, per the module's
        # lock discipline)
        _obs().TRACE_SPANS_DROPPED.inc()


class span:
    """RAII span: records ``now_ns`` at entry and the duration at exit."""

    def __init__(self, track: str, name: str, tid: int = 0,
                 args: Optional[dict] = None):
        self.track, self.name, self.tid, self.args = track, name, tid, args

    def __enter__(self):
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        record_span(self.track, self.name, self._t0,
                    now_ns() - self._t0, self.tid, self.args)
        return False


# -- the host tracer ----------------------------------------------------
# the cap of the host event buffer: a profiler left on must not grow it
# without bound; events past the cap are dropped
MAX_HOST_EVENTS = 1_000_000


class _HostTracer:
    """The eager profiler's switch: ``on`` is the one flag a
    ``RecordEvent`` reads when the profiler is off."""
    on = False


HOST_TRACER = _HostTracer()
_host_events: list = []
_host_tids = threading.local()
_host_next_tid = [0]


def _host_tid() -> int:
    tid = getattr(_host_tids, "tid", None)
    if tid is None:
        with _lock:
            tid = _host_tids.tid = _host_next_tid[0]
            _host_next_tid[0] += 1
    return tid


def host_record(name: str, start_ns: int, dur_ns: int):
    """Append one host event (the native tracer's ``Record``): dropped
    unless the host tracer is on."""
    if not HOST_TRACER.on:
        return
    tid = _host_tid()
    with _lock:
        if len(_host_events) < MAX_HOST_EVENTS:
            _host_events.append((name, int(start_ns), int(dur_ns), tid))


def host_events():
    """The host events as ``(name, start_ns, dur_ns, tid)``."""
    with _lock:
        return list(_host_events)


def clear_host_events():
    with _lock:
        _host_events.clear()


def spans():
    with _lock:
        return list(_spans)


def clear_spans():
    with _lock:
        _spans.clear()
        _dropped[0] = 0


def span_count() -> int:
    with _lock:
        return len(_spans)


def dropped_span_count() -> int:
    with _lock:
        return _dropped[0]


def merged_chrome_trace() -> dict:
    """One chrome-trace dict: the host track (pid 0, the host tracer's
    events) + every span track as its own named process."""
    events = [{"ph": "M", "pid": 0, "name": "process_name",
               "args": {"name": HOST_TRACK}}]
    events += [{"name": name, "ph": "X", "pid": 0, "tid": tid,
                "ts": t0 / 1e3, "dur": dur / 1e3}
               for name, t0, dur, tid in host_events()]

    pids = {HOST_TRACK: 0}
    for track, name, t0, dur, tid, args in spans():
        pid = pids.get(track)
        if pid is None:
            pid = pids[track] = len(pids)
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": track}})
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": t0 / 1e3, "dur": dur / 1e3}  # chrome units: us
        if args:
            ev["args"] = args
        events.append(ev)
    return {"traceEvents": events}


def export_chrome_trace(path: str) -> dict:
    """Write the merged timeline to ``path``; returns the trace dict."""
    data = merged_chrome_trace()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)
    return data
