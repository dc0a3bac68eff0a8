"""Periodic background metrics reporter (counterpart:
paddle_tpu/observability/reporter.py, copied, not imported).

``FLAGS_metrics_report_interval_s > 0`` turns on a daemon thread that
hands a fresh `snapshot()` to a sink every interval — the moral
equivalent of a Prometheus scrape loop for processes nobody scrapes
(benchmarks, soak runs, notebook serving).  The default sink prints a
one-line digest, not the full table, so a forgotten flag cannot flood
stdout; tests and callers pass their own sink for structured
collection.  `DecodeEngine` construction calls `maybe_start_reporter`
so setting the flag is sufficient — no code change at the call site.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from ..analysis.sanitizer import TrackedLock as _TrackedLock
from ..core import flags as _flags
from . import metrics as _metrics

__all__ = ["start_reporter", "stop_reporter", "reporter_running",
           "maybe_start_reporter"]

# a TrackedLock under the JAX package's name, so FLAGS_sanitize
# records acquisition order (analysis.sanitizer)
_lock = _TrackedLock(threading.Lock(), "reporter._lock")
_thread: Optional[threading.Thread] = None
_stop: Optional[threading.Event] = None


def _digest_sink(snap: dict):
    parts = []
    for name in ("paddle_request_ttft_seconds",
                 "paddle_request_tpot_seconds",
                 "paddle_decode_steps_total"):
        m = snap.get(name)
        if not m or not m["series"]:
            continue
        s = m["series"][0]
        if m["type"] == "histogram":
            mean = s["sum"] / s["count"] if s["count"] else 0.0
            parts.append(f"{name}: n={s['count']} mean={mean * 1e3:.2f}ms")
        else:
            parts.append(f"{name}={s['value']}")
    print("[observability] " + (", ".join(parts) or "no series yet"))


def start_reporter(interval_s: Optional[float] = None,
                   sink: Optional[Callable[[dict], None]] = None,
                   registry=None) -> bool:
    """Start the reporter thread.  ``interval_s`` defaults to
    ``FLAGS_metrics_report_interval_s``; <= 0 means "off" and returns
    False.  Idempotent: a running reporter is left alone."""
    if interval_s is None:
        interval_s = float(_flags.flag("metrics_report_interval_s"))
    if interval_s <= 0:
        return False
    sink = sink or _digest_sink
    reg = registry or _metrics.default_registry()
    global _thread, _stop
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        stop = threading.Event()

        def run():
            while not stop.wait(interval_s):
                try:
                    sink(reg.snapshot())
                except Exception:
                    # a broken sink must not kill telemetry collection
                    # for the rest of the process
                    pass

        t = threading.Thread(target=run, name="paddle-metrics-reporter",
                             daemon=True)
        _thread, _stop = t, stop
        t.start()
        return True


def stop_reporter():
    global _thread, _stop
    with _lock:
        t, stop = _thread, _stop
        _thread = _stop = None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=5)


def reporter_running() -> bool:
    with _lock:
        return _thread is not None and _thread.is_alive()


def maybe_start_reporter():
    """Flag-gated autostart (engine construction calls this): no-op
    unless FLAGS_metrics_report_interval_s > 0."""
    try:
        return start_reporter()
    except KeyError:  # flag registry not populated (early import)
        return False
