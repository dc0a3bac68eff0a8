"""Request/step span buffer (counterpart: the span half of
paddle_tpu/observability/tracing.py).

`record_span` appends one completed span to a named track (``engine``:
step, quarantine, degrade, recovery, health spans, one tid per engine).
The clock is ``time.monotonic_ns``: the port has no native host tracer
to share one with, so the chrome-trace merge stays with the ops plane.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .metrics import _state

__all__ = ["now_ns", "record_span", "spans", "clear_spans"]

# a long-lived serving process must not grow its trace without bound
MAX_SPANS = 200_000

_lock = threading.Lock()
_spans: list = []

now_ns = time.monotonic_ns


def record_span(track: str, name: str, start_ns: int, dur_ns: int,
                tid: int = 0, args: Optional[dict] = None):
    """Append one completed span (``args`` plain JSON scalars)."""
    if not _state["enabled"]:
        return
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append((track, name, int(start_ns), int(dur_ns),
                           int(tid), args))


def spans():
    with _lock:
        return list(_spans)


def clear_spans():
    with _lock:
        _spans.clear()
