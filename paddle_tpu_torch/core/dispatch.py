"""Eager op checks (counterpart: the eager checks of
paddle_tpu/core/dispatch.py).

The JAX package routes every eager op through ``dispatch``, which also
caches one compiled executable per op signature; eager torch runs each
op directly, so the cache and its ``dispatch_stats`` have no counterpart
(``FLAGS_eager_jit_ops`` and ``FLAGS_eager_cache_size`` keep their
defaults).  What remains are two debug checks after every op, and a
count:

* ``FLAGS_check_nan_inf``: the first op output holding NaN or Inf raises
  ``FloatingPointError`` (JAX's ``_check_nan_inf``; a host sync an op);
* ``FLAGS_benchmark``: the device is synchronized after every op, so a
  host timer around one op reads its device time;
* ``FLAGS_eager_dispatch_report``: calls and wall time of every torch
  op, by the op's name (``dispatch_stats``), printed at exit in the
  column order of the JAX package's ``dispatch_summary_string``.  The
  wall time is the host's: on the card a kernel runs on after its op
  returns, unless ``FLAGS_benchmark`` syncs.  JAX's cache columns (hits,
  misses, bypasses) count its per-op executable cache, which eager torch
  does not have: they read 0.

All three run in one ``torch.overrides.TorchFunctionMode``, entered on the
thread that turns a flag on and left when all are off: with the flags
at their defaults no mode is installed and an op costs nothing extra.
Like JAX's checks, which skip ops under a trace, the mode does nothing
while a CUDA graph is being captured (a sync there is illegal), and
`suspended` takes it off the stack for a capture altogether.
"""
from __future__ import annotations

import atexit
import contextlib
import threading
import time

import torch
from torch.overrides import TorchFunctionMode

from . import flags

__all__ = ["EagerChecks", "sync_mode", "active_mode", "suspended",
           "dispatch_stats", "reset_dispatch_stats",
           "dispatch_summary_string"]


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            if isinstance(o, torch.Tensor):
                yield o


# factories whose output is uninitialized memory, which may hold anything
_UNINITIALIZED = {torch.empty, torch.empty_like, torch.empty_strided,
                  torch.Tensor.new_empty, torch.Tensor.new_empty_strided,
                  torch.Tensor.resize_}


def _check_nan_inf(out, func):
    """Raise on the first floating output holding NaN or Inf.  Skipped:
    uninitialized factories, and views an op returns without writing
    them (a slice, a reshape): their values are the viewed tensor's,
    checked by the op that wrote them."""
    if func in _UNINITIALIZED:
        return
    name = getattr(func, "__name__", repr(func))
    for t in _tensors(out):
        if t._is_view() and not name.endswith("_"):
            continue
        if (t.is_floating_point() or t.is_complex()) and t.numel() and \
                not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"NaN or Inf detected in op output (op={name}, "
                f"shape={list(t.shape)})")


# op name -> [calls, wall seconds], while FLAGS_eager_dispatch_report
_STATS: dict = {}
_STATS_LOCK = threading.Lock()


def _op_name(func) -> str:
    return getattr(func, "__name__", None) or repr(func)


def dispatch_stats(reset=False):
    """``{op: {calls, hits, misses, retraces, bypasses, time_s}}`` under
    the JAX package's keys; the cache counters are 0 (no cache)."""
    with _STATS_LOCK:
        out = {k: {"calls": n, "hits": 0, "misses": 0, "retraces": 0,
                   "bypasses": 0, "time_s": t}
               for k, (n, t) in _STATS.items()}
        if reset:
            _STATS.clear()
    return out


def reset_dispatch_stats():
    with _STATS_LOCK:
        _STATS.clear()


def dispatch_summary_string(sorted_key="time"):
    """The JAX package's dispatch table, its columns in its order."""
    rows = sorted(dispatch_stats().items(),
                  key=lambda kv: -kv[1]["calls" if sorted_key == "calls"
                                        else "time_s"])
    lines = [
        "----------------------  Eager Dispatch Report  "
        "----------------------",
        f"{'Op':<36}{'Calls':>8}{'Hits':>8}{'Miss':>6}{'Bypass':>8}"
        f"{'HitRate':>9}{'Total(ms)':>11}{'Avg(us)':>9}",
    ]
    for name, s in rows:
        cached = s["hits"] + s["misses"]
        hit_rate = s["hits"] / cached if cached else 0.0
        avg_us = s["time_s"] / s["calls"] * 1e6 if s["calls"] else 0.0
        lines.append(
            f"{name:<36}{s['calls']:>8}{s['hits']:>8}{s['misses']:>6}"
            f"{s['bypasses']:>8}{hit_rate:>9.1%}{s['time_s']*1e3:>11.3f}"
            f"{avg_us:>9.1f}")
    return "\n".join(lines)


@atexit.register
def _report_at_exit():
    if _STATS and flags.flag("eager_dispatch_report"):
        print(dispatch_summary_string())


class EagerChecks(TorchFunctionMode):
    """The mode of ``FLAGS_check_nan_inf``, ``FLAGS_benchmark`` and
    ``FLAGS_eager_dispatch_report``: reads the flags after every op and
    does what they ask for."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        count = flags.flag("eager_dispatch_report")
        t0 = time.perf_counter() if count else 0.0
        out = func(*args, **(kwargs or {}))
        if count:
            dt = time.perf_counter() - t0
            name = _op_name(func)
            with _STATS_LOCK:
                st = _STATS.setdefault(name, [0, 0.0])
                st[0] += 1
                st[1] += dt
        if _capturing():
            return out
        if flags.flag("check_nan_inf"):
            _check_nan_inf(out, func)
        if flags.flag("benchmark") and torch.cuda.is_available() and any(
                t.is_cuda for t in _tensors(out)):
            torch.cuda.synchronize()
        return out


_MODE = [None]


def active_mode():
    """The installed `EagerChecks`, or None."""
    return _MODE[0]


def sync_mode():
    """Install the mode when one of its flags is on, remove it when all
    are off (`flags.set_flags` calls this)."""
    want = bool(flags.flag("check_nan_inf") or flags.flag("benchmark")
                or flags.flag("eager_dispatch_report"))
    if want and _MODE[0] is None:
        mode = EagerChecks()
        mode.__enter__()
        _MODE[0] = mode
    elif not want and _MODE[0] is not None:
        mode, _MODE[0] = _MODE[0], None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def suspended():
    """Take the installed mode off the stack for the enclosed code (a
    CUDA-graph capture), and put it back after."""
    mode = _MODE[0]
    if mode is None:
        yield
        return
    _MODE[0] = None
    mode.__exit__(None, None, None)
    try:
        yield
    finally:
        mode.__enter__()
        _MODE[0] = mode
