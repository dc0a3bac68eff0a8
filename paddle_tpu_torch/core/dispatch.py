"""Eager op checks (counterpart: the eager checks of
paddle_tpu/core/dispatch.py).

The JAX package routes every eager op through ``dispatch``, which also
caches one compiled executable per op signature; eager torch runs each
op directly, so the cache and its ``dispatch_stats`` have no counterpart
(``FLAGS_eager_jit_ops`` and ``FLAGS_eager_cache_size`` keep their
defaults).  What remains are two debug checks after every op:

* ``FLAGS_check_nan_inf``: the first op output holding NaN or Inf raises
  ``FloatingPointError`` (JAX's ``_check_nan_inf``; a host sync an op);
* ``FLAGS_benchmark``: the device is synchronized after every op, so a
  host timer around one op reads its device time.

Both run in one ``torch.overrides.TorchFunctionMode``, entered on the
thread that turns a flag on and left when both are off: with the flags
at their defaults no mode is installed and an op costs nothing extra.
Like JAX's checks, which skip ops under a trace, the mode does nothing
while a CUDA graph is being captured (a sync there is illegal), and
`suspended` takes it off the stack for a capture altogether.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from . import flags

__all__ = ["EagerChecks", "sync_mode", "active_mode", "suspended"]


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


class EagerChecks(TorchFunctionMode):
    """The mode of ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark``: reads
    both flags after every op and checks what they ask for."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
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
    """Install the mode when a check's flag is on, remove it when both
    are off (`flags.set_flags` calls this)."""
    want = bool(flags.flag("check_nan_inf") or flags.flag("benchmark"))
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
