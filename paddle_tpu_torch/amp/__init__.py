"""Automatic mixed precision (counterpart: paddle_tpu/amp and the cast
rule of paddle_tpu/core/dispatch.py).

`auto_cast` is a context that the port's functionals read, with
paddle_tpu's own op lists: a WHITE op (`linear`, `matmul`,
`scaled_dot_product_attention`) casts its float inputs to the autocast
dtype, a BLACK op casts half-precision inputs to f32, any other op runs
in its inputs' dtypes.  It is not ``torch.autocast``, whose lists differ:
it would, for one, run ``cross_entropy`` in f32 and build the f32 logits
that the port's hard-label loss avoids.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["WHITE", "BLACK", "auto_cast", "is_auto_cast_enabled",
           "amp_state", "cast_inputs"]

WHITE = "white"
BLACK = "black"

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_state = threading.local()


def amp_state():
    """``(enabled, dtype)`` of this thread's innermost `auto_cast`."""
    return getattr(_state, "enabled", False), getattr(_state, "dtype", None)


@contextlib.contextmanager
def auto_cast(enable=True, dtype="bfloat16"):
    """Run the enclosed functionals under the WHITE/BLACK cast rule, with
    ``dtype`` ("bfloat16" or "float16") as the autocast dtype."""
    prev = amp_state()
    _state.enabled, _state.dtype = bool(enable), _DTYPES[dtype]
    try:
        yield
    finally:
        _state.enabled, _state.dtype = prev


def is_auto_cast_enabled() -> bool:
    return amp_state()[0]


def cast_inputs(policy, *tensors):
    """The tensors as an op of ``policy`` (WHITE, BLACK or None) sees them
    under the current `auto_cast`; ``None`` entries pass through."""
    enabled, target = amp_state()
    if not enabled or policy is None:
        return tensors
    if policy == WHITE:
        return tuple(t.to(target) if t is not None and t.is_floating_point()
                     else t for t in tensors)
    if policy == BLACK:
        return tuple(t.float() if t is not None
                     and t.dtype in (torch.bfloat16, torch.float16) else t
                     for t in tensors)
    raise ValueError(f"unknown amp policy {policy!r}")
