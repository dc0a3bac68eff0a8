"""Tensor math (counterpart: paddle_tpu/ops/math.py)."""
from __future__ import annotations

import torch

from .. import amp

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, each optionally transposed in its last two axes.  A
    WHITE op under `amp.auto_cast`."""
    x, y = amp.cast_inputs(amp.WHITE, x, y)
    if transpose_x:
        x = x.transpose(-1, -2) if x.dim() > 1 else x
    if transpose_y:
        y = y.transpose(-1, -2) if y.dim() > 1 else y
    return torch.matmul(x, y)
