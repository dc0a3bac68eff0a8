"""Tensor creation (counterpart: paddle_tpu/core/tensor.py).

The port's tensor is ``torch.Tensor`` itself: Paddle's ``stop_gradient``
is ``not requires_grad``, ``.grad``, ``backward`` and ``clear_grad``
(``grad = None``) are torch's.  `to_tensor` keeps the JAX package's
dtype rule: float64 data without a dtype takes the default dtype
(float32).  Integers keep their 64 bits (the JAX package, without x64,
narrows them to int32), and an explicit dtype is honoured.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod
from .place import to_device

__all__ = ["to_tensor", "is_tensor", "from_numpy"]


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a numpy array's values (ml_dtypes' bfloat16,
    which the JAX package's tensors give, as torch.bfloat16)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new tensor of ``data`` on ``place``
    (default: `device.default_device()`, the card), of ``dtype`` (default:
    the data's own, float64 data the default dtype).
    ``stop_gradient=False`` makes it a leaf that requires grad."""
    device = to_device(place)
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().clone()
    else:
        t = from_numpy(np.asarray(data))
        if dt is None and t.dtype == torch.float64:
            dt = dtype_mod.get_default_dtype()
    t = t.to(device=device, dtype=dt)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
