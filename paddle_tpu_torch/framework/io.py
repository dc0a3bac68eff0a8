"""``paddle.save`` / ``paddle.load`` (counterpart:
paddle_tpu/framework/io.py).

The JAX package's format: a pickle of the nested object in which each
tensor is ``{"__tensor__": True, "data": <numpy array>,
"stop_gradient": bool}``, so a file written by either package loads in
the other.  bfloat16 tensors are stored as ml_dtypes' ``bfloat16``
numpy arrays, as the JAX package's ``numpy()`` gives them (widened to
float32 where ml_dtypes is not installed).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.tensor import from_numpy
from ..device import resolve_device

__all__ = ["save", "load"]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _numpy(obj),
                "stop_gradient": not obj.requires_grad}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = from_numpy(obj["data"]).to(device)
            if not obj.get("stop_gradient", True) and t.is_floating_point():
                t.requires_grad_(True)
            return t
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v, return_numpy, device) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (nested dicts, lists and tensors, e.g. a
    ``state_dict()``) to ``path``, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """The object `save` wrote, its tensors on ``device`` (default: the
    card) or, with ``return_numpy``, as numpy arrays."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy,
                   None if return_numpy else resolve_device(device))
