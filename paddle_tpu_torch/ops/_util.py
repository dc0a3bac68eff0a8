"""Host-side argument helpers of the op library (the port's own copies of
the JAX package's `_ints`, `_shape_list` and `_axis`)."""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod


def scalar(v):
    """A 0-d tensor or a one-element tensor as a Python number."""
    return v.item() if isinstance(v, torch.Tensor) else v


def ints(v):
    """A tensor, list or tuple (of ints or 0-d tensors) as a list of
    ints; a single value as an int."""
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [int(scalar(i)) for i in v]
    return int(v)


def shape_list(shape):
    """``shape`` (an int, a sequence or a tensor) as a list of ints."""
    if isinstance(shape, int):
        return [shape]
    return ints(shape)


def axes(axis, nd):
    """``axis`` (None, an int, a sequence or a tensor) as a tuple of
    non-negative axes of an ``nd``-dimensional tensor; None is all."""
    if axis is None:
        return tuple(range(nd))
    axis = ints(axis)
    if isinstance(axis, int):
        axis = [axis]
    return tuple(a % nd if nd else 0 for a in axis)


def dt(dtype, default=None):
    """``dtype`` as a ``torch.dtype``; None is ``default``."""
    return default if dtype is None else dtype_mod.convert_dtype(dtype)


def as_tensor(v, like=None):
    """``v`` as a tensor on ``like``'s device (a Python number keeps
    PyTorch's 0-d type promotion: it never widens ``like``)."""
    if isinstance(v, torch.Tensor):
        return v
    if like is not None:
        return torch.as_tensor(v, device=like.device)
    from ..core.place import to_device

    return torch.as_tensor(v, device=to_device(None))


def pair(x, y):
    """``x`` and ``y`` as tensors on one device, either a Python number."""
    if not isinstance(x, torch.Tensor):
        y = as_tensor(y)
        return as_tensor(x, y), y
    return x, as_tensor(y, x)


def moved_last(x, dims):
    """``x`` with ``dims`` moved to the end and flattened into one axis:
    the form of a reduction over several axes that PyTorch offers over
    one."""
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(keep + list(dims))
    return y.reshape([x.shape[d] for d in keep] + [-1])


def floating(x):
    """Integer and bool tensors in the default dtype (JAX's promotion of
    an op that only has a floating result)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.get_default_dtype())


def keep_dims(out, x, dims, keepdim):
    """Reinsert the reduced ``dims`` of ``x`` as size-1 axes of ``out``
    when ``keepdim`` (out has the kept axes, in order, and nothing else
    in front of them)."""
    if not keepdim:
        return out
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    lead = list(out.shape[:out.dim() - (x.dim() - len(dims))])
    return out.reshape(lead + shape)


def div(a, n):
    """``a / n`` correctly rounded on every device (``n`` a number): CUDA
    divides by a host scalar as a multiply by its reciprocal, which moves
    a quotient that is then rounded or floored (an integer bin edge, an
    int8 level) off the CPU's and the JAX package's."""
    return a / torch.tensor(n, dtype=a.dtype, device=a.device)


def host(x):
    """``x`` as a numpy array (a tensor read to the host, bfloat16 as
    float32)."""
    import numpy as np

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)
