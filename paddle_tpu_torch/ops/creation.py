"""Creation ops (counterpart: paddle_tpu/ops/creation.py).

Every op that makes a tensor from nothing (`zeros`, `full`, `arange`,
`eye`, ...) puts it on the expected place (`core.place.set_device`; the
card when nothing is set, raising where there is none); an op over a
tensor keeps that tensor's device.  Kept from the JAX package: `empty`
and `empty_like` return zeros; `full` and `arange` take their dtype from
their values when none is given (an int an integer dtype, a float the
default dtype); `diag_embed` always embeds in the last two axes (its
``dim1``/``dim2`` are taken and not read, as there).  Integers keep 64
bits where the JAX package, without x64, narrows them to 32.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from ..core.place import to_device
from ..core.tensor import to_tensor
from ._util import dt, scalar, shape_list

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace",
           "eye", "assign", "clone", "diag", "diag_embed", "diagonal",
           "tril", "triu", "meshgrid", "one_hot", "complex"]


def _value_dtype(*values):
    """The dtype JAX's weak typing gives Python values: bool, an integer
    dtype (int64 here), else the default floating dtype."""
    if builtins.all(isinstance(v, bool) for v in values):
        return torch.bool
    if builtins.all(isinstance(v, (bool, int)) for v in values):
        return torch.int64
    return dtype_mod.get_default_dtype()


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_list(shape),
                       dtype=dt(dtype, dtype_mod.get_default_dtype()),
                       device=to_device(None))


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_list(shape),
                      dtype=dt(dtype, dtype_mod.get_default_dtype()),
                      device=to_device(None))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        default = fill_value.dtype
        fill_value = fill_value.item()
    else:
        default = _value_dtype(fill_value)
    return torch.full(shape_list(shape), fill_value,
                      dtype=dt(dtype, default), device=to_device(None))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=dt(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=dt(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, scalar(fill_value), dtype=dt(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = scalar(start), scalar(end), scalar(step)
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step,
                        dtype=dt(dtype, _value_dtype(start, end, step)),
                        device=to_device(None))


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(scalar(start), scalar(stop), int(scalar(num)),
                          dtype=dt(dtype, dtype_mod.get_default_dtype()),
                          device=to_device(None))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(scalar(start), scalar(stop), int(scalar(num)),
                          base=base,
                          dtype=dt(dtype, dtype_mod.get_default_dtype()),
                          device=to_device(None))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns,
                     dtype=dt(dtype, dtype_mod.get_default_dtype()),
                     device=to_device(None))


def assign(x, output=None, name=None):
    """A copy of ``x`` (a tensor, differentiably, or data through
    `to_tensor`); written into ``output`` when one is given."""
    out = x.clone() if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def diag(x, offset=0, padding_value=0, name=None):
    if x.dim() == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            on_diag = torch.ones_like(d, dtype=torch.bool).tril(
                offset).triu(offset)
            d = torch.where(on_diag, d, padding_value)
        return d
    return torch.diagonal(x, offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(x, offset, -2, -1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    xs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*xs, indexing="ij"))


def one_hot(x, num_classes, name=None):
    """One-hot rows of the default dtype; an index outside
    ``[0, num_classes)`` gives a row of zeros (``jax.nn.one_hot``)."""
    cls = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == cls).to(dtype_mod.get_default_dtype())


def complex(real, imag, name=None):
    return torch.complex(real, imag)
