"""Tensor math: elementwise ops, reductions and the matmul family
(counterpart: paddle_tpu/ops/math.py).

Under `amp.auto_cast` ``mean`` and ``logsumexp`` are BLACK (half
precision inputs run in f32) and ``matmul``, ``mm``, ``bmm``, ``mv``,
``dot`` and ``addmm`` WHITE (float inputs run in the autocast dtype), as
in the JAX package; every other op runs in its inputs' dtypes.  A Python
number beside a tensor never widens it (PyTorch's 0-d promotion, JAX's
weak typing).  Integer results keep 64 bits where the JAX package
narrows them to 32.  Kept from the JAX package: ``cumsum`` and
``cumprod`` take ``dtype`` and do not read it; ``cummax``/``cummin``
give, among equal running extremes, the latest index.
"""
from __future__ import annotations

import functools

import torch

from .. import amp
from ._util import (axes, dt, floating, keep_dims, moved_last, pair,
                    scalar)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "hypot", "logaddexp", "heaviside", "gcd", "lcm", "nextafter",
    "copysign", "ldexp", "inner", "outer", "kron", "scale", "add_n",
    "lerp", "abs", "sqrt", "rsqrt", "square", "exp", "expm1", "log",
    "log2", "log10", "log1p", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "floor", "ceil",
    "round", "trunc", "frac", "sign", "neg", "reciprocal", "erf",
    "erfinv", "lgamma", "digamma", "sigmoid", "logit", "angle", "conj",
    "real", "imag", "deg2rad", "rad2deg", "rsqrt_", "i0", "i1",
    "nan_to_num", "clip", "stanh", "increment", "sum", "mean", "max",
    "min", "amax", "amin", "prod", "logsumexp", "cumsum", "cumprod",
    "cummax", "cummin", "count_nonzero", "nansum", "nanmean", "matmul",
    "mm", "bmm", "dot", "mv", "addmm", "multiplex", "isfinite", "isnan",
    "isinf", "isclose", "allclose", "trace"]


def _ew(tfn):
    def op(x, name=None):
        return tfn(x)

    return op


def _binary(tfn):
    def op(x, y, name=None):
        return tfn(*pair(x, y))

    return op




# -- elementwise binary -----------------------------------------------------
add = _binary(torch.add)
subtract = _binary(torch.subtract)
multiply = _binary(torch.multiply)
divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
remainder = _binary(torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary(torch.pow)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(lambda a, b: torch.atan2(floating(a), b))
hypot = _binary(torch.hypot)
logaddexp = _binary(torch.logaddexp)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
nextafter = _binary(torch.nextafter)
copysign = _binary(torch.copysign)
ldexp = _binary(lambda a, b: torch.ldexp(floating(a), b.to(torch.int32)))
inner = _binary(torch.inner)
outer = _binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))
kron = _binary(torch.kron)


def _heaviside(a, b):
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.heaviside(a.to(dtype), b.to(dtype))


heaviside = _binary(_heaviside)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = scalar(scale), scalar(bias)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    return functools.reduce(torch.add, inputs)


def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


# -- elementwise unary ------------------------------------------------------
abs = _ew(torch.abs)
sqrt = _ew(torch.sqrt)
rsqrt = _ew(torch.rsqrt)
square = _ew(torch.square)
exp = _ew(torch.exp)
expm1 = _ew(torch.expm1)
log = _ew(torch.log)
log2 = _ew(torch.log2)
log10 = _ew(torch.log10)
log1p = _ew(torch.log1p)
sin = _ew(torch.sin)
cos = _ew(torch.cos)
tan = _ew(torch.tan)
asin = _ew(torch.asin)
acos = _ew(torch.acos)
atan = _ew(torch.atan)
sinh = _ew(torch.sinh)
cosh = _ew(torch.cosh)
tanh = _ew(torch.tanh)
asinh = _ew(torch.asinh)
acosh = _ew(torch.acosh)
atanh = _ew(torch.atanh)
floor = _ew(torch.floor)
ceil = _ew(torch.ceil)
round = _ew(torch.round)
trunc = _ew(torch.trunc)
frac = _ew(lambda a: a - torch.trunc(a))
sign = _ew(torch.sign)
neg = _ew(torch.neg)
reciprocal = _ew(torch.reciprocal)
erf = _ew(torch.erf)
erfinv = _ew(torch.erfinv)
lgamma = _ew(torch.lgamma)
digamma = _ew(torch.digamma)
sigmoid = _ew(torch.sigmoid)
logit = _ew(lambda a: torch.log(a / (1 - a)))
def _angle(a):
    """The phase; a real tensor's in f32, rounded back (CUDA has no half
    precision ``angle`` kernel)."""
    if a.is_complex():
        return torch.angle(a)
    a = floating(a)
    return torch.angle(a.float()).to(a.dtype)


angle = _ew(_angle)
conj = _ew(torch.conj_physical)
real = _ew(lambda a: torch.real(a) if a.is_complex() else a)
imag = _ew(lambda a: torch.imag(a) if a.is_complex()
           else torch.zeros_like(a))
deg2rad = _ew(torch.deg2rad)
rad2deg = _ew(torch.rad2deg)
rsqrt_ = rsqrt
i0 = _ew(lambda a: torch.special.i0(floating(a)))
i1 = _ew(lambda a: torch.special.i1(floating(a)))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def clip(x, min=None, max=None, name=None):
    lo = None if min is None else scalar(min)
    hi = None if max is None else scalar(max)
    if lo is None and hi is None:
        return x
    return torch.clamp(x, lo, hi)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def increment(x, value=1.0, name=None):
    """``x += value`` in place (outside autograd, as the JAX package's
    ``set_value``); returns ``x``."""
    with torch.no_grad():
        x.add_(value)
    return x


# -- reductions -------------------------------------------------------------
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.sum(x, dim=axes(axis, x.dim()), keepdim=keepdim,
                     dtype=dt(dtype))


def mean(x, axis=None, keepdim=False, name=None):
    """BLACK under `amp.auto_cast`."""
    (x,) = amp.cast_inputs(amp.BLACK, x)
    return torch.mean(floating(x), dim=axes(axis, x.dim()),
                      keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    return torch.amax(x, dim=axes(axis, x.dim()), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return torch.amin(x, dim=axes(axis, x.dim()), keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """The product over ``axis``; half precision multiplies in f32 and
    rounds once, as XLA does (torch's CPU kernel would round every
    product to bf16)."""
    dims = axes(axis, x.dim())
    flat = moved_last(x, dims)
    out_dtype = dt(dtype)
    if out_dtype is None and x.dtype in (torch.bfloat16, torch.float16):
        return keep_dims(torch.prod(flat.float(), -1).to(x.dtype), x, dims,
                         keepdim)
    return keep_dims(torch.prod(flat, -1, dtype=out_dtype), x, dims,
                     keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    """BLACK under `amp.auto_cast`."""
    (x,) = amp.cast_inputs(amp.BLACK, x)
    return torch.logsumexp(x, dim=axes(axis, x.dim()), keepdim=keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, int(dim))


def cummax(x, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return tuple(torch.cummax(x, int(axis)))


def cummin(x, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return tuple(torch.cummin(x, int(axis)))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    dims = axes(axis, x.dim())
    return keep_dims(torch.count_nonzero(x, dim=dims), x, dims, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=axes(axis, x.dim()), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(x, dim=axes(axis, x.dim()), keepdim=keepdim)


# -- matmul family (WHITE under auto_cast) ----------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each optionally transposed in its last two axes.  A
    WHITE op under `amp.auto_cast`."""
    x, y = amp.cast_inputs(amp.WHITE, x, y)
    if transpose_x:
        x = x.transpose(-1, -2) if x.dim() > 1 else x
    if transpose_y:
        y = y.transpose(-1, -2) if y.dim() > 1 else y
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    x, y = amp.cast_inputs(amp.WHITE, x, y)
    return torch.sum(x * y, dim=-1)


def mv(x, y, name=None):
    return matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = amp.cast_inputs(amp.WHITE, input, x, y)
    return beta * input + alpha * torch.matmul(x, y)


def multiplex(inputs, index, name=None):
    idx = index.reshape(-1).long()
    return torch.stack(list(inputs), 0)[
        idx, torch.arange(idx.shape[0], device=idx.device)]


def isfinite(x, name=None):
    return torch.isfinite(x)


def isnan(x, name=None):
    return torch.isnan(x)


def isinf(x, name=None):
    return torch.isinf(x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*pair(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor (not a Python bool, as ``torch.allclose``)."""
    return torch.all(isclose(x, y, rtol, atol, equal_nan))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)

