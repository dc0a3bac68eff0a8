"""Random ops (counterpart: paddle_tpu/ops/random.py).

Every draw comes from the default generator's ``torch.Generator`` of the
device it fills (`core.framework`, seeded by `seed`), never the global
torch RNG: one seed repeats a draw on each device.  The streams are not
``jax.random``'s, so the two packages agree in distribution only.  An op
without an input tensor draws on the expected place
(`core.place.set_device`; the card when nothing is set); one over a
tensor (``bernoulli``, ``poisson``, ``multinomial``, ``shuffle``,
``*_like``) on that tensor's device.  Kept from the JAX package:
``uniform``'s ``seed`` is taken and not read, and ``multinomial`` draws
with replacement whatever ``replacement`` says.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core import framework
from ..core.place import to_device
from ._util import dt, scalar, shape_list

__all__ = ["seed", "get_rng_state", "set_rng_state", "uniform", "rand",
           "normal", "gaussian", "randn", "standard_normal", "randint",
           "randint_like", "randperm", "shuffle", "bernoulli", "poisson",
           "multinomial", "normal_like"]


def _float(dtype):
    return dt(dtype, dtype_mod.get_default_dtype())


def _draw_dtype(dtype):
    """Half-precision draws are made in f32 and rounded."""
    return dtype if dtype == torch.float64 else torch.float32


def seed(s):
    return framework.seed(s)


def get_rng_state():
    return framework.get_rng_state()


def set_rng_state(state):
    framework.set_rng_state(state)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dtype, device = _float(dtype), to_device(None)
    u = torch.rand(shape_list(shape), generator=framework.generator_for(
        device), device=device, dtype=_draw_dtype(dtype))
    lo, hi = float(scalar(min)), float(scalar(max))
    return (u * (hi - lo) + lo).to(dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _normal(shape, dtype, device):
    return torch.randn(shape, generator=framework.generator_for(device),
                       device=device, dtype=_draw_dtype(dtype))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dtype = dtype_mod.get_default_dtype()
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        t = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(getattr(mean, "shape", ()),
                                     getattr(std, "shape", ()))
        return (_normal(shp, dtype, t.device) * std + mean).to(dtype)
    return (_normal(shape_list(shape), dtype, to_device(None)) * std
            + mean).to(dtype)


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None):
    dtype = _float(dtype)
    return (_normal(shape_list(shape), dtype, to_device(None)) * std
            + mean).to(dtype)


def randn(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype)


def standard_normal(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype)


def _randint(low, high, shape, dtype, device):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), shape,
                         generator=framework.generator_for(device),
                         device=device, dtype=dt(dtype, torch.int64))


def randint(low=0, high=None, shape=[1], dtype=None, name=None):
    return _randint(low, high, shape_list(shape), dtype, to_device(None))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return _randint(low, high, list(x.shape), dtype or x.dtype, x.device)


def randperm(n, dtype="int64", name=None):
    device = to_device(None)
    return torch.randperm(n, generator=framework.generator_for(device),
                          device=device, dtype=dt(dtype))


def shuffle(x, axis=0, name=None):
    perm = torch.randperm(x.shape[axis],
                          generator=framework.generator_for(x.device),
                          device=x.device)
    return x.index_select(axis, perm)


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=framework.generator_for(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=framework.generator_for(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` category indices a row of the probabilities ``x``,
    with replacement (the JAX package's categorical draws)."""
    return torch.multinomial(x, num_samples, replacement=True,
                             generator=framework.generator_for(x.device))


def normal_like(x, mean=0.0, std=1.0, name=None):
    return (_normal(list(x.shape), x.dtype, x.device) * std
            + mean).to(x.dtype)
