"""Weight initializers (counterpart: paddle_tpu/nn/initializer.py).

The twelve initializers of the JAX package with its formulas (fans,
gains, limits, the truncation at two standard deviations).  Random ones
draw from the default generator's ``torch.Generator`` of the device they
fill (`core.framework.generator_for`), never the global RNG; the numbers
are not ``jax.random``'s, so two packages agree in distribution only.
``init(param)`` fills a parameter in place and returns it;
``_init(shape, dtype, device)`` returns a new tensor.  On the meta
device nothing is drawn.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.framework import generator_for

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "MSRAInitializer", "Assign",
           "NumpyArrayInitializer", "Bilinear", "Orthogonal", "Dirac",
           "calculate_gain"]


def _fan_in_out(shape):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    # whether `_draw` takes the device's generator
    _random = False

    def _draw(self, shape, dtype, device, gen):
        raise NotImplementedError

    def _init(self, shape, dtype=torch.float32, device="cpu"):
        shape = [int(s) for s in shape]
        dtype = dtype_mod.convert_dtype(dtype)
        device = torch.device(device)
        if device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        gen = generator_for(device) if self._random else None
        return self._draw(shape, dtype, device, gen)

    @torch.no_grad()
    def __call__(self, param, block=None):
        param.copy_(self._init(param.shape, param.dtype, param.device))
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, dtype, device, gen):
        return torch.full(shape, self.value, dtype=dtype, device=device)


def _uniform(shape, dtype, device, gen, low, high):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * (high - low) + low).to(dtype)


def _normal(shape, dtype, device, gen):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


class Uniform(Initializer):
    _random = True

    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _draw(self, shape, dtype, device, gen):
        return _uniform(shape, dtype, device, gen, self.low, self.high)


class Normal(Initializer):
    _random = True

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _draw(self, shape, dtype, device, gen):
        return (_normal(shape, dtype, device, gen) * self.std
                + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """N(mean, std) truncated at two standard deviations."""
    _random = True

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _draw(self, shape, dtype, device, gen):
        t = torch.empty(shape, device=device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * self.std + self.mean).to(dtype)


class XavierUniform(Initializer):
    _random = True

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device, gen):
        fi, fo = _fan_in_out(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _uniform(shape, dtype, device, gen, -limit, limit)


class XavierNormal(Initializer):
    _random = True

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device, gen):
        fi, fo = _fan_in_out(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return (_normal(shape, dtype, device, gen) * std).to(dtype)


class KaimingUniform(Initializer):
    _random = True

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _draw(self, shape, dtype, device, gen):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, gen, -limit, limit)


class KaimingNormal(Initializer):
    _random = True

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _draw(self, shape, dtype, device, gen):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return (_normal(shape, dtype, device, gen) * (gain / math.sqrt(fi))
                ).to(dtype)


MSRAInitializer = KaimingNormal


class Assign(Initializer):
    """The given values (numpy, list or tensor), reshaped to the shape."""

    def __init__(self, value, name=None):
        self.value = value

    def _draw(self, shape, dtype, device, gen):
        v = self.value
        t = v.detach() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v))
        t = t.to(device=device, dtype=dtype)
        return t if list(t.shape) == list(shape) else t.reshape(shape)


NumpyArrayInitializer = Assign


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a [C_out, C_in, H, W] weight."""

    def _draw(self, shape, dtype, device, gen):
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[2:]))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[:, :, y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device=device, dtype=dtype)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns (QR of a
    normal draw, signs fixed by R's diagonal)."""
    _random = True

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _draw(self, shape, dtype, device, gen):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        a = _normal((max(rows, cols), min(rows, cols)), torch.float32,
                    device, gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """The identity of a convolution: 1 at each group's (i, i, centre)."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _draw(self, shape, dtype, device, gen):
        w = np.zeros(shape, dtype="float32")
        out_per_group = shape[0] // self.groups
        for g in range(self.groups):
            for i in range(min(out_per_group, shape[1])):
                idx = (g * out_per_group + i, i) + tuple(s // 2
                                                         for s in shape[2:])
                w[idx] = 1.0
        return torch.from_numpy(w).to(device=device, dtype=dtype)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(nonlinearity)
