"""Activations (counterpart: paddle_tpu/nn/functional/activation.py).

Paddle's parameters and formulas (``hardsigmoid``'s slope 1/6 and offset
0.5, ``selu``'s scale and alpha, ``softplus``'s threshold on ``beta *
x``).  ``softmax`` and ``log_softmax`` are BLACK under `amp.auto_cast`
(their ``dtype`` is taken and not read, as in the JAX package);
``gumbel_softmax`` and ``rrelu`` in training draw from the default
generator of the input's device.  ``relu_`` and ``softmax_`` write in
place (autograd refuses a leaf that requires grad, as Paddle does).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...core.framework import generator_for

__all__ = ["relu", "relu6", "relu_", "sigmoid", "log_sigmoid", "tanh",
           "tanhshrink", "gelu", "leaky_relu", "elu", "celu", "selu", "silu",
           "swish", "mish", "hardtanh", "hardsigmoid", "hardswish",
           "hardshrink", "softshrink", "softplus", "softsign",
           "thresholded_relu", "softmax", "softmax_", "log_softmax",
           "gumbel_softmax", "maxout", "prelu", "glu", "rrelu"]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


def relu_(x, name=None):
    return x.relu_()


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def silu(x, name=None):
    return TF.silu(x)


def swish(x, name=None):
    return TF.silu(x)


def mish(x, name=None):
    return x * torch.tanh(TF.softplus(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x,
                       TF.softplus(x * beta) / beta)


def softsign(x, name=None):
    return TF.softsign(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, 0.0)


def softmax(x, axis=-1, dtype=None, name=None):
    """BLACK under `amp.auto_cast`."""
    (x,) = amp.cast_inputs(amp.BLACK, x)
    return torch.softmax(x, axis)


def softmax_(x, axis=-1, name=None):
    return x.copy_(softmax(x, axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """BLACK under `amp.auto_cast`."""
    (x,) = amp.cast_inputs(amp.BLACK, x)
    return torch.log_softmax(x, axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, generator=generator_for(x.device),
                   device=x.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        y_hard = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, axis, keepdim=True), 1.0)
        y = (y_hard - y).detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    shape = list(x.shape)
    c = shape[axis]
    shape[axis] = c // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), axis + 1)


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
        weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def glu(x, axis=-1, name=None):
    return TF.glu(x, axis)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Negative inputs times a slope: ``(lower + upper) / 2`` outside
    training, a uniform draw from [lower, upper) an element in it."""
    if not training:
        return torch.where(x >= 0, x, x * ((lower + upper) / 2))
    slopes = torch.rand(x.shape, generator=generator_for(x.device),
                        device=x.device, dtype=torch.float32)
    slopes = (slopes * (upper - lower) + lower).to(x.dtype)
    return torch.where(x >= 0, x, x * slopes)
