"""Probability distributions (counterpart:
paddle_tpu/distribution/__init__.py): `Normal`, `Uniform` and
`Categorical`, each with ``sample``, ``entropy``, ``log_prob``, ``probs``
and (`Normal`, `Categorical`) ``kl_divergence``, differentiable by torch's
autograd.

Draws come from a ``torch.Generator``: ``generator=`` where given, else
``paddle.seed``'s generator of the parameters' device.  They equal the
JAX package's in distribution only (``jax.random`` streams are not
reproducible in torch).
"""
from __future__ import annotations

import math

import torch

from ..core import framework

__all__ = ["Distribution", "Normal", "Uniform", "Categorical"]


def _t(x):
    """``x`` as a tensor: a tensor as it is, anything else f32 on the
    expected device."""
    if isinstance(x, torch.Tensor):
        return x
    from ..core.place import to_device

    return torch.as_tensor(x, dtype=torch.float32, device=to_device(None))


def _gen(device, generator):
    return generator if generator is not None else \
        framework.generator_for(device)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _t(loc)
        self.scale = _t(scale)

    def sample(self, shape=(), seed=0, generator=None):
        """``loc + scale * eps`` with ``eps`` standard normal of
        ``shape + batch_shape`` (differentiable in loc and scale, as the
        JAX package's ``rsample`` is the same draw)."""
        base = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        dev = self.loc.device
        eps = torch.randn(tuple(shape) + tuple(base), dtype=torch.float32,
                          device=dev, generator=_gen(dev, generator))
        return self.loc + self.scale * eps

    def rsample(self, shape=(), generator=None):
        return self.sample(shape, generator=generator)

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def log_prob(self, value):
        v, m, s = _t(value), self.loc, self.scale
        return -((v - m) ** 2) / (2 * s * s) - torch.log(s) \
            - 0.5 * math.log(2 * math.pi)

    def kl_divergence(self, other):
        m1, s1, m2, s2 = self.loc, self.scale, other.loc, other.scale
        return torch.log(s2 / s1) \
            + (s1 * s1 + (m1 - m2) ** 2) / (2 * s2 * s2) - 0.5


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _t(low)
        self.high = _t(high)

    def sample(self, shape=(), seed=0, generator=None):
        base = torch.broadcast_shapes(self.low.shape, self.high.shape)
        dev = self.low.device
        u = torch.rand(tuple(shape) + tuple(base), dtype=torch.float32,
                       device=dev, generator=_gen(dev, generator))
        return self.low + (self.high - self.low) * u

    def entropy(self):
        return torch.log(self.high - self.low)

    def log_prob(self, value):
        v, lo, hi = _t(value), self.low, self.high
        inside = (v >= lo) & (v < hi)
        return torch.where(inside, -torch.log(hi - lo),
                           torch.full_like(v * lo, -math.inf))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _t(logits)

    def sample(self, shape=(), generator=None):
        """int64 category ids of ``shape + batch_shape``."""
        lg = self.logits
        batch = tuple(lg.shape[:-1])
        probs = torch.softmax(lg.detach().float(), -1).reshape(
            -1, lg.shape[-1])
        n = math.prod(shape) if shape else 1
        ids = torch.multinomial(probs, n, replacement=True,
                                generator=_gen(lg.device, generator))
        return ids.t().reshape(tuple(shape) + batch)

    def entropy(self):
        lg = self.logits
        return -(torch.softmax(lg, -1) * torch.log_softmax(lg, -1)).sum(-1)

    def log_prob(self, value):
        idx = _t(value).long()
        return torch.log_softmax(self.logits, -1).gather(
            -1, idx.unsqueeze(-1)).squeeze(-1)

    def kl_divergence(self, other):
        a, b = self.logits, other.logits
        return (torch.softmax(a, -1) * (torch.log_softmax(a, -1)
                                        - torch.log_softmax(b, -1))).sum(-1)
