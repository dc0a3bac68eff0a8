"""Weight reparameterizations (counterpart: paddle_tpu/nn/utils.py).

`weight_norm` keeps ``{name}_g`` (the norm of each slice along ``dim``;
``dim=None``: of the whole tensor) and ``{name}_v`` as trainable
parameters in place of ``{name}``, and a forward pre-hook rebuilds
``{name} = g * v / ||v||``.  `spectral_norm` keeps ``{name}_orig`` and
the power iteration's ``{name}_u`` / ``{name}_v`` (drawn from
``np.random.RandomState(0)``, as the JAX package draws them) and its
hook sets ``{name} = orig / sigma``, stepping u and v once a forward.

As in the JAX package's eager mode, each hook rebuilds the weight from
the parameters' values outside autograd (JAX's hook reads the unwrapped
arrays): a loss's gradient reaches neither ``{name}_g``/``{name}_v`` nor
``{name}_orig``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(w, dim):
    dims = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.square(w).sum(dim=dims, keepdim=True))


def _normed(g, v, dim):
    return g * v / torch.clamp(_norm_except(v, dim), min=1e-12)


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name).detach()
    g = torch.nn.Parameter(_norm_except(w, dim).clone())
    v = torch.nn.Parameter(w.clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_g", g)
    layer.register_parameter(name + "_v", v)

    @torch.no_grad()
    def hook(ly, inputs):
        object.__setattr__(ly, name, _normed(getattr(ly, name + "_g"),
                                             getattr(ly, name + "_v"), dim))

    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_dim = dim
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Undo `weight_norm`: ``{name}`` a trainable parameter again, of
    ``g * v / ||v||``."""
    handle = getattr(layer, "_weight_norm_handle", None)
    if handle is not None:
        handle.remove()
    dim = getattr(layer, "_weight_norm_dim", 0)
    v = layer._parameters.pop(name + "_v", None)
    g = layer._parameters.pop(name + "_g", None)
    if v is not None and g is not None:
        layer.__dict__.pop(name, None)
        with torch.no_grad():
            layer.register_parameter(name, torch.nn.Parameter(
                _normed(g, v, dim)))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    w = getattr(layer, name).detach()
    dim = 0 if dim is None else dim
    h = w.shape[dim]
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.randn(h).astype(np.float32)).to(w.device)
    v = torch.from_numpy(rng.randn(w.numel() // h).astype(np.float32)).to(
        w.device)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", torch.nn.Parameter(w.clone()))
    object.__setattr__(layer, name + "_u", u)
    object.__setattr__(layer, name + "_v", v)

    @torch.no_grad()
    def hook(ly, inputs):
        wv = getattr(ly, name + "_orig")
        m = wv.movedim(dim, 0).reshape(wv.shape[dim], -1)
        uu, vv = getattr(ly, name + "_u"), getattr(ly, name + "_v")
        for _ in range(max(1, n_power_iterations)):
            vv = m.T @ uu
            vv = vv / torch.clamp(torch.linalg.vector_norm(vv), min=eps)
            uu = m @ vv
            uu = uu / torch.clamp(torch.linalg.vector_norm(uu), min=eps)
        sigma = uu @ (m @ vv)
        object.__setattr__(ly, name, wv / torch.clamp(sigma, min=eps))
        object.__setattr__(ly, name + "_u", uu)
        object.__setattr__(ly, name + "_v", vv)

    layer._spectral_norm_handle = layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer
