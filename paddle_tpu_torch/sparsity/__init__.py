"""ASP, automatic structured n:m sparsity (counterpart:
paddle_tpu/sparsity/__init__.py).

`create_mask` is the JAX package's host numpy computation (the top n of
each group of m by magnitude through numpy's ``argsort``), so masks equal
its masks, ties included; `prune_model` runs it once a parameter and keeps
each mask on the parameter's device, where `decorate`'s optimizer wrapper
multiplies it in after every step.  `check_mask` and `calculate_density`
count on the tensor's own device.

Kept from the JAX package: every parameter of two or more dimensions is
pruned, embeddings included (Paddle's ASP prunes supported layers only),
unless `set_excluded_layers` names it.  Unlike the JAX package, which keys
its masks and exclusions by ``id(model)``, both are held weakly by the
model itself: they go with it, and a later model that reuses its address
inherits nothing.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.layer.layers import Layer
from ..ops._util import host as _host

__all__ = [
    "calculate_density", "create_mask", "check_mask", "prune_model",
    "decorate", "set_excluded_layers", "reset_excluded_layers", "ASPHelper",
]

# model -> the parameter names it keeps dense
_excluded: "weakref.WeakKeyDictionary[Layer, set]" = \
    weakref.WeakKeyDictionary()


def calculate_density(x) -> float:
    """The share of nonzero entries."""
    if isinstance(x, torch.Tensor):
        return float((x != 0).sum().item() / x.numel())
    a = np.asarray(x)
    return float((a != 0).sum() / a.size)


def create_mask(x, n=2, m=4):
    """The n:m mask along the flattened last axis: 1 for the n largest
    magnitudes of every group of m, the tail (``size % m``) kept dense;
    float32 numpy of ``x``'s shape."""
    a = _host(x)
    flat = a.reshape(-1)
    g = (flat.size // m) * m
    groups = np.abs(flat[:g]).reshape(-1, m)
    order = np.argsort(-groups, axis=1)[:, :n]
    mask = np.zeros_like(groups, dtype=np.float32)
    np.put_along_axis(mask, order, 1.0, axis=1)
    out = np.ones_like(flat, dtype=np.float32)
    out[:g] = mask.reshape(-1)
    return out.reshape(a.shape)


def check_mask(x, n=2, m=4) -> bool:
    """Whether every complete group of m holds at most n nonzeros."""
    if isinstance(x, torch.Tensor):
        flat = x.detach().reshape(-1)
        g = (flat.numel() // m) * m
        if g == 0:
            return True
        nz = (flat[:g].reshape(-1, m) != 0).sum(dim=1)
        return bool((nz <= n).all().item())
    flat = np.asarray(x).reshape(-1)
    g = (flat.size // m) * m
    if g == 0:
        return True
    nz = (flat[:g].reshape(-1, m) != 0).sum(axis=1)
    return bool((nz <= n).all())


def set_excluded_layers(param_names: List[str], model: Layer):
    _excluded[model] = set(param_names)


def reset_excluded_layers(model: Layer = None):
    if model is None:
        _excluded.clear()
    else:
        _excluded.pop(model, None)


def _prunable(model: Layer):
    """Every parameter of two or more dimensions not excluded."""
    excluded = _excluded.get(model, set())
    for name, p in model.named_parameters():
        if p is None or p.dim() < 2 or name in excluded:
            continue
        yield name, p


class ASPHelper:
    """The per-model masks (device tensors, by parameter name), held
    weakly by the model."""

    _masks: "weakref.WeakKeyDictionary[Layer, Dict[str, torch.Tensor]]" = \
        weakref.WeakKeyDictionary()

    @classmethod
    def prune_model(cls, model: Layer, n=2, m=4, mask_algo="mask_1d",
                    with_mask=True):
        masks, device_masks = {}, {}
        with torch.no_grad():
            for name, p in _prunable(model):
                mask = create_mask(p, n=n, m=m)
                dm = torch.from_numpy(mask).to(device=p.device,
                                               dtype=p.dtype)
                p.mul_(dm)
                masks[name] = mask
                device_masks[name] = dm
        cls._masks[model] = device_masks
        return masks

    @classmethod
    def reapply_masks(cls, model: Layer):
        masks = cls._masks.get(model)
        if not masks:
            return
        with torch.no_grad():
            for name, p in model.named_parameters():
                mask = masks.get(name)
                if mask is not None:
                    p.mul_(mask)


def prune_model(model: Layer, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Prune the model's weights to n:m sparsity in place; returns the
    masks (numpy, by parameter name)."""
    return ASPHelper.prune_model(model, n=n, m=m, mask_algo=mask_algo,
                                 with_mask=with_mask)


class _ASPOptimizer:
    """The optimizer with the masks multiplied in after every step, so
    pruned entries stay zero."""

    def __init__(self, optimizer, model: Layer):
        self._inner = optimizer
        self._model = model

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()
        ASPHelper.reapply_masks(self._model)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


def decorate(optimizer, model: Optional[Layer] = None):
    """``optimizer`` wrapped so masked weights stay masked (``model=``
    is required)."""
    if model is None:
        raise ValueError("paddle_tpu_torch.sparsity.decorate requires "
                         "model=")
    return _ASPOptimizer(optimizer, model)
