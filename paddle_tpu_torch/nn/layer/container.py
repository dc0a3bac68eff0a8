"""Layer containers (counterpart: paddle_tpu/nn/layer/container.py).

Each is torch's container of the same role with the port's `Layer`
methods: `Sequential` also takes Paddle's ``[(name, layer), ...]`` and a
sublayer's name as an index, `ParameterList` and `LayerDict` are
``nn.ParameterList`` and ``nn.ModuleDict`` (names ``0``, ``1``, ... and
the dict's keys, as in the JAX package).
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer, nn.Sequential):
    """Sublayers called in turn, named ``0``, ``1``, ... or by the names
    of a ``[(name, layer), ...]`` list (or an ``OrderedDict``)."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = (OrderedDict(layers[0]),)
        nn.Sequential.__init__(self, *layers)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        return nn.Sequential.__getitem__(self, idx)


class LayerList(Layer, nn.ModuleList):
    """An indexable list of sublayers, registered as ``0``, ``1``, ..."""


class ParameterList(Layer, nn.ParameterList):
    """An indexable list of parameters, registered as ``0``, ``1``, ..."""


class LayerDict(Layer, nn.ModuleDict):
    """Sublayers by name, in insertion order."""
