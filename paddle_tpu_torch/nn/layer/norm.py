"""LayerNorm layer (counterpart: paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from .. import initializer as init
from ..functional.norm import layer_norm
from .layers import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight 1,
    bias 0 unless ``weight_attr`` / ``bias_attr`` name another
    initializer."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, dtype=dtype,
            default_initializer=init.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, dtype=dtype,
            is_bias=True, device=device)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)
