"""LayerNorm layer (counterpart: paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight 1,
    bias 0."""

    def __init__(self, normalized_shape, epsilon=1e-05, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            self._normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            self._normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)
