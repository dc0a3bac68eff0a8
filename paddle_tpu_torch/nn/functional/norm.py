"""Normalization functionals (counterpart: paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

from ...ops.layer_norm import fused_layer_norm

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the last axis through `fused_layer_norm`, the JAX
    package's route for one normalized axis with weight and bias."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if len(normalized_shape) != 1 or weight is None or bias is None:
        raise NotImplementedError(
            "layer_norm over several axes or without weight and bias is not "
            "ported yet: it lands with the op long-tail slice of "
            "paddle_tpu_torch (ROADMAP.md Queue 1, item 3)")
    shape = x.shape
    return fused_layer_norm(x.reshape(-1, shape[-1]), weight, bias,
                            epsilon).reshape(shape)
