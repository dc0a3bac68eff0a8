"""Symmetric int8 weight quantization (counterpart:
paddle_tpu/quantization/int8.py `Q_MAX` and `quantize_weight`).

The serving engine folds its matmul weights with `quantize_weight` when
``serve_weights="int8"``.  The arithmetic is paddle_tpu's, in its order,
so the int8 payloads come out bit-equal to the JAX package's.
"""
from __future__ import annotations

import torch

__all__ = ["Q_MAX", "quantize_weight"]

Q_MAX = 127.0


def quantize_weight(w: torch.Tensor, quant_axis: int):
    """Per-channel symmetric int8 along ``quant_axis``: returns ``(q int8
    of w's shape, scale f32 [channels])`` with ``scale`` the channel's
    absmax and ``q = clip(round(w / max(scale, 1e-30) * Q_MAX), ±Q_MAX)``
    — divide first, then multiply, as paddle_tpu does.  ``torch.round``
    rounds half to even, like ``jnp.round``."""
    red = [i for i in range(w.dim()) if i != quant_axis]
    scale = w.abs().amax(dim=red)
    shape = [1] * w.dim()
    shape[quant_axis] = -1
    q = torch.clamp(torch.round(w / torch.clamp(scale.reshape(shape),
                                                min=1e-30) * Q_MAX),
                    -Q_MAX, Q_MAX).to(torch.int8)
    return q, scale
