"""Loss layers (counterpart: paddle_tpu/nn/layer/loss.py)."""
from __future__ import annotations

from ..functional.loss import cross_entropy
from .layers import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """`functional.cross_entropy` of hard integer labels as a layer."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return cross_entropy(input, label, **self._kw)
