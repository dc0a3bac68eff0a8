"""Weight-decay regularizers (counterpart: paddle_tpu/regularizer.py).

A regularizer is a function of the parameter that returns the penalty's
gradient, which the optimizer adds to the parameter's gradient before
its update: L1 ``coeff * sign(p)``, L2 ``coeff * p``.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|p|); gradient coeff * sign(p)."""

    def __call__(self, param):
        return self._coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(p^2); gradient coeff * p."""

    def __call__(self, param):
        return self._coeff * param
