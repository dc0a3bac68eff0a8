"""Optimizer base (counterpart: paddle_tpu/optimizer/optimizer.py).

Each optimizer defines ``_update_param(p, g, slot, lr, step)``, which
updates one parameter and its slot state IN PLACE under
``torch.no_grad()``: where the JAX package's jitted train step donates
the old arrays and returns new ones, the port overwrites them.
`apply_gradients` maps it over a dict of parameters, as the JAX
package's staged form does inside `jit.TrainStep`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet: it lands with the eager-core "
                "slice of paddle_tpu_torch")
        # ``parameters`` is taken for paddle's signature: the staged
        # `apply_gradients` receives the parameters it updates
        self._lr = learning_rate
        self._weight_decay = float(weight_decay or 0.0)

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    # -- functional core (override) ----------------------------------------
    def _init_slot(self, p: torch.Tensor) -> dict:
        return {}

    def _update_param(self, p, g, slot, lr, step):
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _apply_decay(self, p, g):
        """L2 decay folded into the gradient (not for decoupled decay)."""
        if self._weight_decay and not self._decoupled_weight_decay():
            return g + self._weight_decay * p
        return g

    # -- staged form --------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> dict:
        return {k: self._init_slot(p) for k, p in params.items()}

    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]],
                        state: dict, lr, step=1):
        """Update every parameter with a gradient, and its slot state, in
        place; a parameter whose gradient is None is left as it is.
        ``lr`` is the learning rate of this step, ``step`` counts from 1.
        Returns ``(params, state)``."""
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            if k not in state:
                state[k] = self._init_slot(p)
            g = self._apply_decay(p, g.to(p.dtype))
            self._update_param(p, g, state[k], lr, step)
        return params, state
