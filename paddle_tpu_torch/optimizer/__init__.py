"""Optimizers (counterpart: paddle_tpu/optimizer/__init__.py).

`Adam` and `AdamW` compute the JAX package's update, which is not
``torch.optim.AdamW``'s: the bias corrections fold into the step size,
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, and epsilon is scaled
with them, ``denom = sqrt(v) + eps * sqrt(1 - beta2^t)``.  The beta
powers are f32 scalars kept per parameter.  AdamW's decay is decoupled,
``p - lr * weight_decay * p_old``, and applies to every parameter
(biases, LayerNorms and embeddings too), as in the JAX package, whose
``apply_decay_param_fun`` is stored and never read.  The other
optimizers come with a later slice.
"""
from __future__ import annotations

import torch

from . import lr
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slot(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update_param(self, p, g, slot, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slot["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = slot["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
        b1p = slot["beta1_pow"].mul_(b1)
        b2p = slot["beta2_pow"].mul_(b2)
        corr2 = torch.sqrt(1 - b2p)
        lr_t = lr * corr2 / (1 - b1p)
        denom = torch.sqrt(v).add_(self._epsilon * corr2)
        p.sub_((lr_t * (m / denom)).to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _decoupled_weight_decay(self):
        return True

    def _update_param(self, p, g, slot, lr, step):
        decay = (lr * self._weight_decay * p).to(p.dtype) \
            if self._weight_decay else None
        super()._update_param(p, g, slot, lr, step)
        if decay is not None:
            p.sub_(decay)
