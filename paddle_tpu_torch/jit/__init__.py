"""Training step (counterpart: paddle_tpu/jit/__init__.py `TrainStep`).

The JAX package compiles forward, backward and the optimizer update into
one jitted executable that donates the parameters and optimizer state.
PyTorch runs eagerly, so `TrainStep` runs the same three stages in turn
on the model's own parameters: the forward and ``backward`` through
torch autograd, then the optimizer's in-place `apply_gradients`.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

__all__ = ["TrainStep", "train_step"]


class TrainStep:
    """``step(*batch)`` runs ``loss_fn(model, *batch)``, its backward and
    one optimizer update of every trainable parameter, and returns the
    loss as a detached f32 scalar.  The step counter starts at 1; the
    gradients are freed after the update."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._opt_state = None
        self._step = 0

    def __call__(self, *batch) -> torch.Tensor:
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_state(self._params)
        self._step += 1
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch).float()
        loss.backward()
        grads = {k: p.grad for k, p in self._params.items()}
        self.optimizer.apply_gradients(self._params, grads, self._opt_state,
                                       self.optimizer.get_lr(), self._step)
        for p in self._params.values():
            p.grad = None
        return loss.detach()


def train_step(model, loss_fn, optimizer):
    return TrainStep(model, loss_fn, optimizer)
