"""Learning-rate schedules (counterpart: paddle_tpu/optimizer/lr.py).

Only the base class is ported: an optimizer takes a constant float
learning rate or an `LRScheduler`, whose ``get_lr`` a subclass defines.
The concrete schedulers come with a later slice.
"""
from __future__ import annotations

__all__ = ["LRScheduler"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError
