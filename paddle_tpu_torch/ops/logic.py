"""Comparison, logical and bitwise ops (counterpart:
paddle_tpu/ops/logic.py).

``equal`` is elementwise, as Paddle's (``torch.equal`` compares whole
tensors, which is ``equal_all`` here); ``equal_all``, ``is_empty`` and
``all``/``any`` return bool tensors on the input's device.
"""
from __future__ import annotations

import torch

from ._util import axes, pair

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal_all", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "all", "any", "is_empty",
           "is_tensor"]


def _cmp(tfn):
    def op(x, y, name=None):
        return tfn(*pair(x, y))

    return op


def _logic(tfn):
    def op(x, y, out=None, name=None):
        return tfn(*pair(x, y))

    return op


equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
less_than = _cmp(torch.lt)
less_equal = _cmp(torch.le)
greater_than = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
logical_and = _logic(torch.logical_and)
logical_or = _logic(torch.logical_or)
logical_xor = _logic(torch.logical_xor)
bitwise_and = _logic(torch.bitwise_and)
bitwise_or = _logic(torch.bitwise_or)
bitwise_xor = _logic(torch.bitwise_xor)


def equal_all(x, y, name=None):
    x, y = pair(x, y)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.all(x == y)


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


def all(x, axis=None, keepdim=False, name=None):
    return torch.all(x.bool(), dim=axes(axis, x.dim()), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return torch.any(x.bool(), dim=axes(axis, x.dim()), keepdim=keepdim)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
