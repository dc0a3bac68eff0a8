"""Common functionals: linear and embedding (counterpart:
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` [in_features, out_features]
    (paddle's layout).  A WHITE op under `amp.auto_cast`."""
    x, weight, bias = amp.cast_inputs(amp.WHITE, x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` [num, dim] at the integer ids ``x``."""
    return torch.nn.functional.embedding(x.long(), weight)
