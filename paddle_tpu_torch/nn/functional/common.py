"""Common functionals: linear, embedding and dropout (counterpart:
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ... import amp
from ...core.framework import generator_for

__all__ = ["linear", "embedding", "dropout", "dropout2d"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` [in_features, out_features]
    (paddle's layout).  A WHITE op under `amp.auto_cast`."""
    x, weight, bias = amp.cast_inputs(amp.WHITE, x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` [num, dim] at the integer ids ``x``."""
    return torch.nn.functional.embedding(x.long(), weight)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (with ``axis``, whole
    slices: the mask has size 1 on every other axis).  ``upscale_in_train``
    scales the kept elements by ``1 / (1 - p)`` in training and is the
    identity otherwise; ``downscale_in_infer`` keeps them as they are in
    training and scales by ``1 - p`` otherwise.  The mask is drawn from
    the default generator of ``x``'s device (`core.framework.seed`), so
    one seed draws the same masks; drawing inside a CUDA-graph capture
    raises."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0:
        if mode == "downscale_in_infer" and p > 0:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=generator_for(x.device),
                   device=x.device)
    keep = u < (1.0 - p)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)

