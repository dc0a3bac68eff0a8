"""Linear, Embedding and Dropout layers (counterpart:
paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.common import embedding, linear

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` [in_features,
    out_features] (paddle's layout), initialized as paddle does: Xavier
    uniform weight, zero bias; ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(
            in_features, out_features, device=device, dtype=dtype)))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=device, dtype=dtype))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """A lookup table [num_embeddings, embedding_dim], initialized N(0, 1)
    as paddle does."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, x):
        return embedding(x, self.weight)


class Dropout(nn.Module):
    """Identity at ``p == 0`` or in eval mode.  Dropout with ``p > 0`` in
    training raises: the JAX package draws its mask from ``jax.random``,
    whose bits torch cannot reproduce, and no ported configuration uses
    dropout."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if self.training and self.p > 0:
            raise NotImplementedError(
                f"Dropout(p={self.p}) in training is not ported yet: it "
                "lands with the eager-core slice of paddle_tpu_torch")
        return x
