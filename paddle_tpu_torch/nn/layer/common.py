"""Linear, Embedding and Dropout layers (counterpart:
paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import torch

from .. import initializer as init
from ..functional.common import dropout, embedding, linear
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` [in_features,
    out_features] (paddle's layout), drawn as the JAX package draws it:
    Xavier-uniform weight, zero bias, unless ``weight_attr`` /
    ``bias_attr`` name another initializer; ``bias_attr=False`` drops the
    bias.  On ``device`` (default: the card); "meta" draws nothing."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr, dtype=dtype,
            default_initializer=init.XavierUniform(), device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Embedding(Layer):
    """A lookup table [num_embeddings, embedding_dim], drawn N(0, 1) as
    the JAX package's ``nn.Embedding`` draws it (``weight_attr`` may name
    another initializer)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, dtype=dtype,
            default_initializer=init.Normal(0.0, 1.0), device=device)

    def forward(self, x):
        return embedding(x, self.weight)


class Dropout(Layer):
    """`functional.dropout` in training; in eval mode the identity
    (``upscale_in_train``) or the scale by the keep rate
    (``downscale_in_infer``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

