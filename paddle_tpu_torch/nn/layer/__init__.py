"""Layers (counterpart: paddle_tpu/nn/layer)."""
from .common import Dropout, Embedding, Linear
from .container import LayerList
from .layers import Layer
from .loss import CrossEntropyLoss
from .norm import LayerNorm

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "CrossEntropyLoss"]
