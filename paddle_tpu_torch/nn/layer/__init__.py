"""Layers (counterpart: paddle_tpu/nn/layer)."""
from .common import Dropout, Embedding, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "LayerList"]
