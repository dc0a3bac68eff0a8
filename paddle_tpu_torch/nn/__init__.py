"""Neural-network layers, functionals, initializers and gradient clips
(counterpart: paddle_tpu/nn)."""
from . import functional, initializer
from ..utils.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                          ClipGradByValue)
from .layer import (CrossEntropyLoss, Dropout, Embedding, Layer, LayerList,
                    LayerNorm, Linear)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "Dropout", "LayerNorm", "LayerList", "CrossEntropyLoss",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
