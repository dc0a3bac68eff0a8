"""Layers (counterpart: paddle_tpu/nn/layer)."""
from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Linear
from .container import LayerList
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from . import activation as _activation, loss as _loss, norm as _norm

__all__ = (["Layer", "Linear", "Embedding", "Dropout", "LayerList"]
           + _activation.__all__ + _loss.__all__ + _norm.__all__)
