"""Layers (counterpart: paddle_tpu/nn/layer)."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .layers import Layer, Parameter
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from . import (activation as _activation, common as _common,
               container as _container, conv as _conv, loss as _loss,
               norm as _norm, pooling as _pooling, rnn as _rnn)

__all__ = (["Layer", "Parameter", "MultiHeadAttention", "Transformer",
            "TransformerDecoder", "TransformerDecoderLayer",
            "TransformerEncoder", "TransformerEncoderLayer"]
           + _activation.__all__ + _common.__all__ + _container.__all__
           + _conv.__all__ + _loss.__all__ + _norm.__all__
           + _pooling.__all__ + _rnn.__all__)
