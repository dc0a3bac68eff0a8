"""Functionals (counterpart: paddle_tpu/nn/functional)."""
from ...ops.manipulation import pad
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention, multi_query_causal_mask,
                        scaled_dot_product_attention)
from .common import dropout, dropout2d, embedding, linear
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from . import activation as _activation, loss as _loss, norm as _norm

__all__ = (["pad", "flash_attention", "multi_query_causal_mask",
            "scaled_dot_product_attention", "embedding", "linear",
            "dropout", "dropout2d"] + _activation.__all__ + _loss.__all__
           + _norm.__all__)
