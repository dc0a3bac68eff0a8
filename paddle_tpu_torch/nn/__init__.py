"""Neural-network layers, functionals, initializers, gradient clips,
weight reparameterizations and beam search (counterpart:
paddle_tpu/nn)."""
from . import functional, initializer, utils
from ..utils.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                          ClipGradByValue)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import *  # noqa: F401,F403
from . import layer as _layer

__all__ = (["functional", "initializer", "utils", "ClipGradByValue",
            "ClipGradByNorm", "ClipGradByGlobalNorm", "BeamSearchDecoder",
            "dynamic_decode"] + _layer.__all__)
