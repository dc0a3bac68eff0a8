"""Neural-network layers, functionals, initializers and gradient clips
(counterpart: paddle_tpu/nn)."""
from . import functional, initializer
from ..utils.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                          ClipGradByValue)
from .layer import *  # noqa: F401,F403
from . import layer as _layer

__all__ = (["functional", "initializer", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm"] + _layer.__all__)
