"""Functionals (counterpart: paddle_tpu/nn/functional)."""
from ...ops.manipulation import pad
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention, multi_query_causal_mask,
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .sampling import *  # noqa: F401,F403
from . import (activation as _activation, common as _common, conv as _conv,
               loss as _loss, norm as _norm, pooling as _pooling,
               sampling as _sampling)

__all__ = (["pad", "flash_attention", "multi_query_causal_mask",
            "scaled_dot_product_attention"] + _activation.__all__
           + _common.__all__ + _conv.__all__ + _loss.__all__ + _norm.__all__
           + _pooling.__all__ + _sampling.__all__)
