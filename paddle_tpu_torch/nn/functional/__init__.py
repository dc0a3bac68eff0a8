"""Functionals (counterpart: paddle_tpu/nn/functional)."""
from .activation import gelu
from .attention import (flash_attention, multi_query_causal_mask,
                        scaled_dot_product_attention)
from .common import embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "flash_attention", "multi_query_causal_mask",
           "scaled_dot_product_attention", "embedding", "linear",
           "cross_entropy", "layer_norm"]
