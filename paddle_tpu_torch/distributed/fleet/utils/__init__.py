from .recompute import recompute
from .hybrid_parallel_util import (fused_allreduce_gradients,
                                   sharding_reduce_gradients)
