"""Tensor, pipeline and expert parallelism (counterpart: paddle_tpu/
distributed/fleet/meta_parallel/)."""
from .moe_layer import MoELayer, moe_forward, moe_gating
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, TensorParallel,
                        VocabParallelEmbedding)
from .pipeline_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                                SegmentLayers, SharedLayerDesc)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "TensorParallel", "VocabParallelEmbedding",
           "LayerDesc", "PipelineLayer", "PipelineParallel",
           "SegmentLayers", "SharedLayerDesc", "MoELayer", "moe_forward",
           "moe_gating"]
