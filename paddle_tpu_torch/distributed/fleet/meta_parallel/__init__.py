"""Tensor and pipeline parallelism (counterpart: paddle_tpu/distributed/
fleet/meta_parallel/).  ``moe_layer`` is not ported (ROADMAP.md Queue 1,
item 2)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, TensorParallel,
                        VocabParallelEmbedding)
from .pipeline_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                                SegmentLayers, SharedLayerDesc)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "TensorParallel", "VocabParallelEmbedding",
           "LayerDesc", "PipelineLayer", "PipelineParallel",
           "SegmentLayers", "SharedLayerDesc"]
