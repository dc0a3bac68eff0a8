"""``paddle.distributed`` (counterpart: paddle_tpu/distributed/): ranks
as processes over ``torch.distributed`` — the parallel environment, the
collectives, ``spawn`` and ``launch``, the hybrid topology (data,
pipeline, sequence, tensor and sharding groups), ``DataParallel``,
``split`` and ``fleet``'s collective half (tensor, pipeline and ZeRO
parallelism).  The parameter server (``ps``) and expert parallelism are
not ported."""
from . import collective
from .collective import (Group, ReduceOp, all_gather, all_gather_object,
                         all_reduce, alltoall, barrier, broadcast, irecv,
                         isend, new_group, recv, reduce, reduce_scatter,
                         scatter, send, split, wait)
from .parallel import (ParallelEnv, get_rank, get_world_size,
                       init_parallel_env)
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       build_mesh, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from . import fleet
from .fleet.data_parallel import DataParallel
from .spawn import spawn

__all__ = ["collective", "Group", "ReduceOp", "all_gather",
           "all_gather_object", "all_reduce", "alltoall", "barrier",
           "broadcast", "irecv", "isend", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split", "wait",
           "ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "CommunicateTopology", "HybridCommunicateGroup", "build_mesh",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group",
           "fleet", "DataParallel", "spawn"]
