"""fleet (counterpart: paddle_tpu/distributed/fleet/__init__.py): the
singleton's API at module level, the datasets and the meta-parallel
layers, as there; ``elastic`` is a submodule, as there."""
from . import meta_optimizers, meta_parallel, utils
from .base import Fleet, PaddleCloudRoleMaker, RoleMakerBase, fleet
from .dataset import (DatasetBase, DatasetFactory, InMemoryDataset,
                      QueueDataset)
from .data_parallel import DataParallel
from .pipeline_step import PipelineTrainStep
from .sharded_step import ShardedTrainStep
from .strategy import DistributedStrategy

init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
build_train_step = fleet.build_train_step
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
minimize = fleet.minimize
init_server = fleet.init_server
run_server = fleet.run_server
init_worker = fleet.init_worker
stop_worker = fleet.stop_worker
stop_server = fleet.stop_server
