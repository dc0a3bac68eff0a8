"""DistributedStrategy (counterpart: paddle_tpu/distributed/fleet/
strategy.py, copied).

The switches and their configs under the JAX package's names and
defaults: ``sharding_configs`` (``stage``, ``offload``,
``sharding_degree``), ``pipeline_configs`` (``accumulate_steps``,
``micro_batch_size``), ``tensor_parallel_configs``, ``hybrid_configs``
and the rest.  `fleet.init` and `fleet.build_train_step` read them;
``a_sync`` and ``a_sync_configs`` choose the parameter-server mode,
``expert_parallel`` and its configs are kept and ignored, as in the JAX
package.
"""
from __future__ import annotations

import json


class DistributedStrategy:
    def __init__(self):
        # the whole switch set, as in the JAX package
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                            "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "sharding_degree": 1,
                                 "segment_broadcast_MB": 32.0, "offload": False}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.sequence_parallel = False
        self.sequence_parallel_configs = {"sequence_parallel_degree": 1}
        self.expert_parallel = False
        self.expert_parallel_configs = {"expert_parallel_degree": 1}
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sp_degree": 1}
        self.lamb = False
        self.lars = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.999]}
        self.fp16_allreduce = False
        self.lookahead = False
        self.lookahead_configs = {"alpha": 0.5, "k": 5}
        self.a_sync = False
        self.a_sync_configs = {"k_steps": -1}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.elastic = False
        self.auto = False

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def save_to_prototxt(self, output):
        with open(output, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, pb_file):
        with open(pb_file) as f:
            for k, v in json.load(f).items():
                setattr(self, k, v)

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
