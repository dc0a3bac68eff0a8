"""The fleet singleton, its collective half (counterpart:
paddle_tpu/distributed/fleet/base.py).

``fleet.init(is_collective=True)`` joins the process group
(`init_parallel_env`) and builds the `HybridCommunicateGroup` of the
strategy's ``hybrid_configs`` (``dp_degree``, ``mp_degree``,
``pp_degree``, ``sp_degree``, ``sharding_degree``; all 1: data parallel
over every rank); ``distributed_model`` returns `PipelineParallel` for a
`PipelineLayer`, `TensorParallel` under ``mp > 1`` and `DataParallel`
otherwise; ``distributed_optimizer`` stacks the strategy's
meta-optimizers (`StrategyCompiler`); ``build_train_step`` gives the
1F1B `PipelineTrainStep` for a `PipelineLayer` under ``pp > 1``, else
the `ShardedTrainStep` of the strategy (ZeRO ``stage`` and ``offload``
from ``sharding_configs``, gradient merge's ``k_steps``, recompute).
Not ported, and refused with NotImplementedError: expert parallelism
(``moe_layer``: ROADMAP.md Queue 1, item 2) and the parameter-server
half (``is_collective=False``, a server role, ``a_sync``,
``init_server`` / ``init_worker`` ...: the ``distributed/ps`` slice,
the same item).
"""
from __future__ import annotations

import os
from typing import Optional

from .. import parallel as _par
from ..topology import (HybridCommunicateGroup,
                        set_hybrid_communicate_group)
from .strategy import DistributedStrategy

__all__ = ["Fleet", "RoleMakerBase", "PaddleCloudRoleMaker", "fleet"]

_PS = ("the parameter-server runtime comes with the distributed/ps slice "
       "of paddle_tpu_torch (ROADMAP.md Queue 1, item 2)")
_MOE = ("expert parallelism (meta_parallel.moe_layer) is not ported yet: "
        "it comes with ROADMAP.md Queue 1, item 2")


class RoleMakerBase:
    def __init__(self, is_collective=True):
        self._is_collective = is_collective

    def worker_index(self):
        return _par.get_rank()

    def worker_num(self):
        return _par.get_world_size()

    def is_worker(self):
        return True

    def is_server(self):
        return False


class PaddleCloudRoleMaker(RoleMakerBase):
    """The ``PADDLE_*`` environment's view of this process, the
    parameter-server role split included (``TRAINING_ROLE``,
    ``PADDLE_PSERVERS_IP_PORT_LIST``, ``PADDLE_PORT``)."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__(is_collective)
        self._trainer_id = int(os.environ.get("PADDLE_TRAINER_ID",
                                              _par.get_rank()))
        self._trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                                _par.get_world_size()))
        self._role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in eps.split(",") if e]
        self._current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT",
            "127.0.0.1:" + os.environ.get("PADDLE_PORT", "0"))

    def worker_index(self):
        return self._trainer_id

    def worker_num(self):
        return self._trainers_num

    def is_worker(self):
        return self._role == "TRAINER"

    def is_server(self):
        return self._role == "PSERVER"

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def server_index(self):
        try:
            return self._server_endpoints.index(self._current_endpoint)
        except ValueError:
            return 0


def _refuse_unported(st: DistributedStrategy):
    if getattr(st, "expert_parallel", False) or int(
            st.expert_parallel_configs.get("expert_parallel_degree", 1)) > 1:
        raise NotImplementedError(_MOE)


def _degrees(st: DistributedStrategy):
    h = st.hybrid_configs
    mp = int(h.get("mp_degree", 1))
    if st.tensor_parallel:
        mp = max(mp, int(st.tensor_parallel_configs.get(
            "tensor_parallel_degree", 1)))
    sp = int(h.get("sp_degree", 1))
    if st.sequence_parallel:
        sp = max(sp, int(st.sequence_parallel_configs.get(
            "sequence_parallel_degree", 1)))
    sharding = int(h.get("sharding_degree", 1))
    if st.sharding:
        sharding = max(sharding, int(st.sharding_configs.get(
            "sharding_degree", 1)))
    return dict(dp=int(h.get("dp_degree", 1)), mp=mp,
                pp=int(h.get("pp_degree", 1)), sp=sp, sharding=sharding)


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._user_optimizer = None
        self._applied_meta_optimizers = []

    # -- lifecycle ----------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        strategy = strategy or DistributedStrategy()
        if not is_collective or role_maker.is_server() or strategy.a_sync:
            raise NotImplementedError(_PS)
        _refuse_unported(strategy)
        self._role_maker, self._strategy = role_maker, strategy
        _par.init_parallel_env()
        d = _degrees(strategy)
        world = _par.get_world_size()
        if d["dp"] == 1 and d["sharding"] <= 1 and \
                d["mp"] * d["pp"] * d["sp"] < world:
            d["dp"] = world // (d["mp"] * d["pp"] * d["sp"])
        dp = d["dp"] * max(d["sharding"], 1)
        self._hcg = HybridCommunicateGroup(dp=dp, pp=d["pp"], sp=d["sp"],
                                           mp=d["mp"],
                                           sharding=d["sharding"])
        set_hybrid_communicate_group(self._hcg)
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def mesh(self):
        return self._hcg.mesh if self._hcg else None

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    # -- strategy wiring ----------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            _refuse_unported(strategy)
            self._strategy = strategy
        st = self._strategy or DistributedStrategy()
        from .meta_optimizers import StrategyCompiler

        optimizer, applied = StrategyCompiler().generate_optimizer(
            optimizer, st)
        self._applied_meta_optimizers = applied
        self._user_optimizer = optimizer
        return optimizer

    def distributed_model(self, model):
        from .data_parallel import DataParallel
        from .meta_parallel.mp_layers import TensorParallel
        from .meta_parallel.pipeline_parallel import (PipelineLayer,
                                                      PipelineParallel)

        if self._hcg is None:
            self.init()
        st = self._strategy
        if isinstance(model, PipelineLayer):
            return PipelineParallel(model, self._hcg, st)
        if self._hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, self._hcg, st)
        return DataParallel(model, strategy=st,
                            comm_buffer_size=st.fuse_grad_size_in_MB,
                            find_unused_parameters=st.find_unused_parameters,
                            hcg=self._hcg)

    def build_train_step(self, model, loss_fn, optimizer=None):
        """The strategy's step over the global batch: the 1F1B
        `PipelineTrainStep` for a `PipelineLayer` under ``pp > 1``
        (``loss_fn(output, label)``; ``accumulate_steps`` micro-batches
        with ``strategy.pipeline``, else ``pp``), else `ShardedTrainStep`
        (``loss_fn(model, *batch)``)."""
        from .meta_optimizers import MetaOptimizerBase
        from .meta_parallel.pipeline_parallel import PipelineLayer
        from .sharded_step import ShardedTrainStep

        if self._hcg is None:
            self.init()
        opt = optimizer or self._user_optimizer
        while isinstance(opt, MetaOptimizerBase):
            opt = opt.inner  # the step merges and reduces by itself
        st = self._strategy
        _refuse_unported(st)
        inner = model.network if hasattr(model, "network") else model
        inner = getattr(inner, "_layers", inner)
        pp = self._hcg.get_pipe_parallel_world_size()
        if pp > 1 and isinstance(inner, PipelineLayer):
            from .pipeline_step import PipelineTrainStep

            n_micro = int(st.pipeline_configs.get("accumulate_steps", pp)) \
                if st.pipeline else pp
            return PipelineTrainStep(inner, loss_fn, opt, self._hcg,
                                     n_micro=n_micro)
        k = int(st.gradient_merge_configs.get("k_steps", 1)) \
            if st.gradient_merge else 1
        zero = int(st.sharding_configs.get("stage", 1)) if st.sharding \
            else 0
        offload = bool(st.sharding and
                       st.sharding_configs.get("offload", False))
        return ShardedTrainStep(
            inner, loss_fn, opt, self._hcg.mesh, zero_stage=zero,
            grad_accum=k, recompute=bool(st.recompute), offload=offload,
            recompute_checkpoints=st.recompute_configs.get("checkpoints")
            if st.recompute else None, hcg=self._hcg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._user_optimizer is None:
            raise RuntimeError("call fleet.distributed_optimizer first")
        return self._user_optimizer.minimize(loss)

    # -- the parameter-server half ------------------------------------------
    def init_server(self, *args, **kwargs):
        raise NotImplementedError(_PS)

    run_server = stop_server = init_worker = stop_worker = init_server


fleet = Fleet()
