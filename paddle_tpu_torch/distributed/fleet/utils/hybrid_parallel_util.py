"""Hybrid-parallel gradient sync (counterpart: paddle_tpu/distributed/
fleet/utils/hybrid_parallel_util.py).

The JAX package's `fused_allreduce_gradients` is the identity, because
XLA reduces the gradients inside its compiled step.  Here each rank
holds its own gradients, so it averages them over the data-parallel
group, one flattened all-reduce per dtype.  A gradient `DataParallel`
already reduced in this backward is left alone (`data_parallel.
is_reduced`), so a script that calls both reduces each backward once.
"""
from __future__ import annotations

import torch

from .. import data_parallel as _dp
from ...collective import ReduceOp, _reduce_inplace
from ... import parallel as _par

__all__ = ["fused_allreduce_gradients", "sharding_reduce_gradients"]


@torch.no_grad()
def fused_allreduce_gradients(parameter_list, hcg=None):
    group = hcg.get_data_parallel_group() if hcg is not None else None
    params = list(parameter_list)
    if _par._dist() is None or _par.get_world_size(group) <= 1:
        return params
    todo = [p for p in params if p.grad is not None and
            not _dp.is_reduced(p)]
    for dtype in sorted({p.grad.dtype for p in todo}, key=str):
        ps = [p for p in todo if p.grad.dtype == dtype]
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        _reduce_inplace(flat, ReduceOp.AVG, group)
        off = 0
        for p in ps:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()
            _dp.mark_reduced(p)
    return params


def sharding_reduce_gradients(parameter_list, hcg=None):
    """ZeRO's gradient reduction: not ported (ROADMAP.md Queue 1, item
    2)."""
    raise NotImplementedError(
        "sharding_reduce_gradients belongs to ZeRO sharding, which comes "
        "with ROADMAP.md Queue 1, item 2")
