"""Hybrid-parallel gradient sync (counterpart: paddle_tpu/distributed/
fleet/utils/hybrid_parallel_util.py).

The JAX package's functions are the identity, because XLA reduces the
gradients inside its compiled step.  Here each rank holds its own
gradients, so they are averaged, one flattened all-reduce per dtype:
`fused_allreduce_gradients` over the data-parallel group (and the
sequence-parallel one when its degree is above 1: those ranks saw other
tokens of the same samples), `sharding_reduce_gradients` over the
sharding group.  A tensor-parallel parameter's gradient is whole on its
rank already (`mp_layers`' functions), so no tensor-parallel reduction
is needed.  A gradient `DataParallel` already reduced in this backward
is left alone (`data_parallel.is_reduced`), so a script that calls both
reduces each backward once.
"""
from __future__ import annotations

import torch

from .. import data_parallel as _dp
from ...collective import ReduceOp, _reduce_inplace
from ... import parallel as _par

__all__ = ["fused_allreduce_gradients", "sharding_reduce_gradients"]


@torch.no_grad()
def _average(params, groups):
    groups = [g for g in groups if _par._dist() is not None and
              _par.get_world_size(g) > 1]
    if not groups:
        return params
    todo = [p for p in params if p.grad is not None and
            not _dp.is_reduced(p)]
    for dtype in sorted({p.grad.dtype for p in todo}, key=str):
        ps = [p for p in todo if p.grad.dtype == dtype]
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        for g in groups:
            _reduce_inplace(flat, ReduceOp.AVG, g)
        off = 0
        for p in ps:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()
            _dp.mark_reduced(p)
    return params


def fused_allreduce_gradients(parameter_list, hcg=None):
    if hcg is None:
        return _average(list(parameter_list), [None])
    groups = [hcg.get_data_parallel_group()]
    if hcg.get_sequence_parallel_world_size() > 1:
        groups.append(hcg.get_sequence_parallel_group())
    return _average(list(parameter_list), groups)


def sharding_reduce_gradients(parameter_list, hcg=None):
    """Average the gradients over the sharding group (the hybrid group's
    ``sharding`` degree, else its data-parallel axis)."""
    group = hcg.get_sharding_parallel_group() if hcg is not None else None
    return _average(list(parameter_list), [group])
