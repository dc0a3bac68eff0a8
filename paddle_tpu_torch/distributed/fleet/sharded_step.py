"""The data-parallel train step (counterpart: the data-parallel part of
paddle_tpu/distributed/fleet/sharded_step.py, `fleet.build_train_step`'s
step).

The JAX package compiles one step over a mesh: the global batch sharded
over ``dp``, XLA's gradient all-reduce, ``grad_accum`` micro-batches in
a scan, ``recompute`` as ``jax.checkpoint`` around the blocks.  Here a
step takes the same global batch on every rank and:

1. cuts it into ``grad_accum`` micro-batches along dim 0, and each
   micro-batch into one slice a rank (rank *r* the *r*-th);
2. runs each slice's forward and backward, the gradients accumulating;
3. divides them by ``grad_accum`` and averages them over the ranks
   (`fused_allreduce_gradients`);
4. applies the optimizer's staged update (`apply_gradients`, slots of
   the step's own, as `jit.TrainStep`);

and returns the loss averaged over micro-batches and ranks, the same on
every rank.  So a script written for the JAX package's step runs
unchanged and, from the same weights and batch, gives its numbers.
With ``recompute`` each block (``recompute_checkpoints``'s sublayers by
name, else every direct child with parameters, a container's children
in its place) runs under `utils.recompute` inside the step only.  ZeRO
stages, offload and tensor-parallel parameters raise
NotImplementedError (ROADMAP.md Queue 1, item 2).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...optimizer.optimizer import collect_lr_mults
from ..collective import ReduceOp, all_reduce
from .. import parallel as _par
from .utils.hybrid_parallel_util import fused_allreduce_gradients
from .utils.recompute import recompute

__all__ = ["ShardedTrainStep"]

_LATER = "ROADMAP.md Queue 1, item 2"

# steps running now: a wrapped block recomputes only inside one
_IN_STEP = [0]


def _recompute_targets(model: nn.Module, names):
    if names:
        wanted = set(names)
        return [m for n, m in model.named_modules() if n in wanted]
    out = []
    for _, child in model.named_children():
        if not any(True for _ in child.parameters()):
            continue
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            out.extend(c for c in child.children()
                       if any(True for _ in c.parameters()))
        else:
            out.append(child)
    return out


def _wrap_recompute_blocks(model, names):
    for ly in _recompute_targets(model, names):
        if getattr(ly, "_recompute_wrapped", False):
            continue
        orig = ly.forward

        def forward(*args, __orig=orig, **kwargs):
            if _IN_STEP[0] and torch.is_grad_enabled():
                return recompute(__orig, *args, **kwargs)
            return __orig(*args, **kwargs)

        ly.forward = forward
        ly._recompute_wrapped = True


class ShardedTrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 zero_stage: int = 0, grad_accum: int = 1,
                 batch_axis: str = "dp", donate: bool = True,
                 loss_dtype=None, recompute: bool = False,
                 offload: bool = False, recompute_checkpoints=None,
                 hcg=None):
        if zero_stage:
            raise NotImplementedError(
                f"ZeRO stage {zero_stage} comes with {_LATER}")
        if offload:
            raise NotImplementedError(
                f"optimizer-state offload comes with {_LATER}")
        if any(getattr(p, "mesh_axes", None) for p in model.parameters()):
            raise NotImplementedError(
                f"tensor-parallel parameters (mesh_axes) come with {_LATER}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.grad_accum = max(1, int(grad_accum))
        self.recompute = recompute
        self._hcg = hcg
        if recompute:
            _wrap_recompute_blocks(model, list(recompute_checkpoints or []))
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._lr_mults = collect_lr_mults(self._params)
        self._opt_state = None
        self._step = 0

    def _slices(self, batch):
        n = _par.get_world_size()
        r = _par.get_rank()
        k = self.grad_accum
        b = batch[0].shape[0]
        if b % (k * n):
            raise ValueError(f"global batch {b} is not divisible by "
                             f"grad_accum {k} x {n} ranks")
        m, s = b // k, b // (k * n)
        for i in range(k):
            yield [t[i * m + r * s:i * m + (r + 1) * s] for t in batch]

    def __call__(self, *batch) -> torch.Tensor:
        batch = [b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
                 for b in batch]
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_state(self._params)
        self._step += 1
        for p in self._params.values():
            p.grad = None
        total = None
        _IN_STEP[0] += 1
        try:
            for shard in self._slices(batch):
                loss = self.loss_fn(self.model, *shard).float()
                loss.backward()
                total = loss.detach() if total is None else \
                    total + loss.detach()
        finally:
            _IN_STEP[0] -= 1
        k = self.grad_accum
        if k > 1:
            with torch.no_grad():
                for p in self._params.values():
                    if p.grad is not None:
                        p.grad.div_(k)
            total = total / k
        fused_allreduce_gradients(list(self._params.values()), self._hcg)
        all_reduce(total, op=ReduceOp.AVG)
        grads = {n: p.grad for n, p in self._params.items()}
        self.optimizer.apply_gradients(self._params, grads, self._opt_state,
                                       self.optimizer.get_lr(), self._step,
                                       lr_mults=self._lr_mults)
        for p in self._params.values():
            p.grad = None
        return total
