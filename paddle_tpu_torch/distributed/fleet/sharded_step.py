"""The sharded train step (counterpart: paddle_tpu/distributed/fleet/
sharded_step.py, `fleet.build_train_step`'s step).

The JAX package compiles one step over a mesh: the global batch sharded
over ``dp``, XLA's gradient all-reduce, ``grad_accum`` micro-batches in
a scan, ``recompute`` as ``jax.checkpoint`` around the blocks, ZeRO as
``dp`` shardings of the moments (stages 1, 2) and parameters (stage 3).
Here a step takes the same global batch on every rank and:

1. cuts it into ``grad_accum`` micro-batches along dim 0, and each
   micro-batch into one slice a data-parallel rank (the hybrid group's
   ``dp`` axis: the ranks of one tensor-parallel group take the same
   slice);
2. runs each slice's forward and backward, the gradients accumulating;
3. divides them by ``grad_accum`` and averages them over the
   data-parallel group only (a tensor-parallel parameter's gradient is
   already whole on its rank: `mp_layers`' functions reduce what
   crosses the group);
4. applies the optimizer's staged update (`apply_gradients`, slots of
   the step's own, as `jit.TrainStep`);

and returns the loss averaged over micro-batches and ranks, the same on
every rank.  So a script written for the JAX package's step runs
unchanged and, from the same weights and batch, gives its numbers.
With ``recompute`` each block (``recompute_checkpoints``'s sublayers by
name, else every direct child with parameters, a container's children
in its place) runs under `utils.recompute` inside the step only.

ZeRO (`fleet.zero`): ``zero_stage`` 1 keeps each data-parallel rank's
moments for its 1/dp range of the flattened parameters; the gradients
are all-reduced, each rank updates its range and the ranges are
all-gathered back into the parameters.  Stage 2 reduce-scatters the
gradients instead (gloo has no reduce-scatter: there an all-reduce and
the slice) and frees them.  Stage 3 also holds the parameters as 1/dp
ranges between steps: each *block* — a child of a layer list or a
sequential container at the model's top level — keeps its parameters'
range as the leaf, and its forward, under `utils.recompute`, all-gathers
them inside (`GatherShard`, whose backward reduce-scatters the
gradient), so a block's parameters are gathered for its forward and
again for its backward's replay; the other parameters (embeddings, a
final norm, a head that reads the embedding) are gathered once for the
whole step, because the model may read them outside their own module
(GPT's tied head reads ``wte``).  ``offload`` keeps the moments in
pinned host memory and streams each piece to the card for its update
(with ``zero_stage`` 0, over one rank's whole range).  `sync_params`
writes stage 3's whole parameters back into the model.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...optimizer.optimizer import collect_lr_mults
from ..collective import Group, ReduceOp, all_reduce
from ..topology import get_hybrid_communicate_group
from .utils.hybrid_parallel_util import fused_allreduce_gradients
from .utils.recompute import recompute
from .zero import FlatShard, clip_views

__all__ = ["ShardedTrainStep", "GatherShard"]

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


class GatherShard(torch.autograd.Function):
    """Forward: every rank's range of a `FlatShard` all-gathered into the
    whole flat vector; backward: the gradient reduce-scattered (averaged
    over the group) back onto this rank's range."""

    @staticmethod
    def forward(ctx, own, shard):
        ctx.shard = shard
        return shard.gather(own.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.reduce_grads(g.contiguous()), None


# inside a stage-3 block's functional call: the block's own forward runs
_BYPASS = [0]


def _zero3_blocks(model: nn.Module):
    """``(name, module)`` of every child of a layer list or sequential
    container that is the model or one of its direct children."""
    containers = (nn.ModuleList, nn.Sequential)
    roots = [("", model)] if isinstance(model, containers) else []
    roots += [(n, c) for n, c in model.named_children()
              if isinstance(c, containers)]
    out = []
    for prefix, c in roots:
        for n, m in c.named_children():
            if any(True for _ in m.parameters()):
                out.append((f"{prefix}.{n}" if prefix else n, m))
    return out


class _Zero3Block:
    """A stage-3 block: its parameters' `FlatShard`, this rank's range
    (the leaf the optimizer updates) and the wrapped forward."""

    def __init__(self, module, prefix, group, elementwise):
        self.module = module
        named = list(module.named_parameters())
        self.local = [n for n, _ in named]
        self.shard = FlatShard([(f"{prefix}.{n}", p) for n, p in named],
                               group, elementwise)
        flat = self.shard.flatten([p.detach() for _, p in named])
        self.own = self.shard.own(flat).clone().requires_grad_(True)
        orig = module.forward

        def forward(*args, **kwargs):
            if _BYPASS[0] or not _IN_STEP[0]:
                return orig(*args, **kwargs)
            if torch.is_grad_enabled():
                return recompute(self._run, self.own, *args, **kwargs)
            return self._run(self.own, *args, **kwargs)

        module.forward = forward

    def _run(self, own, *args, **kwargs):
        full = GatherShard.apply(own, self.shard)
        tensors = dict(zip(self.local, self.shard.unflatten(full)))
        _BYPASS[0] += 1
        try:
            return torch.func.functional_call(self.module, tensors, args,
                                              kwargs)
        finally:
            _BYPASS[0] -= 1


def _release(params):
    for p in params:
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        p.grad = None


class ShardedTrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 zero_stage: int = 0, grad_accum: int = 1,
                 batch_axis: str = "dp", donate: bool = True,
                 loss_dtype=None, recompute: bool = False,
                 offload: bool = False, recompute_checkpoints=None,
                 hcg=None):
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0, 1, 2 or 3, got "
                             f"{zero_stage}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.zero_stage = int(zero_stage)
        self.offload = bool(offload)
        self.grad_accum = max(1, int(grad_accum))
        self.recompute = recompute
        self._hcg = hcg if hcg is not None else \
            get_hybrid_communicate_group()
        self._group = self._hcg.get_data_parallel_group() \
            if self._hcg is not None else Group("dp", None)
        if recompute:
            _wrap_recompute_blocks(model, list(recompute_checkpoints or []))
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._lr_mults = collect_lr_mults(self._params)
        self._opt_state = None
        self._step = 0
        self._shards = []
        self._blocks = []
        self._rest = None
        if self.zero_stage or self.offload:
            self._init_zero()

    # -- ZeRO state ----------------------------------------------------------
    def _init_zero(self):
        ew = getattr(self.optimizer, "_elementwise_update", True)
        group = self._group if self.zero_stage else None
        if self.zero_stage < 3:
            self._rest = FlatShard(list(self._params.items()), group, ew)
            self._shards = [self._rest]
            return
        in_block = set()
        for name, mod in _zero3_blocks(self.model):
            blk = _Zero3Block(mod, name, group, ew)
            self._blocks.append(blk)
            in_block.update(id(p) for p in blk.shard.params)
        rest = [(k, p) for k, p in self._params.items()
                if id(p) not in in_block]
        self._rest = FlatShard(rest, group, ew)
        self._rest_own = self._rest.own(self._rest.flatten(
            [p.detach() for _, p in rest])).clone()
        self._shards = [b.shard for b in self._blocks] + [self._rest]
        for b in self._blocks:
            _release(b.shard.params)
        _release(self._rest.params)

    def _stage3_gather_rest(self):
        full = self._rest.gather(self._rest_own)
        for p, t in zip(self._rest.params, self._rest.unflatten(full)):
            p.data = t

    def sync_params(self):
        """Stage 3: write the whole parameters back into the model (for
        evaluation, `state_dict` or a save); the next step releases them
        again.  Other stages hold them whole already."""
        if self.zero_stage < 3:
            return
        with torch.no_grad():
            for b in self._blocks:
                full = b.shard.gather(b.own.detach())
                for p, t in zip(b.shard.params, b.shard.unflatten(full)):
                    p.data = t.clone()
            self._stage3_gather_rest()

    def state_dict(self):
        self.sync_params()
        return self.model.state_dict()

    def at_rest_bytes(self) -> dict:
        """Bytes this rank holds between steps: the parameters (stage 3:
        its ranges) and the optimizer's slots, on the card and on the
        host."""
        if self.zero_stage == 3:
            params = sum(t.numel() * t.element_size() for t in
                         [b.own for b in self._blocks] + [self._rest_own])
        else:
            params = sum(p.numel() * p.element_size()
                         for p in self._params.values())
        if self._shards:
            slots = sum(s.slot_bytes() for s in self._shards)
        else:
            slots = sum(v.numel() * v.element_size()
                        for st in (self._opt_state or {}).values()
                        for v in st.values())
        host = slots if self.offload else 0
        return {"params": params, "slots": slots - host,
                "host_slots": host}

    # -- the step ----------------------------------------------------------------
    def _slices(self, batch):
        n, r = self._group.nranks, self._group.rank
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
        self._step += 1
        for p in self._params.values():
            p.grad = None
        if self.zero_stage == 3:
            self._stage3_gather_rest()
            for b in self._blocks:
                _release(b.shard.params)  # after a sync_params
                b.own.grad = None
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
                for p in list(self._params.values()) + \
                        [b.own for b in self._blocks]:
                    if p.grad is not None:
                        p.grad.div_(k)
            total = total / k
        all_reduce(total, op=ReduceOp.AVG, group=self._group)
        if self._shards:
            self._zero_update()
            return total
        fused_allreduce_gradients(list(self._params.values()), self._hcg)
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_state(self._params)
        grads = {n: p.grad for n, p in self._params.items()}
        self.optimizer.apply_gradients(self._params, grads, self._opt_state,
                                       self.optimizer.get_lr(), self._step,
                                       lr_mults=self._lr_mults)
        for p in self._params.values():
            p.grad = None
        return total

    @torch.no_grad()
    def _zero_update(self):
        opt, lr = self.optimizer, self.optimizer.get_lr()
        rest = self._rest
        flat_g = rest.flatten([p.grad if p.grad is not None
                               else torch.zeros_like(p)
                               for p in rest.params])
        if self.zero_stage in (0, 1):
            # whole gradients, all-reduced (stage 0: offload alone, over a
            # range that is the whole vector)
            all_reduce(flat_g, op=ReduceOp.AVG, group=self._group)
            g_rest = rest.own(flat_g)
        else:
            g_rest = rest.reduce_grads(flat_g)
        if self.zero_stage == 3:
            own_rest = self._rest_own
            _release(rest.params)
        else:
            own_rest = rest.own(rest.flatten(
                [p.detach() for p in rest.params])).clone()
            for p in rest.params:
                p.grad = None
        owns = [b.own for b in self._blocks] + [own_rest]
        grads = [b.own.grad if b.own.grad is not None
                 else torch.zeros_like(b.own) for b in self._blocks] + \
            [g_rest]
        for s, own in zip(self._shards, owns):
            if s.slots is None:
                s.init_slots(opt, own, self.offload)
        views = clip_views(opt._grad_clip, self._shards,
                           [s.views(o, g) for s, o, g in
                            zip(self._shards, owns, grads)],
                           self._group if self.zero_stage else None)
        for s, own, v in zip(self._shards, owns, views):
            s.apply(opt, own, v, lr, self._step)
        for b in self._blocks:
            b.own.grad = None
        if self.zero_stage < 3:
            full = rest.gather(own_rest)
            for p, t in zip(rest.params, rest.unflatten(full)):
                p.copy_(t)
