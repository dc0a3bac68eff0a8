"""ZeRO sharding of optimizer state, gradients and parameters (the
counterpart of the ZeRO stages of paddle_tpu/distributed/fleet/
sharded_step.py and of ``DygraphShardingOptimizer``).

The JAX package shards over its mesh's ``dp`` axis with GSPMD: moments
(stages 1 and 2) and parameters (stage 3) carry a ``dp`` sharding and
XLA inserts the reduce-scatters and all-gathers.  Here each rank of the
group holds its slice explicitly.

A `FlatShard` flattens a list of parameters, in order, into one vector
and cuts it into one contiguous range a rank.  For an elementwise update
(`Optimizer._elementwise_update`) the cut falls every ``ceil(n / ranks)``
elements and the last range is padded; for an update that reads
whole-parameter norms (Lamb, Lars, Dpsgd) each cut moves to the nearest
parameter boundary, so no parameter is split.  Communication buffers
hold ``ranks`` segments of the longest range.  A rank updates the
*pieces* of parameters inside its range: ``optimizer._update_param`` on
views, with slots of the piece's size made by ``_init_slot`` (so a
moment costs 1/ranks of the whole, plus padding), each piece taking its
parameter's decay, regularizer and learning-rate multiplier — the update
of the whole parameter, element by element.  A gradient clip reads
whole gradients through an all-reduce of each parameter's squared sum
over the pieces.  ``offload`` keeps the slots in pinned host memory and
streams each piece's slots to the card for its update and back.
"""
from __future__ import annotations

import time
from typing import List

import torch

from ...optimizer.optimizer import _lr_mult
from ...utils.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)
from ..collective import ReduceOp, _gather, _reduce_inplace, account

__all__ = ["FlatShard", "clip_views", "reduce_scatter_flat",
           "all_gather_flat"]


def _nranks(group):
    return group.nranks if group is not None else 1


def _rank(group):
    return group.rank if group is not None else 0


@torch.no_grad()
def reduce_scatter_flat(buf: torch.Tensor, group, op=ReduceOp.SUM):
    """This rank's segment of ``buf`` (``ranks`` equal segments) summed
    over ``group``: a reduce-scatter on NCCL; gloo has none, so there an
    all-reduce and the slice."""
    n = _nranks(group)
    if n <= 1:
        return buf
    import torch.distributed as dist

    seg = buf.numel() // n
    pg = group.process_group
    if dist.get_backend(pg) == "nccl":
        t0 = time.perf_counter()
        out = torch.empty(seg, dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf, group=pg)
        account(buf.numel() * buf.element_size(), t0)
    else:
        _reduce_inplace(buf, op, group)
        out = buf[group.rank * seg:(group.rank + 1) * seg].clone()
    return out


@torch.no_grad()
def all_gather_flat(seg: torch.Tensor, group) -> torch.Tensor:
    """Every rank's segment, concatenated in rank order."""
    if _nranks(group) <= 1:
        return seg
    import torch.distributed as dist

    pg = group.process_group
    if dist.get_backend(pg) == "nccl":
        t0 = time.perf_counter()
        out = torch.empty(seg.numel() * group.nranks, dtype=seg.dtype,
                          device=seg.device)
        dist.all_gather_into_tensor(out, seg.contiguous(), group=pg)
        account(out.numel() * out.element_size(), t0)
        return out
    return torch.cat(_gather(seg.contiguous(), group))


class FlatShard:
    """One rank's range of a list of named parameters flattened together
    (the module docstring)."""

    def __init__(self, named_params, group, elementwise=True):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sizes = [p.numel() for p in self.params]
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) > 1:
            raise ValueError(f"ZeRO flattens parameters of one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        self.dtype = self.params[0].dtype if self.params else torch.float32
        self.device = self.params[0].device if self.params else None
        self.group = group
        self.n, self.rank = _nranks(group), _rank(group)
        self.offsets = [0]
        for sz in self.sizes:
            self.offsets.append(self.offsets[-1] + sz)
        self.numel = self.offsets[-1]
        self.bounds = self._bounds(elementwise)
        self.seg = max(b - a for a, b in zip(self.bounds, self.bounds[1:]))
        self.lo, self.hi = self.bounds[self.rank], self.bounds[self.rank + 1]
        # (index, start, end) of every parameter's piece in this range
        self.pieces = []
        for i, (a, b) in enumerate(zip(self.offsets, self.offsets[1:])):
            s, e = max(a, self.lo), min(b, self.hi)
            if s < e:
                self.pieces.append((i, s - a, e - a))
        self.slots = None
        self.offload = False

    def _bounds(self, elementwise):
        n, total = self.n, self.numel
        if elementwise:
            step = -(-total // n) if total else 0
            return [min(r * step, total) for r in range(n)] + [total]
        out = [0]
        for r in range(1, n):
            target = r * total / n
            best = min((o for o in self.offsets if o >= out[-1]),
                       key=lambda o: abs(o - target))
            out.append(best)
        return out + [total]

    # -- layout ----------------------------------------------------------
    def to_comm(self, flat: torch.Tensor) -> torch.Tensor:
        """The flat vector in the communication layout (``ranks``
        segments of ``seg``, each range then zeros)."""
        out = flat.new_zeros(self.n * self.seg)
        for r in range(self.n):
            a, b = self.bounds[r], self.bounds[r + 1]
            out[r * self.seg:r * self.seg + b - a] = flat[a:b]
        return out

    def from_comm(self, buf: torch.Tensor) -> torch.Tensor:
        return torch.cat([buf[r * self.seg:r * self.seg + b - a]
                          for r, (a, b) in enumerate(
                              zip(self.bounds, self.bounds[1:]))])

    def flatten(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in tensors]) if tensors \
            else torch.zeros(0, dtype=self.dtype, device=self.device)

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[a:b].view(shape) for a, b, shape in
                zip(self.offsets, self.offsets[1:], self.shapes)]

    def own(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's range of a flat vector (its segment, unpadded)."""
        return flat[self.lo:self.hi]

    # -- collectives -------------------------------------------------------
    def reduce_grads(self, flat_grad: torch.Tensor) -> torch.Tensor:
        """The group's average of ``flat_grad`` over this rank's range."""
        seg = reduce_scatter_flat(self.to_comm(flat_grad), self.group)
        return seg[:self.hi - self.lo].div_(self.n)

    def gather(self, own: torch.Tensor) -> torch.Tensor:
        """The whole flat vector from every rank's range."""
        seg = own.new_zeros(self.seg)
        seg[:own.numel()] = own
        return self.from_comm(all_gather_flat(seg, self.group))

    # -- optimizer state -----------------------------------------------------
    def init_slots(self, optimizer, own: torch.Tensor, offload=False):
        """The slots of every piece (``_init_slot`` of its view), in
        pinned host memory with ``offload``."""
        self.offload = offload
        slots = []
        for i, s, e in self.pieces:
            piece = own[self.offsets[i] + s - self.lo:
                        self.offsets[i] + e - self.lo]
            if not optimizer._elementwise_update:
                piece = piece.view(self.shapes[i])
            slot = optimizer._init_slot(piece)
            if offload:
                slot = {k: _to_host(v) for k, v in slot.items()}
            slots.append(slot)
        self.slots = slots

    def slot_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for s in self.slots or []
                   for v in s.values())

    def views(self, own: torch.Tensor, grad: torch.Tensor):
        """``(parameter index, piece of own, piece of grad)`` of every
        piece in this rank's range."""
        out = []
        for i, s, e in self.pieces:
            a = self.offsets[i] + s - self.lo
            b = self.offsets[i] + e - self.lo
            out.append((i, own[a:b], grad[a:b]))
        return out

    @torch.no_grad()
    def apply(self, optimizer, own, views, lr, step):
        """Update the pieces (`views`, clipped) of ``own`` in place."""
        if self.slots is None:
            self.init_slots(optimizer, own)
        elementwise = optimizer._elementwise_update
        for (i, p, g), slot in zip(views, self.slots):
            obj = self.params[i]
            if not elementwise:
                p, g = p.view(self.shapes[i]), g.view(self.shapes[i])
            live = slot
            if self.offload:
                live = {k: v.to(p.device, non_blocking=True)
                        for k, v in slot.items()}
            g = optimizer._apply_decay(p, g.to(p.dtype), obj)
            mult = _lr_mult(obj)
            optimizer._update_param(p, g, live,
                                    lr * mult if mult != 1.0 else lr, step)
            if self.offload:
                for k, v in live.items():
                    slot[k].copy_(v, non_blocking=True)


@torch.no_grad()
def clip_views(clip, shards, groups_of_views, group):
    """Clip the pieces of several flat shards as ``clip`` clips the whole
    gradients: each parameter's squared sum is summed over its pieces
    and all-reduced over ``group``.  ``groups_of_views``: the
    `FlatShard.views` of each of ``shards``; returns them clipped."""
    if clip is None:
        return groups_of_views
    if isinstance(clip, ClipGradByValue):
        return [[(i, p, torch.clamp(g, clip.min, clip.max))
                 for i, p, g in vs] for vs in groups_of_views]
    if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
        raise TypeError(f"ZeRO cannot apply the gradient clip "
                        f"{type(clip).__name__}")
    device = next((g.device for vs in groups_of_views for _, _, g in vs),
                  torch.device("cpu"))
    counts = [len(sh.params) for sh in shards]
    sq = torch.zeros(sum(counts), dtype=torch.float32, device=device)
    base = 0
    for vs, n in zip(groups_of_views, counts):
        for i, _, g in vs:
            sq[base + i] += torch.sum(torch.square(g.float()))
        base += n
    if _nranks(group) > 1:
        _reduce_inplace(sq, ReduceOp.SUM, group)
    if isinstance(clip, ClipGradByGlobalNorm):
        scale = torch.clamp(clip.clip_norm / torch.clamp(
            torch.sqrt(sq.sum()), min=1e-12), max=1.0)
        return [[(i, p, (g.float() * scale).to(g.dtype)) for i, p, g in vs]
                for vs in groups_of_views]
    out, base = [], 0
    for vs, n in zip(groups_of_views, counts):
        row = []
        for i, p, g in vs:
            scale = torch.clamp(clip.clip_norm / torch.clamp(
                torch.sqrt(sq[base + i]), min=1e-12), max=1.0)
            row.append((i, p, (g.float() * scale).to(g.dtype)))
        out.append(row)
        base += n
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = t.detach().to("cpu")
    return h.pin_memory() if t.is_cuda else h
