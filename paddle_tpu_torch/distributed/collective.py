"""Collectives (counterpart: paddle_tpu/distributed/collective.py).

A rank is a process of the default ``torch.distributed`` group
(`parallel.init_parallel_env`), as in the JAX package's multi-controller
mode (``_cross_process``).  The results are that mode's:

* `all_reduce` writes the reduced value into ``tensor`` in place (JAX's
  ``set_value``) and returns it; ``AVG`` is the sum divided by the
  group's size, ``PROD`` the product;
* `reduce` is `all_reduce`: every rank receives the result, not only
  ``dst``;
* `all_gather` appends each rank's tensor to ``tensor_list`` and returns
  them stacked, ``[nranks, ...]`` in rank order;
* `broadcast` writes ``src``'s value into ``tensor`` on every rank.

The JAX package has no cross-process form of `reduce_scatter`, `scatter`,
`alltoall` and the point-to-point calls; here they have Paddle's
semantics: rank *r* receives the reduced ``tensor_list[r]`` (or the
*r*-th chunk of the reduced ``tensor``), ``src``'s ``tensor_list[r]``,
every rank's ``in_tensor_list[r]``, and the peer's tensor.  `alltoall`
is one ``all_to_all_single`` (`_AllToAll`, differentiable: its backward
is the reverse exchange), the expert-parallel MoE's exchange.

With no process group (world size 1) every call is the JAX package's
identity path.  A gloo collective of a CUDA tensor is staged through
host memory (gloo reduces host buffers), as the serving mesh's
all-reduce is.  The calls run synchronously; ``sync_op=False`` returns a
task whose ``wait()`` is already satisfied, and `isend`/`irecv` return
the backend's task.  A group is a set of ranks (``new_group``), or a
mesh axis name for JAX's API (``axis_name``).

`comm_stats` counts, process-wide, the calls, bytes and host seconds of
the all-reduces, all-gathers and all-to-alls made through
`_reduce_inplace`, `_gather` and `_exchange` (the hybrid layers',
ZeRO's, the ring's and the MoE's; an all-to-all counts its input's
bytes) and of the
pipeline's point-to-point traffic: over gloo, which runs synchronously
here, the seconds are the collectives' wall time.
"""
from __future__ import annotations

import time
from typing import List

import torch

from . import parallel as _par

__all__ = ["ReduceOp", "Group", "new_group", "all_reduce", "all_gather",
           "all_gather_object", "reduce_scatter", "broadcast", "reduce",
           "scatter", "alltoall", "send", "recv", "isend", "irecv",
           "barrier", "wait", "split", "comm_stats", "axis_group"]

_COMM = {"calls": 0, "bytes": 0, "seconds": 0.0}


def comm_stats(reset: bool = False) -> dict:
    """``{"calls", "bytes", "seconds"}`` of the collectives counted so far
    (see the module docstring); ``reset`` zeroes them after reading."""
    out = dict(_COMM)
    if reset:
        _COMM.update(calls=0, bytes=0, seconds=0.0)
    return out


def account(nbytes: int, t0: float):
    """Add one collective of ``nbytes`` started at ``t0``
    (``time.perf_counter``) to `comm_stats`."""
    _COMM["calls"] += 1
    _COMM["bytes"] += int(nbytes)
    _COMM["seconds"] += time.perf_counter() - t0


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """Ranks that communicate together: ``ranks`` (global ranks, sorted),
    this process's index among them (``rank``, -1 outside), and the
    ``torch.distributed`` group (None: the default group)."""

    def __init__(self, axis_name: str = "dp", ranks=None, id=0, pg=None):
        self.axis_name = axis_name
        self.ranks = list(ranks) if ranks is not None else None
        self.id = id
        self.process_group = pg

    @property
    def nranks(self) -> int:
        if self.ranks is not None:
            return len(self.ranks)
        return _par.get_world_size()

    @property
    def rank(self) -> int:
        me = _par.get_rank()
        if self.ranks is None:
            return me
        return self.ranks.index(me) if me in self.ranks else -1

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


_GROUP_COUNTER = [0]
# the newest group a ``new_group(..., axis_name=...)`` made with this rank
# in it, by axis name (`axis_group`)
_AXIS_GROUPS = {}


def new_group(ranks=None, backend=None, axis_name=None) -> Group:
    """A group of ``ranks`` (default: all).  Every rank of the default
    group calls it, members or not, as in ``torch.distributed``."""
    _GROUP_COUNTER[0] += 1
    d = _par._dist()
    pg = None
    if d is not None:
        ranks = sorted(ranks) if ranks is not None else \
            list(range(d.get_world_size()))
        # the default group's bound (`parallel.DIST_TIMEOUT_S`), not
        # torch's half hour
        pg = d.new_group(ranks=ranks, backend=backend,
                         timeout=_par._STATE.get("timeout"))
    g = Group(axis_name or "dp", ranks, id=_GROUP_COUNTER[0], pg=pg)
    if axis_name and g.rank >= 0:
        _AXIS_GROUPS[axis_name] = g
    return g


def axis_group(name):
    """This rank's group along the mesh axis ``name``: the current hybrid
    group's when it has that axis, else the newest ``new_group`` of that
    ``axis_name`` holding this rank; None when neither gives the axis
    more than one rank (the counterpart of JAX's axis being in scope)."""
    from .topology import AXIS_ORDER, get_hybrid_communicate_group

    if not name:
        return None
    hcg = get_hybrid_communicate_group()
    if hcg is not None and (name in AXIS_ORDER or name == "sharding"):
        g = hcg.axis_group(name)
    else:
        g = _AXIS_GROUPS.get(name)
    return g if g is not None and g.nranks > 1 else None


def _pg(group):
    return group.process_group if isinstance(group, Group) else None


def _active(group) -> bool:
    """A real collective is needed: a process group exists and the group
    holds more than this rank."""
    if _par._dist() is None:
        return False
    return not (isinstance(group, Group) and group.nranks <= 1)


def _nranks(group) -> int:
    return group.nranks if isinstance(group, Group) else \
        _par.get_world_size()


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(_pg(group)) == "gloo"


def _torch_op(op):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op] \
        if isinstance(op, str) else op


@torch.no_grad()
def _reduce_inplace(t: torch.Tensor, op, group) -> torch.Tensor:
    """Reduce ``t`` over the group in place (gloo: through a host copy)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = t.detach()
    if _staged(buf, group):
        h = buf.cpu()
        dist.all_reduce(h, op=_torch_op(op), group=_pg(group))
        buf.copy_(h)
    else:
        dist.all_reduce(buf, op=_torch_op(op), group=_pg(group))
    account(buf.numel() * buf.element_size(), t0)
    if op == ReduceOp.AVG:
        if buf.is_floating_point():
            buf.div_(_nranks(group))
        else:
            buf.copy_(buf // _nranks(group))
    return t


class _Done:
    """The task of a call that already ran."""

    def wait(self, timeout=None):
        return True


def _ret(t, sync_op):
    return t if sync_op else _Done()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    if not _active(group):
        return tensor
    _reduce_inplace(tensor, op, group)
    return _ret(tensor, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """`all_reduce`: every rank receives the result (the JAX package's
    multi-controller semantics)."""
    return all_reduce(tensor, op, group, sync_op)


@torch.no_grad()
def _gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    import torch.distributed as dist

    t0 = time.perf_counter()
    src = t.detach()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(_nranks(group))]
    dist.all_gather(parts, src, group=_pg(group))
    if staged:
        parts = [p.to(t.device) for p in parts]
    account(src.numel() * src.element_size() * len(parts), t0)
    return parts


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's ``tensor``, appended to ``tensor_list`` in rank
    order; returns them stacked."""
    if not _active(group):
        if tensor_list is not None:
            tensor_list.append(tensor)
        return tensor
    parts = _gather(tensor, group)
    if tensor_list is not None:
        tensor_list.extend(parts)
    return torch.stack(parts)


def all_gather_object(object_list, obj, group=None):
    if not _active(group):
        object_list.append(obj)
        return
    import torch.distributed as dist

    out = [None] * _nranks(group)
    dist.all_gather_object(out, obj, group=_pg(group))
    object_list.extend(out)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank *r* receives the reduced ``tensor_list[r]`` in ``tensor``;
    without a list, the *r*-th dim-0 chunk of the reduced ``tensor`` is
    returned.  (Over an all-reduce: gloo has no reduce-scatter.)"""
    if not _active(group):
        return tensor
    me = group.rank if isinstance(group, Group) else _par.get_rank()
    if tensor_list is None:
        full = _reduce_inplace(tensor.detach().clone(), op, group)
        return full.chunk(_nranks(group), 0)[me].clone()
    stacked = _reduce_inplace(torch.stack([t.detach() for t in tensor_list]),
                              op, group)
    with torch.no_grad():
        tensor.copy_(stacked[me])
    return _ret(tensor, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s value (a global rank) into ``tensor`` on every rank."""
    if not _active(group):
        return tensor
    import torch.distributed as dist

    with torch.no_grad():
        buf = tensor.detach()
        if _staged(buf, group):
            h = buf.cpu()
            dist.broadcast(h, src=src, group=_pg(group))
            buf.copy_(h)
        else:
            dist.broadcast(buf, src=src, group=_pg(group))
    return _ret(tensor, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``src``'s ``tensor_list[r]`` into ``tensor`` on rank *r*."""
    if not _active(group):
        return tensor_list[0] if tensor_list else tensor
    import torch.distributed as dist

    me = _par.get_rank()
    with torch.no_grad():
        buf = tensor.detach()
        staged = _staged(buf, group)
        out = buf.cpu() if staged else buf
        parts = None
        if me == src:
            parts = [(t.detach().cpu() if staged else t.detach())
                     .contiguous() for t in tensor_list]
        dist.scatter(out, parts, src=src, group=_pg(group))
        if staged:
            buf.copy_(out)
    return _ret(tensor, sync_op)


class _AllToAll(torch.autograd.Function):
    """Block *j* of dim 0 goes to rank *j* of ``group``; block *i* of the
    result came from rank *i*.  The exchange is its own transpose, so the
    backward runs it again on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


@torch.no_grad()
def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_to_all_single`` of ``x`` in equal dim-0 blocks (gloo:
    through a host copy), counted in `comm_stats` at ``x``'s size."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    src = x.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=_pg(group))
    if staged:
        out = out.to(x.device)
    account(src.numel() * src.element_size(), t0)
    return out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable exchange of `_AllToAll`: ``x``'s dim 0 holds one
    block a rank of ``group``; the identity without a collective."""
    if not _active(group):
        return x
    return _AllToAll.apply(x, group)


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank *r* receives every rank's ``in_tensor_list[r]``, in rank order
    (appended to ``out_tensor_list``); returns them concatenated on dim 0.
    A tensor instead of a list is cut into one dim-0 block a rank.  One
    ``all_to_all_single``: each block crosses once; differentiable."""
    if not _active(group):
        if out_tensor_list is not None and \
                isinstance(in_tensor_list, (list, tuple)):
            out_tensor_list.extend(in_tensor_list)
        if isinstance(in_tensor_list, (list, tuple)):
            return torch.cat(list(in_tensor_list), 0)
        return in_tensor_list
    n = _nranks(group)
    if isinstance(in_tensor_list, (list, tuple)):
        stacked = torch.stack(list(in_tensor_list))
    else:
        stacked = in_tensor_list.reshape(
            (n, in_tensor_list.shape[0] // n) + tuple(
                in_tensor_list.shape[1:]))
    got = list(_AllToAll.apply(stacked, group).unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(got)
    return torch.cat(got, 0)


def send(tensor, dst=0, group=None, sync_op=True):
    if not _active(group):
        return tensor
    import torch.distributed as dist

    buf = tensor.detach()
    dist.send(buf.cpu() if _staged(buf, group) else buf, dst=dst,
              group=_pg(group))
    return _ret(tensor, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    if not _active(group):
        return tensor
    import torch.distributed as dist

    with torch.no_grad():
        buf = tensor.detach()
        if _staged(buf, group):
            h = buf.cpu()
            dist.recv(h, src=src, group=_pg(group))
            buf.copy_(h)
        else:
            dist.recv(buf, src=src, group=_pg(group))
    return _ret(tensor, sync_op)


class _P2PTask:
    """`isend`/`irecv`'s task; a staged receive lands in ``tensor`` at
    ``wait()``."""

    def __init__(self, work, host=None, tensor=None):
        self._work, self._host, self._tensor = work, host, tensor

    def wait(self, timeout=None):
        self._work.wait()
        if self._host is not None:
            with torch.no_grad():
                self._tensor.detach().copy_(self._host)
            self._host = None
        return True


def isend(tensor, dst=0, group=None):
    if not _active(group):
        return _Done()
    import torch.distributed as dist

    buf = tensor.detach()
    buf = buf.cpu() if _staged(buf, group) else buf
    return _P2PTask(dist.isend(buf, dst=dst, group=_pg(group)), host=None,
                    tensor=buf)


def irecv(tensor, src=0, group=None):
    if not _active(group):
        return _Done()
    import torch.distributed as dist

    buf = tensor.detach()
    if _staged(buf, group):
        h = torch.empty_like(buf, device="cpu")
        return _P2PTask(dist.irecv(h, src=src, group=_pg(group)), h, tensor)
    return _P2PTask(dist.irecv(buf, src=src, group=_pg(group)))


def barrier(group=None):
    """Every rank of the group reaches this point (a one-element
    all-reduce on this rank's device)."""
    if not _active(group):
        return
    dev = _par.current_device() or torch.device("cpu")
    _reduce_inplace(torch.zeros(1, device=dev), ReduceOp.SUM, group)


def wait(tensor, group=None, use_calc_stream=True):
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split``: builds the tensor-parallel layer of
    ``operation`` over the current hybrid group's ``mp`` axis (fresh
    parameters, this rank's block of them), applies it to ``x`` and keeps
    it as ``split.last_layer``, as the JAX package does.  ``"linear"``
    with ``axis=0`` is a `RowParallelLinear` (``size = (in, out)``, the
    input split on its last axis here), ``axis=1`` a
    `ColumnParallelLinear` (gathered with ``gather_out``);
    ``"embedding"`` (``axis=0``) a `VocabParallelEmbedding`.
    ``num_partitions`` must equal the mp degree when that is above 1."""
    from .fleet.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                RowParallelLinear,
                                                VocabParallelEmbedding)
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_deg = hcg.get_model_parallel_world_size() if hcg is not None \
        else None
    if mp_deg is not None and mp_deg > 1 and num_partitions != mp_deg:
        raise ValueError(
            f"num_partitions {num_partitions} must equal the mesh "
            f"mp degree {mp_deg}")
    shards = mp_deg if mp_deg and mp_deg > 1 else max(num_partitions, 1)
    dev = x.device
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            if in_f % shards:
                raise ValueError(
                    f"in_features {in_f} not divisible by {shards} "
                    "partitions")
            layer = RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=dev)
        elif axis == 1:
            if out_f % shards:
                raise ValueError(
                    f"out_features {out_f} not divisible by {shards} "
                    "partitions")
            layer = ColumnParallelLinear(in_f, out_f,
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=dev)
        else:
            raise ValueError("linear split axis must be 0 or 1")
    elif operation == "embedding":
        if axis != 0:
            raise ValueError("embedding split supports axis=0 (vocab)")
        vocab, hidden = size
        layer = VocabParallelEmbedding(vocab, hidden,
                                       weight_attr=weight_attr, device=dev)
    else:
        raise ValueError(
            f"unknown split operation {operation!r}; expected 'linear' or "
            "'embedding'")
    out = layer(x)
    split.last_layer = layer
    return out
