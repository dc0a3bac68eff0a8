"""Tensor-parallel layers (counterpart: paddle_tpu/distributed/fleet/
meta_parallel/mp_layers.py).

The JAX layers are dense matmuls whose weights carry ``mesh_axes``; XLA
partitions them over ``mp`` and inserts the collectives.  Here a rank is
a process and holds only its shard, so the reference's collectives are
written out as `torch.autograd.Function`s over the tensor-parallel group
(the current `HybridCommunicateGroup`'s, or ``mp_group``):

* `c_identity` — forward the identity, backward an all-reduce (the input
  of a column-split product: each rank's part of its gradient is summed);
* `mp_allreduce` — its reverse: forward an all-reduce, backward the
  identity (the output of a row-split product);
* `c_split` / `c_concat` — keep this rank's block of the last axis, or
  all-gather the blocks; each the other's backward.

A parallel layer draws the whole weight as the dense layer would (the
same initializer and generator, so every rank draws the same matrix from
one seed) and keeps its block, marked with ``mesh_axes`` (JAX's spec)
and ``is_distributed``.  So its math is the JAX layer's dense math:
`ColumnParallelLinear` ``[in, out / mp]`` (its output gathered with
``gather_output``), `RowParallelLinear` ``[in / mp, out]`` (the input
split unless ``input_is_parallel``; the full bias added once, after the
all-reduce), `VocabParallelEmbedding` ``[vocab / mp, dim]`` (a masked
lookup, then an all-reduce), `ParallelCrossEntropy` over vocab-split
logits (`parallel_cross_entropy`: the JAX package's
``_vocab_parallel_ce``).  Without a group of more than one rank every
layer is the dense one.
"""
from __future__ import annotations

import torch

from .... import amp
from ....nn import initializer as init
from ....nn.functional.common import embedding, linear
from ....nn.layer.layers import Layer
from ....parallel.partition import P, shard_leaf
from ...collective import ReduceOp, _gather, _reduce_inplace
from ...topology import get_hybrid_communicate_group

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "TensorParallel", "c_identity", "mp_allreduce", "c_split",
           "c_concat", "parallel_cross_entropy", "mp_group_of",
           "is_mp_param"]


def mp_group_of(group=None):
    """``group``, else the current hybrid group's tensor-parallel group;
    None when there is neither or it holds one rank."""
    if group is None:
        hcg = get_hybrid_communicate_group()
        group = hcg.get_model_parallel_group() if hcg is not None else None
    return group if group is not None and group.nranks > 1 else None


def is_mp_param(p) -> bool:
    return any(a is not None and str(a).startswith("mp")
               for a in getattr(p, "mesh_axes", None) or ())


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _reduce_inplace(g, ReduceOp.SUM, ctx.group)
        return g, None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _reduce_inplace(out, ReduceOp.SUM, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _block(x, group):
    n = x.shape[-1] // group.nranks
    return x.narrow(-1, group.rank * n, n).contiguous()


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g.contiguous(), ctx.group), -1), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_gather(x.contiguous(), group), -1)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group), None


def c_identity(x, group=None):
    group = mp_group_of(group)
    return x if group is None else _CIdentity.apply(x, group)


def mp_allreduce(x, group=None):
    group = mp_group_of(group)
    return x if group is None else _MpAllReduce.apply(x, group)


def c_split(x, group=None):
    group = mp_group_of(group)
    return x if group is None else _CSplit.apply(x, group)


def c_concat(x, group=None):
    group = mp_group_of(group)
    return x if group is None else _CConcat.apply(x, group)


def _keep_block(p: torch.nn.Parameter, spec, group) -> torch.nn.Parameter:
    """A parameter over this rank's block of ``p`` under ``spec``,
    carrying ``p``'s attributes and the spec as ``mesh_axes``."""
    data = p.detach()
    if group is not None:
        data = shard_leaf(data, spec, {"mp": (group.rank, group.nranks)})
    out = torch.nn.Parameter(data, requires_grad=p.requires_grad)
    for attr in ("optimize_attr", "regularizer", "is_bias"):
        if hasattr(p, attr):
            setattr(out, attr, getattr(p, attr))
    out.mesh_axes = tuple(spec)
    out.is_distributed = group is not None
    return out


def _check_divisible(what, n, group):
    if group is not None and n % group.nranks:
        raise ValueError(f"{what} {n} is not divisible by the "
                         f"tensor-parallel degree {group.nranks}")


class ColumnParallelLinear(Layer):
    """Weight ``[in, out]`` split on its columns: a rank holds
    ``[in, out / mp]`` and its bias block; the output stays split unless
    ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=torch.float32):
        super().__init__()
        group = mp_group_of(mp_group)
        _check_divisible("out_features", out_features, group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.mp_group = group
        self.world_size = group.nranks if group is not None else 1
        w = self.create_parameter([in_features, out_features],
                                  attr=weight_attr, dtype=dtype,
                                  default_initializer=init.XavierUniform(),
                                  device=device)
        self.weight = _keep_block(w, P(None, "mp"), group)
        self.bias = _keep_block(self.create_parameter(
            [out_features], dtype=dtype, is_bias=True, device=device),
            P("mp"), group) if has_bias else None

    def forward(self, x):
        out = linear(c_identity(x, self.mp_group), self.weight, self.bias)
        return c_concat(out, self.mp_group) if self.gather_output else out


class RowParallelLinear(Layer):
    """Weight ``[in, out]`` split on its rows: a rank holds
    ``[in / mp, out]``; the input's last axis is split (already, with
    ``input_is_parallel``), the partial products all-reduced, and the
    whole bias added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        group = mp_group_of(mp_group)
        _check_divisible("in_features", in_features, group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.mp_group = group
        self.world_size = group.nranks if group is not None else 1
        w = self.create_parameter([in_features, out_features],
                                  attr=weight_attr, dtype=dtype,
                                  default_initializer=init.XavierUniform(),
                                  device=device)
        self.weight = _keep_block(w, P("mp", None), group)
        self.bias = _keep_block(self.create_parameter(
            [out_features], dtype=dtype, is_bias=True, device=device),
            P(), None) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = c_split(x, self.mp_group)
        out = mp_allreduce(linear(x, self.weight), self.mp_group)
        if self.bias is None:
            return out
        (b,) = amp.cast_inputs(amp.WHITE, self.bias)
        return out + b


class VocabParallelEmbedding(Layer):
    """Table ``[vocab, dim]`` split on its rows: a rank looks up the ids
    of its vocabulary block (zeros elsewhere) and the ranks' rows are
    summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=torch.float32):
        super().__init__()
        group = mp_group_of(mp_group)
        _check_divisible("num_embeddings", num_embeddings, group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.mp_group = group
        w = self.create_parameter([num_embeddings, embedding_dim],
                                  attr=weight_attr, dtype=dtype,
                                  default_initializer=init.Normal(0.0, 0.02),
                                  device=device)
        self.weight = _keep_block(w, P("mp", None), group)

    def forward(self, x):
        if self.mp_group is None:
            return embedding(x, self.weight)
        rows = self.weight.shape[0]
        local = x.long() - self.mp_group.rank * rows
        inside = (local >= 0) & (local < rows)
        out = embedding(torch.where(inside, local, 0), self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return mp_allreduce(out, self.mp_group)


def parallel_cross_entropy(logits, label, group=None, ignore_index=-100):
    """Per-token softmax cross entropy of logits split on their last
    (vocabulary) axis over ``group``, in f32 (the JAX package's
    ``_vocab_parallel_ce``): the row max all-reduced (MAX) without a
    gradient, the summed ``exp`` all-reduced, the target logit picked on
    the rank that holds it and all-reduced.  Rows labelled
    ``ignore_index`` count zero.  Returns the label's shape."""
    group = mp_group_of(group)
    x = logits.float()
    li = label.long()
    if li.dim() == x.dim():
        li = li.squeeze(-1)
    keep = li != ignore_index
    v_local = x.shape[-1]
    lo = group.rank * v_local if group is not None else 0
    m = x.detach().amax(-1)
    if group is not None:
        _reduce_inplace(m, ReduceOp.MAX, group)
    sumexp = mp_allreduce(torch.exp(x - m.unsqueeze(-1)).sum(-1), group)
    lse = torch.log(sumexp) + m
    local = li - lo
    inside = (local >= 0) & (local < v_local) & keep
    tgt = torch.gather(x, -1, torch.where(inside, local, 0).unsqueeze(-1))
    tgt = mp_allreduce(tgt.squeeze(-1) * inside.to(x.dtype), group)
    return torch.where(keep, lse - tgt, 0.0)


class ParallelCrossEntropy(Layer):
    """`parallel_cross_entropy` as a layer: ``forward(input, label)``
    with ``input`` the vocab-split logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return parallel_cross_entropy(input, label, self.mp_group,
                                      self.ignore_index)


class TensorParallel(Layer):
    """The model wrapper of a tensor-parallel run: at construction the
    parameters every tensor-parallel rank holds whole are broadcast from
    the group's first rank (so the ranks start alike), and with a
    data-parallel degree above 1 the forward goes through `DataParallel`
    over the data-parallel group, whose reducer averages the gradients
    after each backward."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from ...collective import broadcast
        from ..data_parallel import DataParallel

        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        group = mp_group_of(self._hcg.get_model_parallel_group()
                            if self._hcg is not None else None)
        if group is not None:
            for p in layers.parameters():
                if not is_mp_param(p):
                    broadcast(p, src=group.ranks[0], group=group)
        self._dp = None
        if self._hcg is not None and \
                self._hcg.get_data_parallel_world_size() > 1:
            st = strategy
            self._dp = DataParallel(
                layers, strategy=st, hcg=self._hcg,
                comm_buffer_size=st.fuse_grad_size_in_MB if st else 25)

    def forward(self, *inputs, **kwargs):
        return (self._dp or self._layers)(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, *args, **kwargs):
        return self._layers.named_parameters(prefix, recurse, *args,
                                             **kwargs)
