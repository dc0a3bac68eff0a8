"""Mixture of experts with expert parallelism (counterpart: paddle_tpu/
distributed/fleet/meta_parallel/moe_layer.py).

The JAX package's math, operation for operation: top-k gating with
capacity-factor dropping as dense one-hot ``dispatch [T, E, C]`` /
``combine [T, E, C]`` masks (`moe_gating`: k rounds, cumsum slot
positions offset by the slots earlier rounds used, renormalization only
when ``k > 1``, Shazeer's auxiliary loss), the dispatch and combine
einsums and the expert FFN batched over the local experts (`moe_forward`;
JAX computes these products outside any Pallas kernel, so they stay
``torch.einsum`` here).

Expert parallelism: where JAX runs `moe_forward` inside ``shard_map``
with ``axis_name``, a rank here is a process and ``group`` (a `Group`
of more than one rank) takes the axis's place: the two
``lax.all_to_all`` calls become `collective.all_to_all` (one
``all_to_all_single`` each way, its backward the reverse exchange), with
JAX's ``[n_ep, e_local, C, H]`` reshapes and transposes.

`MoELayer` has JAX's two modes:

* explicit (``ep_degree = n``): the layer holds ``num_experts // n``
  experts and each rank routes its own tokens; it exchanges them when it
  is inside its ``ep_axis`` (`collective.axis_group`: the current hybrid
  group, or a ``new_group(..., axis_name=ep_axis)``, gives the axis more
  than one rank — JAX's ``_axis_in_scope``).  ``gate_weight`` is
  replicated over the ranks, so its gradient is summed over them (JAX's
  ``shard_map`` transpose of an unmapped input);
* fleet (``ep_degree = 1``, ``ep_axis = "mp"``): JAX's parameters are
  whole and GSPMD shards the expert dimension.  Here each parameter
  draws the whole tensor from one seed and keeps its block of experts
  over the tensor-parallel group (``mesh_axes = ("mp", ...)``, as
  `mp_layers`' layers do).  The tokens are replicated over that group,
  so every rank gates all of them; the dispatch product of its own
  experts reads them through `c_identity` (each rank's part of their
  gradient summed), the local experts run, and their outputs are
  gathered over the group before the combine.  So the loss and the
  gradients are the dense layer's.
"""
from __future__ import annotations

import math

import torch

from ....nn import initializer as init
from ....nn.layer.layers import Layer
from ...collective import _gather, all_to_all, axis_group
from .mp_layers import _CIdentity, _keep_block, c_identity, mp_group_of

__all__ = ["MoELayer", "moe_gating", "moe_forward"]


def _gelu_tanh(x):
    # jax.nn.gelu's default form
    return torch.nn.functional.gelu(x, approximate="tanh")


def moe_gating(logits, k: int, capacity: int):
    """Top-k gating -> ``(dispatch [T, E, C] bool, combine [T, E, C],
    aux)``.  ``logits`` ``[T, E]`` are the raw gate scores; tokens beyond
    an expert's capacity ``C`` are dropped (their combine weights are
    zero), per GShard.  ``argmax`` takes the first maximum, as JAX's."""
    t, e = logits.shape
    f32 = torch.float32
    probs = torch.softmax(logits, dim=-1)
    dispatch = torch.zeros((t, e), dtype=f32, device=logits.device)
    combine = torch.zeros((t, e, capacity), dtype=f32, device=logits.device)
    masked = probs
    prev_counts = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e).to(f32)
        # the position of each token within its chosen expert's buffer
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
        pos = pos + prev_counts[None, :].to(f32) * onehot
        fits = (pos < capacity) & (onehot > 0)
        posc = torch.clamp(pos.to(torch.int32), 0, capacity - 1)
        slot = torch.nn.functional.one_hot(posc.long(), capacity).to(f32) \
            * fits.to(f32)[..., None]
        gate_val = (probs * onehot).sum(-1, keepdim=True)
        combine = combine + slot * gate_val[..., None]
        dispatch = dispatch + onehot
        prev_counts = prev_counts + onehot.sum(0).to(torch.int32)
        masked = masked * (1.0 - onehot)
    if k > 1:
        # renormalize the combine weights over the selected experts
        denom = combine.sum(dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp(denom, min=1e-9)
    # k == 1 keeps the raw gate probability as the scale (Switch)
    dispatch_mask = combine > 0.0
    frac_tokens = dispatch.mean(dim=0) / k
    frac_probs = probs.mean(dim=0)
    aux = (frac_tokens * frac_probs).sum() * e
    return dispatch_mask, combine, aux


def _capacity(t, k, e_total, capacity_factor) -> int:
    return max(1, math.ceil(t * k / e_total * capacity_factor))


def _experts(buf, w1, b1, w2, b2, activation):
    """The expert FFN batched over the local experts: ``[E, C, H]`` in
    and out."""
    hdn = activation(torch.einsum("ech,ehf->ecf", buf, w1)
                     + b1[:, None, :])
    return torch.einsum("ecf,efh->ech", hdn, w2) + b2[:, None, :]


def moe_forward(x, gate_w, w1, b1, w2, b2, *, k=2, capacity_factor=1.25,
                group=None, activation=_gelu_tanh):
    """Functional MoE FFN.

    ``x`` ``[T, H]`` local tokens; ``gate_w`` ``[H, E_total]``; ``w1``
    ``[E_local, H, F]``, ``b1`` ``[E_local, F]``, ``w2`` ``[E_local, F,
    H]``, ``b2`` ``[E_local, H]``.  With ``group`` (a `Group` of more
    than one rank) the experts are sharded over its ranks: ``E_total =
    n_ep * E_local`` and the tokens ride two all-to-alls.  Returns
    ``(out [T, H], aux_loss scalar)``."""
    t, h = x.shape
    e_local = w1.shape[0]
    n_ep = group.nranks if group is not None else 1
    e_total = gate_w.shape[1]
    if e_total != n_ep * e_local:
        raise ValueError(f"gate_w has {e_total} experts; {n_ep} ranks of "
                         f"{e_local} local experts hold {n_ep * e_local}")

    capacity = _capacity(t, k, e_total, capacity_factor)
    logits = x @ gate_w
    dispatch_mask, combine, aux = moe_gating(logits, k, capacity)
    # dispatch the tokens into per-expert buffers: [E_total, C, H]
    buf = torch.einsum("tec,th->ech", dispatch_mask.to(x.dtype), x)
    if group is not None:
        # each rank keeps its local experts' buffers from every peer
        buf = all_to_all(buf.reshape(n_ep, e_local, capacity, h), group)
        buf = buf.transpose(0, 1).reshape(e_local, n_ep * capacity, h)
    else:
        buf = buf.reshape(e_local, capacity, h)
    out = _experts(buf, w1, b1, w2, b2, activation)
    if group is not None:
        out = out.reshape(e_local, n_ep, capacity, h).transpose(0, 1)
        out = all_to_all(out.contiguous(), group)
        out = out.reshape(e_total, capacity, h)
    # combine back to token order, weighted by the gate values
    y = torch.einsum("tec,ech->th", combine.to(x.dtype), out)
    return y, aux


class _GatherExperts(torch.autograd.Function):
    """Forward: every rank's ``[E_local, ...]`` block concatenated on dim
    0 in rank order; backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_gather(x.contiguous(), group), 0)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.group.nranks
        return g.narrow(0, ctx.group.rank * n, n).contiguous(), None


def _sharded_experts_forward(x, gate_w, w1, b1, w2, b2, group, *, k,
                             capacity_factor, activation=_gelu_tanh):
    """Fleet mode: the tokens and the gate replicated over ``group``, the
    experts split over it (this rank's ``E / n`` in ``w1`` ...)."""
    t, h = x.shape
    e_total = gate_w.shape[1]
    e_local = w1.shape[0]
    capacity = _capacity(t, k, e_total, capacity_factor)
    dispatch_mask, combine, aux = moe_gating(x @ gate_w, k, capacity)
    lo = group.rank * e_local
    # only the expert path's share of the tokens' gradient differs by
    # rank; the gating's is whole on every rank
    buf = torch.einsum("tec,th->ech",
                       dispatch_mask[:, lo:lo + e_local].to(x.dtype),
                       c_identity(x, group))
    out = _GatherExperts.apply(_experts(buf, w1, b1, w2, b2, activation),
                               group)
    y = torch.einsum("tec,ech->th", combine.to(x.dtype), out)
    return y, aux


class MoELayer(Layer):
    """Mixture-of-experts FFN layer, a drop-in for a transformer MLP
    block; ``num_experts`` is the global expert count.  See the module
    docstring for the explicit (``ep_degree = n``) and the fleet
    (``ep_degree = 1``, ``ep_axis = "mp"``) modes."""

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 k=2, capacity_factor=1.25, ep_axis=None, ep_degree=1,
                 weight_attr=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if num_experts % ep_degree:
            raise ValueError("num_experts must divide by ep_degree")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self.ep_degree = ep_degree
        # fleet mode: the expert dimension split over the tensor-parallel
        # group that exists now, as the parallel layers split theirs
        self._expert_group = None
        if ep_axis and ep_degree == 1:
            if ep_axis != "mp" and axis_group(ep_axis) is not None:
                raise ValueError(
                    f"ep_degree=1 splits the experts over the "
                    f"tensor-parallel axis 'mp', whose ranks share their "
                    f"tokens; ep_axis={ep_axis!r} holds other tokens on "
                    f"each rank: use ep_degree=<its size>")
            self._expert_group = mp_group_of(None)
            if self._expert_group is not None and \
                    num_experts % self._expert_group.nranks:
                raise ValueError(
                    f"num_experts {num_experts} is not divisible by the "
                    f"tensor-parallel degree {self._expert_group.nranks}")
        e_local = num_experts // ep_degree
        std = 0.02
        mk = dict(dtype=dtype, device=device)
        self.gate_weight = self.create_parameter(
            [hidden_size, num_experts], attr=weight_attr,
            default_initializer=init.Normal(0.0, std), **mk)
        self.w1 = self.create_parameter(
            [e_local, hidden_size, intermediate_size],
            default_initializer=init.Normal(0.0, std), **mk)
        self.b1 = self.create_parameter(
            [e_local, intermediate_size], is_bias=True, **mk)
        self.w2 = self.create_parameter(
            [e_local, intermediate_size, hidden_size],
            default_initializer=init.Normal(0.0, std), **mk)
        self.b2 = self.create_parameter([e_local, hidden_size],
                                        is_bias=True, **mk)
        if ep_axis:
            ax = ep_axis
            for name_, spec in (("w1", (ax, None, None)), ("b1", (ax, None)),
                                ("w2", (ax, None, None)), ("b2", (ax, None))):
                p = getattr(self, name_)
                if self._expert_group is not None:
                    p = _keep_block(p, spec, self._expert_group)
                    setattr(self, name_, p)
                p.mesh_axes = spec
        self._aux_loss = None

    def ep_group(self):
        """The group the experts are split over in this forward: the
        tensor-parallel group (fleet mode), the ``ep_axis`` group when it
        is in scope (explicit mode), else None (the dense math)."""
        if self._expert_group is not None:
            return self._expert_group
        if self.ep_degree > 1:
            return axis_group(self.ep_axis)
        return None

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, self.hidden_size)
        group = self.ep_group()
        if group is not None and group is self._expert_group:
            out, aux = _sharded_experts_forward(
                flat, self.gate_weight, self.w1, self.b1, self.w2, self.b2,
                group, k=self.k, capacity_factor=self.capacity_factor)
        else:
            gw = self.gate_weight if group is None else \
                _CIdentity.apply(self.gate_weight, group)
            out, aux = moe_forward(flat, gw, self.w1, self.b1, self.w2,
                                   self.b2, k=self.k,
                                   capacity_factor=self.capacity_factor,
                                   group=group)
        self._aux_loss = aux
        return out.reshape(shape)

    @property
    def aux_loss(self):
        """The load-balancing auxiliary loss of the last forward."""
        return self._aux_loss


def ep_groups(model) -> dict:
    """``{parameter name: (ep_axis, group)}`` of every expert parameter
    of ``model``'s `MoELayer`s in explicit mode inside their ``ep_axis``
    (`inference.weights` cuts and joins them over these groups)."""
    out = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, MoELayer) or m._expert_group is not None:
            continue
        g = m.ep_group()
        if g is None:
            continue
        for n in ("w1", "b1", "w2", "b2"):
            out[f"{prefix}.{n}" if prefix else n] = (m.ep_axis, g)
    return out
