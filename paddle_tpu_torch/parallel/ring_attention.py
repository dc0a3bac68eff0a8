"""Ring attention: sequence parallelism over an ``sp`` group
(counterpart: paddle_tpu/parallel/ring_attention.py).

q, k and v are split over the group on the sequence axis: a rank holds
``[B, H, S / sp, D]`` of each.  K/V blocks travel around the ring
(rank ``r`` sends to ``r + 1`` and receives from ``r - 1``, one paired
exchange a step, `pipeline.StageLink`), ``sp - 1`` rotations in all, as
the JAX comment at ``ring_attention.py:155-157`` says; each visiting
block is folded into the online-softmax carry ``(out, m, l)``.

On the card every block runs kernel K3 (`ops.flash_attention.
flash_attention_cuda_fwd`), whose normalized output and row
log-sum-exp map onto the carry as ``(out, lse, 1)``, as JAX's
``_flash_block`` does; a block K3 does not take raises, as the
kernel's checks do.  On the CPU a block goes through K3's plain
version, ``_composed_attention(..., want_lse=True)``.  With a causal
mask the diagonal block (the rank's own K/V) runs causal, blocks from
earlier ranks run full, and blocks from later ranks launch nothing
(JAX's ``_flash_or_skip``).

The backward (`RingAttention`, an ``autograd.Function``) recomputes each
block in composed form in f32, as JAX's custom VJP recomputes the block:
``p = exp(q k^T * scale - lse)`` against the forward's final ``lse``,
``dv += p^T dout``, ``ds = p (dout v^T - rowsum(dout * out))``,
``dq += scale * ds k``, ``dk += scale * ds^T q``; the K/V blocks rotate
again with their ``dk``/``dv`` accumulators, and one last rotation sends
each accumulator home.
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import (_MASK_VALUE, _composed_attention,
                                   flash_attention_cuda_fwd)
from .pipeline import StageLink, pp_group

__all__ = ["RingAttention", "ring_attention_local", "ring_attention"]


def _block(q, k, v, scale, causal):
    """One block: (normalized out f32, lse f32 [B, H, Sq])."""
    if q.is_cuda:
        out, lse = flash_attention_cuda_fwd(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal, scale)
        return out.float(), lse.view(q.shape[0], q.shape[1], q.shape[2])
    out, lse = _composed_attention(q, k, v, None, causal, scale,
                                   want_lse=True)
    return out.float(), lse


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, r = group.nranks, group.rank
        s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        link = StageLink(group) if n > 1 else None
        b, h, sl, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, sl), -math.inf, device=q.device)
        l = torch.zeros((b, h, sl), device=q.device)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (r - i) % n
            if not (causal and src > r):
                ob, lb = _block(q, kv[0], kv[1], s, causal and src == r)
                m_new = torch.maximum(m, lb)
                alpha, beta = torch.exp(m - m_new), torch.exp(lb - m_new)
                o = o * alpha.unsqueeze(-1) + ob * beta.unsqueeze(-1)
                l = l * alpha + beta
                m = m_new
            if i < n - 1:
                kv = link.exchange(kv, (r + 1) % n, torch.empty_like(kv),
                                   (r - 1) % n)
        out = o / torch.clamp(l, min=1e-30).unsqueeze(-1)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, s
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, s = ctx.group, ctx.causal, ctx.scale
        n, r = group.nranks, group.rank
        link = StageLink(group) if n > 1 else None
        dout = dout.float()
        qs = q.float() * s
        delta = (dout * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(qs)
        sl = q.shape[2]
        tril = torch.ones(sl, sl, dtype=torch.bool, device=q.device).tril()
        # rows: k, v, dk, dv of the visiting block
        blk = torch.stack([k.float(), v.float(), torch.zeros_like(qs),
                           torch.zeros_like(qs)])
        for i in range(n):
            src = (r - i) % n
            if not (causal and src > r):
                kf, vf = blk[0], blk[1]
                logits = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
                if causal and src == r:
                    logits = torch.where(tril, logits, _MASK_VALUE)
                p = torch.exp(logits - lse.unsqueeze(-1))
                ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout, vf) - delta)
                blk[3] += torch.einsum("bhqk,bhqd->bhkd", p, dout)
                blk[2] += torch.einsum("bhqk,bhqd->bhkd", ds, qs)
                dq += torch.einsum("bhqk,bhkd->bhqd", ds, kf) * s
            if n > 1:
                send = blk if i < n - 1 else blk[2:]
                blk = link.exchange(send, (r + 1) % n, torch.empty_like(send),
                                    (r - 1) % n)
        dk, dv = blk[-2], blk[-1]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def ring_attention_local(q, k, v, axis_name="sp", causal: bool = False,
                         scale=None):
    """This rank's attention output ``[B, H, S / sp, D]`` from its
    sequence blocks of q, k, v; ``axis_name`` names an axis of the
    current hybrid group, or is a `collective.Group`."""
    return RingAttention.apply(q, k, v, pp_group(axis_name), causal, scale)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        from ..distributed.collective import _gather

        ctx.group = group
        return torch.cat(_gather(x.contiguous(), group), 2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[2] // ctx.group.nranks
        return g.narrow(2, ctx.group.rank * n, n).contiguous(), None


def ring_attention(q, k, v, mesh=None, axis_name: str = "sp",
                   causal: bool = False, scale=None):
    """JAX's global entry: q, k, v whole ``[B, H, S, D]`` on every rank;
    each rank runs its sequence block through the ring and the blocks
    are gathered, so every rank returns the whole output (the gradient
    of a rank's inputs covers its own block).  ``mesh`` is the
    `HybridCommunicateGroup` (default: the current one)."""
    group = mesh.axis_group(axis_name) if hasattr(mesh, "axis_group") \
        else pp_group(axis_name)
    n, r = group.nranks, group.rank
    sl = q.shape[2] // n
    local = [t.narrow(2, r * sl, sl) for t in (q, k, v)]
    out = RingAttention.apply(*local, group, causal, scale)
    return _GatherSeq.apply(out, group) if n > 1 else out
