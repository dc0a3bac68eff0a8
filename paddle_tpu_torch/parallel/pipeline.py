"""Pipeline schedules over a pipeline group (counterpart:
paddle_tpu/parallel/pipeline.py).

The JAX package runs a schedule inside one ``shard_map`` program: every
device applies its stage at every tick and ``lax.ppermute`` rotates the
activations, so AD through the schedule is the backward pipeline.  Here
a stage is a process of the ``pp`` group (`HybridCommunicateGroup`'s, or
the `collective.Group` given), and activations cross between stages by
point-to-point send and receive (`StageLink`):

* `pipeline_local` — a fill-drain forward over ``M`` micro-batches,
  differentiable: the receive of an activation is an autograd node whose
  backward sends the gradient back, the send one whose backward receives
  it; the last stage's outputs are summed over the group (forward), so
  every stage returns them, as JAX's ``psum`` does;
* `pipeline_1f1b_local` — the 1F1B schedule of
  ``framework/section_worker.cc:144``: stage ``s`` of ``L`` runs
  ``startup = L - s - 1`` forwards (fewer if ``M`` is smaller), then one
  forward and one backward in turn, then the remaining backwards, so at
  most ``L - s`` micro-batches' activations are held.  A forward's output
  goes to the next stage while the gradient of an earlier micro-batch
  comes back (one paired exchange);
* `pipeline_spmd_step` — JAX's global entry: ``stacked_params`` lead with
  the stage axis, and each stage applies its own row.

`StageLink` counts the sends, receives and bytes, and exchanges an
activation's shape and dtype once (the reference's fixed shape meta).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = ["StageLink", "pipeline_local", "pipeline_1f1b_local",
           "pipeline_spmd_step", "pp_group"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]


def pp_group(group=None):
    """``group``, else the current hybrid group's pipeline group."""
    if group is not None and not isinstance(group, str):
        return group
    from ..distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("no pipeline group: pass one or build a "
                           "HybridCommunicateGroup (fleet.init)")
    return hcg.axis_group(group or "pp")


class StageLink:
    """Point-to-point traffic between neighbouring stages of a pipeline
    group: ``stage``, ``stages``, and ``stats`` (sends, receives, bytes
    sent)."""

    def __init__(self, group):
        self.group = group
        self.stage, self.stages = group.rank, group.nranks
        self.stats = {"sends": 0, "recvs": 0, "bytes": 0}
        self._sent_meta, self._recv_meta = False, None
        self._warm = False

    def _peer(self, stage):
        return self.group.ranks[stage]

    def _pg(self):
        return self.group.process_group

    def _staged(self, t):
        import torch.distributed as dist

        return t.is_cuda and dist.get_backend(self._pg()) == "gloo"

    def _post(self, send=None, recv=None):
        """Post a send ``(tensor, stage)`` and a receive ``(buffer,
        stage)`` as one batch (one NCCL group: neither side waits for the
        other's posting order) and wait for both; returns the buffer."""
        import time

        import torch.distributed as dist

        from ..distributed.collective import account

        if not self._warm:
            # NCCL: the group's first call must be made by all its ranks,
            # which a first send or receive between two of them is not
            self._warm = True
            if dist.get_backend(self._pg()) == "nccl":
                dist.all_reduce(torch.zeros(1, device=_device()),
                                group=self._pg())
        t0, nbytes = time.perf_counter(), 0
        ops, host = [], None
        if recv is not None:
            buf, src = recv
            target = torch.empty_like(buf, device="cpu") \
                if self._staged(buf) else buf
            host = target if target is not buf else None
            ops.append(dist.P2POp(dist.irecv, target, self._peer(src),
                                  group=self._pg()))
            self.stats["recvs"] += 1
            nbytes += buf.numel() * buf.element_size()
        if send is not None:
            t, dst = send
            t = t.detach().contiguous()
            t = t.cpu() if self._staged(t) else t
            ops.append(dist.P2POp(dist.isend, t, self._peer(dst),
                                  group=self._pg()))
            self.stats["sends"] += 1
            self.stats["bytes"] += t.numel() * t.element_size()
            nbytes += t.numel() * t.element_size()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if host is not None:
            recv[0].copy_(host)
        account(nbytes, t0)
        return recv[0] if recv is not None else None

    def send(self, t, stage):
        self._post(send=(t, stage))

    def recv(self, buf, stage):
        return self._post(recv=(buf, stage))

    def exchange(self, t, dst, buf, src):
        return self._post(send=(t, dst), recv=(buf, src))

    # -- the activation's shape, once ------------------------------------
    def send_meta(self, t, stage):
        """Send ``t``'s dtype and shape to ``stage``, at the first call
        only."""
        if self._sent_meta:
            return
        meta = torch.tensor([_DTYPES.index(t.dtype), t.dim()]
                            + list(t.shape), dtype=torch.int64,
                            device=t.device)
        size = torch.tensor([meta.numel()], dtype=torch.int64,
                            device=t.device)
        self._post(send=(size, stage))
        self._post(send=(meta, stage))
        self._sent_meta = True

    def recv_meta(self, stage, device):
        """``(shape, dtype)`` of the activations ``stage`` sends,
        received at the first call."""
        if self._recv_meta is None:
            size = self._post(recv=(torch.zeros(1, dtype=torch.int64,
                                                device=device), stage))
            meta = self._post(recv=(torch.zeros(int(size.item()),
                                                dtype=torch.int64,
                                                device=device), stage))
            vals = meta.tolist()
            self._recv_meta = (tuple(vals[2:2 + vals[1]]), _DTYPES[vals[0]])
        return self._recv_meta


# -- autograd over the link (pipeline_local) ---------------------------------
class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, link):
        ctx.link, ctx.shape, ctx.dtype = link, y.shape, y.dtype
        ctx.device = y.device
        link.send(y, link.stage + 1)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        return ctx.link.recv(g, ctx.link.stage + 1), None


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, link, shape, dtype):
        ctx.link = link
        buf = torch.empty(shape, dtype=dtype, device=anchor.device)
        return link.recv(buf, link.stage - 1)

    @staticmethod
    def backward(ctx, g):
        ctx.link.send(g, ctx.link.stage - 1)
        return None, None, None, None


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group (the last stage's outputs, zeros
    elsewhere); backward: the identity (the sum is one value, read by
    each stage)."""

    @staticmethod
    def forward(ctx, x, group):
        from ..distributed.collective import ReduceOp, _reduce_inplace

        out = x.contiguous().clone()
        _reduce_inplace(out, ReduceOp.SUM, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_local(stage_fn: Callable, stage_params, microbatches,
                   axis_name="pp", link: Optional[StageLink] = None):
    """This stage's part of a fill-drain pipeline (see the module
    docstring).  ``stage_fn(params, x) -> y`` with ``y`` of ``x``'s shape
    (homogeneous stages); ``microbatches`` ``[M, mb, ...]`` (stage 0 takes
    them).  Returns ``[M, mb, ...]`` outputs in f32 on every stage."""
    group = pp_group(axis_name)
    link = link or StageLink(group)
    s, n = link.stage, link.stages
    m = microbatches.shape[0]
    outs, tokens = [], []
    anchor = torch.zeros((), device=microbatches.device, requires_grad=True)
    for i in range(m):
        x = microbatches[i] if s == 0 else _RecvPrev.apply(
            anchor, link, tuple(microbatches.shape[1:]), microbatches.dtype)
        y = stage_fn(stage_params, x)
        if s < n - 1:
            tokens.append(_SendNext.apply(y, link))
            outs.append(torch.zeros(y.shape, dtype=torch.float32,
                                    device=y.device))
        else:
            outs.append(y.float())
    out = _SumOverGroup.apply(torch.stack(outs), group)
    if tokens:
        out = out + 0.0 * torch.stack(tokens).sum()
    return out


def pipeline_1f1b_local(fwd_apply: Callable, n_micro: int, axis_name="pp",
                        link: Optional[StageLink] = None,
                        first_input: Optional[Callable] = None):
    """Run the 1F1B schedule (see the module docstring) on this stage.

    ``fwd_apply(mb_idx, act_in) -> act_out``: stage 0 gets
    ``first_input(mb_idx)`` (or None), the last stage returns its loss, a
    scalar; the backward of a micro-batch is autograd's, from the loss or
    from the gradient the next stage sends back.  The first step of a
    link exchanges the activation's shape.  Returns the last stage's
    losses, detached (empty elsewhere)."""
    link = link or StageLink(pp_group(axis_name))
    s, n, m = link.stage, link.stages, n_micro
    first, last = s == 0, s == n - 1
    saved: List[tuple] = []
    losses = []

    def recv_act():
        shape, dtype = link.recv_meta(s - 1, device)
        return torch.empty(shape, dtype=dtype, device=device)

    def forward(i, x):
        if x is not None:
            x.requires_grad_(True)
        y = fwd_apply(i, first_input(i) if first and first_input else x)
        saved.append((x, y))
        if last:
            losses.append(y.detach())
        else:
            link.send_meta(y, s + 1)
        return y

    def backward(g):
        x, y = saved.pop(0)
        if g is None:
            y.backward()
        else:
            torch.autograd.backward(y, g)
        if x is None:
            return None
        return x.grad if x.grad is not None else torch.zeros_like(x)

    device = _device()
    warm = min(n - s - 1, m)
    steady = m - warm
    for i in range(warm):
        y = forward(i, None if first else link.recv(recv_act(), s - 1))
        link.send(y, s + 1)
    x = None
    if steady and not first:
        x = link.recv(recv_act(), s - 1)
    for i in range(steady):
        y = forward(warm + i, x)
        g = None if last else link.exchange(y, s + 1, torch.empty_like(y),
                                            s + 1)
        gin = backward(g)
        if first:
            continue
        if i == steady - 1:
            link.send(gin, s - 1)
        else:
            x = link.exchange(gin, s - 1, recv_act(), s - 1)
    for _ in range(warm):
        gin = backward(link.recv(torch.empty_like(saved[0][1]), s + 1))
        if not first:
            link.send(gin, s - 1)
    return losses


def _device():
    from ..distributed import parallel as _par

    return _par.current_device() or torch.device("cpu")


def pipeline_spmd_step(stage_fn: Callable, stacked_params, microbatches,
                       mesh=None, axis_name: str = "pp", params_pspec=None):
    """JAX's global entry: ``stacked_params`` (a tensor or a tuple of
    them) lead with the stage axis; each stage applies its row through
    `pipeline_local`.  ``mesh`` is the `HybridCommunicateGroup` (default:
    the current one)."""
    group = mesh.axis_group(axis_name) if hasattr(mesh, "axis_group") \
        else pp_group(axis_name)
    s = group.rank
    if isinstance(stacked_params, (tuple, list)):
        params = type(stacked_params)(p[s] for p in stacked_params)
    else:
        params = stacked_params[s]
    return pipeline_local(stage_fn, params, microbatches, group)
