"""The pipeline-parallel train step (counterpart: paddle_tpu/distributed/
fleet/pipeline_step.py).

The JAX package packs each stage's parameters into one row of a
``[L, S]`` array sharded over ``pp`` and compiles the lockstep 1F1B
schedule, forward, backward and update, into one program.  Here a rank
is one stage of the hybrid group's ``pp`` axis and holds only its own
layers (`PipelineLayer`), and one step:

1. cuts the global batch into ``n_micro`` micro-batches and each into
   one slice a data-parallel rank (micro-batch-major, as JAX's
   ``[M, B / M]`` reshape does);
2. runs the 1F1B schedule (`parallel.pipeline.pipeline_1f1b_local`:
   ``startup = stages - stage - 1``, as ``section_worker.cc:144``), the
   last stage taking ``loss_fn(output, label) / n_micro`` a micro-batch;
   the activation's shape crosses once, at the first step;
3. sums the gradients of shared layers over the stages that hold them
   (GPT's tied embedding) and averages all gradients over the
   data-parallel group;
4. updates each stage's own parameters with the optimizer's staged
   update (per parameter, so Lamb's and Lars' whole-parameter norms are
   exact); a global-norm clip sums the squared norms over the stages;

and returns the loss (the mean over micro-batches and data-parallel
ranks) on every rank.  `state_dict` gathers every stage's parameters
into the whole model's state; the parameters are the layers' own, so
`sync_params` has nothing to write.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...optimizer.optimizer import collect_lr_mults
from ...parallel.pipeline import StageLink, pipeline_1f1b_local
from ...utils.clip import ClipGradByGlobalNorm
from ..collective import ReduceOp, _reduce_inplace, all_gather_object, \
    all_reduce
from ..topology import get_hybrid_communicate_group
from .utils.hybrid_parallel_util import fused_allreduce_gradients

__all__ = ["PipelineTrainStep"]


def _call_seq(layers, x):
    for ly in layers:
        x = ly(*x) if isinstance(x, tuple) else ly(x)
    return x


class PipelineTrainStep:
    """``fleet.build_train_step``'s product for ``pp > 1`` and a
    `PipelineLayer`: ``step(inputs, labels)`` -> the mean loss."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 n_micro: Optional[int] = None, donate: bool = True,
                 unroll: int = 1):
        self.model = model
        self.loss_fn = loss_fn or getattr(model, "_loss_fn", None)
        if self.loss_fn is None:
            raise ValueError("pipeline train step needs loss_fn(out, label)")
        self.optimizer = optimizer
        hcg = mesh if hasattr(mesh, "get_pipe_parallel_group") else \
            get_hybrid_communicate_group()
        if hcg is None:
            raise ValueError("PipelineTrainStep needs a hybrid group "
                             "(fleet.init with pp_degree >= 2)")
        self.hcg = self.mesh = hcg
        self.L = hcg.get_pipe_parallel_world_size()
        if self.L < 2:
            raise ValueError("PipelineTrainStep requires pp_degree >= 2")
        self.dp = hcg.get_data_parallel_world_size()
        self.n_micro = int(n_micro or self.L)
        nstages = len(model.segment_parts) - 1
        if nstages != self.L:
            raise ValueError(
                f"PipelineLayer has {nstages} stages but mesh pp={self.L}")
        self.stage = hcg.get_stage_id()
        self.link = StageLink(hcg.get_pipe_parallel_group())
        self.layers = model.get_stage_layers()
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        # a shared layer counts once in a global norm: on its first stage
        self._norm_once = {k: p for k, p in self._params.items()
                           if not self._shared_elsewhere_first(k)}
        self._lr_mults = collect_lr_mults(self._params)
        self._opt_state = None
        self._step = 0

    def _shared_elsewhere_first(self, name):
        if not name.startswith("shared_layers."):
            return False
        key = name.split(".")[1]
        stages = self.model._shared_stage_lists().get(key, [self.stage])
        return stages[0] != self.stage

    @property
    def stats(self):
        """This stage's point-to-point counts (`StageLink.stats`)."""
        return dict(self.link.stats)

    def _micro(self, t):
        m, d = self.n_micro, self.hcg.get_data_parallel_rank()
        b = t.shape[0]
        per, mb = b // m, b // (m * self.dp)
        return [t[i * per + d * mb:i * per + (d + 1) * mb]
                for i in range(m)]

    def __call__(self, inputs, labels) -> torch.Tensor:
        inputs = torch.as_tensor(inputs)
        labels = torch.as_tensor(labels)
        m = self.n_micro
        if inputs.shape[0] % (m * self.dp):
            raise ValueError(f"batch {inputs.shape[0]} must divide by "
                             f"n_micro*dp = {m * self.dp}")
        xs, ys = self._micro(inputs), self._micro(labels)
        last = self.stage == self.L - 1
        self._step += 1
        for p in self._params.values():
            p.grad = None

        def fwd_apply(i, x):
            out = _call_seq(self.layers, x)
            if last:
                return self.loss_fn(out, ys[i]).float() / m
            return out

        losses = pipeline_1f1b_local(fwd_apply, m, link=self.link,
                                     first_input=lambda i: xs[i])
        self.model.allreduce_shared_weight_gradients()
        fused_allreduce_gradients(list(self._params.values()), self.hcg)
        self._update()
        dev = next(iter(self._params.values())).device
        loss = torch.stack(losses).sum() if losses else \
            torch.zeros((), device=dev)
        loss = loss.to(dev).float()
        all_reduce(loss, group=self.hcg.get_pipe_parallel_group())
        all_reduce(loss, op=ReduceOp.AVG,
                   group=self.hcg.get_data_parallel_group())
        return loss

    @torch.no_grad()
    def _update(self):
        opt = self.optimizer
        if self._opt_state is None:
            self._opt_state = opt.init_state(self._params)
        grads = {k: p.grad for k, p in self._params.items()}
        clip = opt._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            dev = next(iter(self._params.values())).device
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for k in self._norm_once:
                if grads.get(k) is not None:
                    sq += torch.sum(torch.square(grads[k].float()))
            _reduce_inplace(sq, ReduceOp.SUM,
                            self.hcg.get_pipe_parallel_group()) \
                if self.L > 1 else None
            scale = torch.clamp(clip.clip_norm / torch.clamp(
                torch.sqrt(sq), min=1e-12), max=1.0)
            grads = {k: None if g is None else (g.float() * scale).to(
                g.dtype) for k, g in grads.items()}
            opt._grad_clip = None
            try:
                opt.apply_gradients(self._params, grads, self._opt_state,
                                    opt.get_lr(), self._step,
                                    lr_mults=self._lr_mults)
            finally:
                opt._grad_clip = clip
        else:
            opt.apply_gradients(self._params, grads, self._opt_state,
                                opt.get_lr(), self._step,
                                lr_mults=self._lr_mults)
        for p in self._params.values():
            p.grad = None

    def sync_params(self):
        """The stage's parameters are its layers' own: nothing to write."""

    def state_dict(self):
        """The whole model's parameters and buffers, gathered from every
        stage (CPU tensors, by the single-process model's names)."""
        own = {k: v.detach().cpu() for k, v in
               self.model.state_dict().items()}
        parts = []
        all_gather_object(parts, own,
                          group=self.hcg.get_pipe_parallel_group())
        out = {}
        for part in parts:
            out.update(part)
        return out
