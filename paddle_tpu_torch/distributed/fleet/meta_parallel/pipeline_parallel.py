"""Pipeline parallelism: layer descriptions, stage segmentation, the
pipeline model and its train loop (counterpart: paddle_tpu/distributed/
fleet/meta_parallel/pipeline_parallel.py).

A `PipelineLayer` is a flat list of layer descriptions cut into stages
(`SegmentLayers`: ``"uniform"`` by count, or ``"layer:Name"``, equal
numbers of the layers whose class name matches ``Name`` a stage).  The
JAX package builds every stage in its one controller; here a stage is a
process of the hybrid group's ``pp`` axis, and a rank builds only its
own stage's layers, registered under their global indices
(``run_function.<i>``), so its parameter names are the single-process
model's.  A `SharedLayerDesc` (GPT's tied embedding, read by the first
and the last stage) is built once a stage that holds its key, under
``shared_layers.<key>``; at construction its weights are broadcast from
the first such stage, and after each backward its gradient is summed
over the stages that hold it (`allreduce_shared_weight_gradients`).  On
one process every stage is built and a shared layer is one module,
read at each of its places.

`PipelineParallel.train_batch` runs the compiled step of the pipeline
(`fleet.pipeline_step.PipelineTrainStep`, the 1F1B schedule) when the
pipeline degree is above 1, else the reference's micro-batch loop.
"""
from __future__ import annotations

import math
import re
from typing import List

import torch
from torch import nn

from ....nn.layer.layers import Layer
from ...topology import get_hybrid_communicate_group

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers",
           "PipelineLayer", "PipelineParallel"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _desc_name(d) -> str:
    if isinstance(d, LayerDesc):
        return d.layer_cls.__name__
    if isinstance(d, nn.Module):
        return type(d).__name__
    return getattr(d, "__name__", type(d).__name__)


class SegmentLayers:
    """The reference's stage cut (``pp_layers.py:23``): ``"uniform"``
    gives each stage ``n / stages`` descriptions (floor boundaries);
    ``"layer:Name"`` gives each stage the same number of descriptions
    whose class name matches ``Name`` (a regex, case-insensitive), each
    stage ending after its last one and the last stage taking the
    rest."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.layers_desc)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            weights = [1 if re.search(name, _desc_name(d), re.IGNORECASE)
                       else 0 for d in self.layers_desc]
            total = sum(weights)
            if total == 0 or total % self.num_parts:
                raise ValueError(
                    f"{total} layers match {name!r}, not a positive "
                    f"multiple of {self.num_parts} stages")
            part = total // self.num_parts
            result = [0] * (self.num_parts + 1)
            seen, k = 0, 1
            for i, w in enumerate(weights):
                seen += w
                if seen == part and k < self.num_parts:
                    result[k] = i + 1
                    k += 1
                    seen = 0
            result[self.num_parts] = n
            return result
        raise ValueError(f"unknown segment method {self.method!r}: "
                         f"'uniform' or 'layer:<name>'")

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0]
        part = num_items / num_parts
        for i in range(1, num_parts + 1):
            result.append(int(math.floor(i * part)))
        result[-1] = num_items
        return result


class _FuncLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedCall(Layer):
    """One place of a shared layer: calls it, or its ``forward_func``."""

    def __init__(self, owner, key, forward_func):
        super().__init__()
        self._owner = [owner]  # not a submodule: no second registration
        self._key = key
        self._fn = forward_func

    def forward(self, *args):
        layer = self._owner[0].shared_layers[self._key]
        if self._fn is not None:
            return self._fn(layer, *args)
        return layer(*args)


class PipelineLayer(Layer):
    """The model as a flat list of descriptions (LayerDesc,
    SharedLayerDesc, a built layer, or a callable), cut into
    ``num_stages`` stages (default: the hybrid group's pipeline degree);
    this rank builds its own stage (see the module docstring)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 **kwargs):
        super().__init__()
        hcg = get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self._loss_fn = loss_fn
        self._num_stages = int(num_stages or pp)
        self._recompute_interval = recompute_interval
        self.descs = list(layers)
        self.segment_parts = SegmentLayers(self.descs, self._num_stages,
                                           seg_method).do_segment()
        self._hcg = hcg if pp > 1 else None
        if self._hcg is not None and self._num_stages != pp:
            raise ValueError(f"PipelineLayer has {self._num_stages} stages "
                             f"but the pipeline degree is {pp}")
        self._stage = self._hcg.get_stage_id() if self._hcg else None
        if self._stage is None:
            lo, hi = 0, len(self.descs)
        else:
            lo, hi = self.segment_parts[self._stage], \
                self.segment_parts[self._stage + 1]
        self.shared_layers = nn.ModuleDict()
        self.run_function = nn.ModuleDict()
        for i in range(lo, hi):
            self.run_function[str(i)] = self._build(self.descs[i])
        self._shared_groups = None
        if self._hcg is not None:
            self._sync_shared()

    def _build(self, d):
        if isinstance(d, SharedLayerDesc):
            if d.layer_name not in self.shared_layers:
                self.shared_layers[d.layer_name] = d.build_layer()
            return _SharedCall(self, d.layer_name, d.forward_func)
        if isinstance(d, LayerDesc):
            return d.build_layer()
        if isinstance(d, nn.Module):
            return d
        if callable(d):
            return _FuncLayer(d)
        raise TypeError(f"bad layer desc {d!r}")

    # -- shared layers across stages --------------------------------------
    def _shared_stage_lists(self):
        """``{key: [stages holding it]}`` over every shared key."""
        out = {}
        for s in range(self._num_stages):
            lo, hi = self.segment_parts[s], self.segment_parts[s + 1]
            for d in self.descs[lo:hi]:
                if isinstance(d, SharedLayerDesc):
                    stages = out.setdefault(d.layer_name, [])
                    if s not in stages:
                        stages.append(s)
        return out

    def _sync_shared(self):
        """Build the groups of the stages that hold each shared key (every
        rank, every group, in one order) and broadcast each shared
        layer's weights from its first stage."""
        from ...collective import Group, broadcast, new_group
        from ... import parallel as _par

        hcg = self._hcg
        mesh = hcg.mesh
        self._shared_groups = {}
        for key, stages in sorted(self._shared_stage_lists().items()):
            for line in mesh.get_comm_list("pp"):
                ranks = [line[s] for s in stages]
                if len(ranks) > 1 and _par._dist() is not None:
                    g = new_group(ranks, axis_name=f"shared:{key}")
                else:
                    g = Group(f"shared:{key}", ranks, id=0, pg=None)
                if hcg.global_rank in ranks:
                    self._shared_groups[key] = g
        for key, g in self._shared_groups.items():
            if g.nranks > 1:
                for p in self.shared_layers[key].parameters():
                    broadcast(p, src=g.ranks[0], group=g)

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's gradients over the stages holding it
        (a stage that did not read it contributes zeros)."""
        from ...collective import ReduceOp, _reduce_inplace

        for key, g in (self._shared_groups or {}).items():
            if g.nranks <= 1:
                continue
            for p in self.shared_layers[key].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                _reduce_inplace(p.grad, ReduceOp.SUM, g)

    # -- stages ------------------------------------------------------------
    def get_stage_layers(self, stage=None):
        if stage is not None and self._stage is not None and \
                stage != self._stage:
            raise ValueError(f"this rank holds stage {self._stage}, not "
                             f"{stage}")
        if stage is None or self._stage is not None:
            return list(self.run_function.values())
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return [self.run_function[str(i)] for i in range(lo, hi)]

    @property
    def stage_id(self):
        return self._stage

    def forward(self, *args):
        """This rank's stage on its input (every stage on one process)."""
        x = args[0] if len(args) == 1 else args
        for layer in self.run_function.values():
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x


class PipelineParallel(Layer):
    """The reference's dygraph loop: ``train_batch((inputs, labels),
    optimizer)`` runs the compiled 1F1B step (`PipelineTrainStep`, the
    micro-batch count ``accumulate_steps``) when the pipeline degree is
    above 1 and the batch divides into the micro-batches of every
    data-parallel rank; otherwise micro-batches accumulate gradients and
    one optimizer step is taken."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        acc = 1
        if strategy is not None:
            acc = int(strategy.pipeline_configs.get("accumulate_steps", 1))
        self.accumulate_steps = acc
        self._compiled_step = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _pp(self):
        return self._hcg.get_pipe_parallel_world_size() \
            if self._hcg is not None else 1

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        inputs, labels = data
        if self._pp() > 1 and scaler is None:
            n_micro = max(1, self.accumulate_steps)
            dp = self._hcg.get_data_parallel_world_size()
            if inputs.shape[0] % (n_micro * dp) == 0:
                if self._compiled_step is None:
                    from ..pipeline_step import PipelineTrainStep

                    self._compiled_step = PipelineTrainStep(
                        self._layers, self._layers._loss_fn, optimizer,
                        self._hcg, n_micro=n_micro)
                loss = self._compiled_step(inputs, labels)
                if lr_scheduler is not None:
                    lr_scheduler.step()
                return loss
        k = self.accumulate_steps
        total = None
        micro_in = torch.chunk(inputs, k) if k > 1 else [inputs]
        micro_lab = torch.chunk(labels, k) if k > 1 else [labels]
        for x, y in zip(micro_in, micro_lab):
            loss = self._layers._loss_fn(self._layers(x), y)
            if scaler is not None:
                scaler.scale(loss / k).backward()
            else:
                (loss / k).backward()
            total = loss.detach() if total is None else \
                total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / k

    def state_dict(self, *args, **kwargs):
        """The whole model's state (every stage's, gathered)."""
        if self._compiled_step is not None:
            return self._compiled_step.state_dict()
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        own = self._layers.state_dict()
        return self._layers.set_state_dict(
            {k: v for k, v in state_dict.items() if k in own})

    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        out = self._layers(inputs)
        if compute_loss and self._layers._loss_fn is not None:
            return self._layers._loss_fn(out, labels)
        return out
