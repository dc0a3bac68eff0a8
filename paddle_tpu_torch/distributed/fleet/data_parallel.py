"""``paddle.DataParallel`` (counterpart: paddle_tpu/distributed/fleet/
data_parallel.py).

The JAX package holds one global, replicated array a parameter and lets
XLA reduce the gradients inside the compiled step.  Here each rank holds
its own copy, so this wrapper does what the reference's does:

* **at construction** every parameter and buffer is broadcast from rank
  0 (`sync_params_buffers`), so all ranks start alike;
* **after each backward** of a forward through the wrapper, gradients
  are **averaged** over the group by the `Reducer`: parameters in
  reverse order (the order backward produces their gradients) are cut
  into buckets of ``comm_buffer_size`` MB (the first
  ``last_comm_buffer_size`` MB), each bucket flattened and all-reduced
  as soon as its last gradient has accumulated, buckets always in the
  same order on every rank; the end of the backward waits for them and
  writes the averages back (a parameter without a gradient on this rank
  takes the average of the others');
``scale_loss`` is the identity, as in the JAX package (the average is
taken after the sum), so a script written for the JAX package runs
unchanged; ``apply_collective_grads`` waits for any bucket still in
flight.  A gradient reduced once is not reduced again:
`hybrid_parallel_util.fused_allreduce_gradients` skips every gradient
the reducer wrote back and that nothing has changed since
(`is_reduced`).  With no process group (world size 1) the wrapper only
forwards.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional

import torch

from ..collective import broadcast
from .. import parallel as _par
from ...nn.layer.layers import Layer

__all__ = ["DataParallel", "Reducer", "sync_params_buffers", "is_reduced",
           "mark_reduced"]

# id(parameter) -> (weak reference to it, weak reference to the gradient
# tensor last reduced, its in-place version then): a gradient is reduced
# while all still match
_REDUCED: dict = {}


def mark_reduced(p: torch.Tensor):
    g = p.grad
    if g is None:
        return
    key = id(p)
    _REDUCED[key] = (weakref.ref(p, lambda _, k=key: _REDUCED.pop(k, None)),
                     weakref.ref(g), g._version)


def is_reduced(p: torch.Tensor) -> bool:
    """``p.grad`` is one a reduction wrote and nothing has changed since
    (a later backward accumulates in place, which bumps its version)."""
    mark = _REDUCED.get(id(p))
    g = p.grad
    return mark is not None and g is not None and mark[0]() is p and \
        mark[1]() is g and mark[2] == g._version


def sync_params_buffers(model, comm_group=None, src_rank=0,
                        is_model_parallel=False):
    """Broadcast every parameter and buffer of ``model`` from
    ``src_rank`` (a global rank; a group that does not hold it sends
    from its first rank)."""
    if _par._dist() is None:
        return model
    ranks = getattr(comm_group, "ranks", None)
    if ranks and src_rank not in ranks:
        src_rank = ranks[0]
    for t in list(model.parameters()) + list(model.buffers()):
        broadcast(t, src=src_rank, group=comm_group)
    return model


def _buckets(params: List[torch.Tensor], first_mb: float,
             rest_mb: float) -> List[List[int]]:
    """Indices of ``params`` in reverse order, cut into buckets of one
    dtype: the first up to ``first_mb`` MB, the others ``rest_mb``."""
    out, cur, cur_bytes, dtype = [], [], 0, None
    limit = first_mb * 2 ** 20
    for i in reversed(range(len(params))):
        p = params[i]
        nbytes = p.numel() * p.element_size()
        if cur and (p.dtype != dtype or cur_bytes + nbytes > limit):
            out.append(cur)
            cur, cur_bytes = [], 0
            limit = rest_mb * 2 ** 20
        cur.append(i)
        cur_bytes += nbytes
        dtype = p.dtype
    if cur:
        out.append(cur)
    return out


class Reducer:
    """Bucketed gradient averaging over ``group`` (see the module
    docstring).  ``stats`` counts the backwards reduced, the buckets and
    bytes all-reduced, and ``comm_s``: the host seconds spent flattening,
    staging, launching and waiting for the all-reduces."""

    def __init__(self, params, group=None, comm_buffer_size=25,
                 last_comm_buffer_size=1):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.buckets = _buckets(self.params, last_comm_buffer_size,
                                comm_buffer_size)
        self._bucket_of = {}
        for b, idx in enumerate(self.buckets):
            for i in idx:
                self._bucket_of[id(self.params[i])] = b
        self.armed = False
        self._reset()
        self.stats = {"backwards": 0, "buckets": 0, "bytes": 0,
                      "comm_s": 0.0}
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for p in self.params]

    def _reset(self):
        self._ready = [0] * len(self.buckets)
        self._next = 0
        self._inflight = []
        self._queued = False

    # -- backward ----------------------------------------------------------
    def _hook(self, p):
        if not self.armed:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finalize)
            self._queued = True
        self._ready[self._bucket_of[id(p)]] += 1
        self._launch_ready(final=False)

    def _launch_ready(self, final: bool):
        while self._next < len(self.buckets) and (
                final or self._ready[self._next]
                == len(self.buckets[self._next])):
            self._launch(self._next)
            self._next += 1

    @torch.no_grad()
    def _launch(self, b: int):
        import torch.distributed as dist

        t0 = time.perf_counter()
        ps = [self.params[i] for i in self.buckets[b]]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        pg = getattr(self.group, "process_group", None)
        host = None
        if flat.is_cuda and dist.get_backend(pg) == "gloo":
            host = flat.cpu()
            work = dist.all_reduce(host, group=pg, async_op=True)
        else:
            work = dist.all_reduce(flat, group=pg, async_op=True)
        self._inflight.append((ps, flat, host, work))
        self.stats["buckets"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size()
        self.stats["comm_s"] += time.perf_counter() - t0

    @torch.no_grad()
    def finalize(self):
        """Launch what is left, wait for every bucket and write the
        averages back (the end of the backward calls it)."""
        if not self._queued:
            return
        t0 = time.perf_counter()
        self._launch_ready(final=True)
        n = _par.get_world_size(self.group)
        for ps, flat, host, work in self._inflight:
            work.wait()
            if host is not None:
                flat.copy_(host)
            flat.div_(n)
            off = 0
            for p in ps:
                view = flat[off:off + p.numel()].view_as(p)
                off += p.numel()
                if p.grad is None:
                    p.grad = view.clone()
                else:
                    p.grad.copy_(view)
                mark_reduced(p)
        self._reset()
        self.armed = False
        self.stats["backwards"] += 1
        self.stats["comm_s"] += time.perf_counter() - t0


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 hcg=None, group=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self.find_unused_parameters = find_unused_parameters
        if group is None and hcg is not None:
            group = hcg.get_data_parallel_group()
        self._group = group
        self._reducer: Optional[Reducer] = None
        if _par._dist() is not None and \
                _par.get_world_size(group) > 1:
            sync_params_buffers(layers, comm_group=group)
            self._reducer = Reducer(list(layers.parameters()), group,
                                    comm_buffer_size, last_comm_buffer_size)

    def forward(self, *inputs, **kwargs):
        if self._reducer is not None and torch.is_grad_enabled():
            self._reducer.armed = True
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        if self._reducer is not None:
            self._reducer.finalize()

    @property
    def reducer_stats(self) -> Dict[str, float]:
        return dict(self._reducer.stats) if self._reducer is not None \
            else {}

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, *args, **kwargs):
        return self._layers.named_parameters(prefix, recurse, *args,
                                             **kwargs)
