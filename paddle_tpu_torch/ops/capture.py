"""CUDA-graph capture of code that launches the port's kernels.

One module holds the rule for counting launches inside graphs, for every
user of a graph: the serving engine's step graphs
(`inference.serving._StepGraph`) and the deployment runners
(`static.interp.ProgramRunner`, the Predictor's
`inference._LayerRunner`, through `SignatureGraphs`).

A kernel wrapper called while its stream is being captured launches
nothing: it adds one to its ``captured`` count.  `capture` reads those
counts around a capture, and `Graph.replay` adds the launches the capture
recorded to each wrapper's ``launches``, so ``launches`` counts what ran
on the card, replays included.  `COUNTED` lists the wrappers that count
so: K1/K2 (`paged_attention`), K3/K4 (`flash_attention`) and K5
(`layer_norm`).

`StagedInputs` is a graph's static input buffer with a pinned host twin:
host arrays reach the card in one asynchronous copy.
"""
from __future__ import annotations

import gc
import threading
from typing import Any, Dict

import numpy as np
import torch

from ..core import dispatch as _dispatch
from . import flash_attention as _fa
from . import layer_norm as _ln
from . import paged_attention as _pa

__all__ = ["COUNTED", "Graph", "capture", "StagedInputs",
           "SignatureGraphs", "fresh"]

COUNTED = (_pa.paged_attention_cuda, _pa.paged_attention_cuda_q,
           _fa.flash_attention_cuda_fwd, _fa.flash_attention_cuda_dkv,
           _fa.flash_attention_cuda_dq, _ln.layer_norm_cuda)


class Graph:
    """A captured CUDA graph and the kernel launches it recorded
    (``launch_counts``: ``(wrapper, n)`` pairs)."""

    def __init__(self, graph, launch_counts):
        self.graph = graph
        self.launch_counts = launch_counts

    def replay(self):
        self.graph.replay()
        for w, n in self.launch_counts:
            w.launches += n

    def reset(self):
        self.graph.reset()


def capture(fn, pool=None, generator=None):
    """Capture ``fn()`` on the current stream into a `Graph`; returns
    ``(graph, fn's output)``, the output being the graph's static one.

    The caller makes a side stream current and has it wait for its work,
    and runs ``fn`` once there before (the warm-up makes every lazy
    handle and buffer a capture must not create).  ``generator`` is
    registered with the graph, so a replay advances it as an eager call
    would.  The cyclic collector is held off for the capture: a graph it
    frees inside a capture destroys its executable there, which
    invalidates the capture.  `core.dispatch`'s host-syncing mode
    (FLAGS_check_nan_inf, FLAGS_benchmark) is off the stack too.  A
    capture that raises propagates."""
    before = [w.captured for w in COUNTED]
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with _dispatch.suspended():
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
    finally:
        if gc_on:
            gc.enable()
    counts = tuple((w, w.captured - b) for w, b in zip(COUNTED, before)
                   if w.captured > b)
    return Graph(graph, counts), out


def _torch_dtype(a):
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


class StagedInputs:
    """A graph's static inputs: one device buffer holding every input at
    a 16-byte offset, with a pinned host twin, so `load` stages host
    arrays with one asynchronous copy.  ``specs`` are the inputs'
    ``(shape, torch dtype)``.  A CUDA tensor given to `load` is copied
    into its slot device to device."""

    def __init__(self, specs, device):
        offs, total = [], 0
        for shape, dtype in specs:
            offs.append(total)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            total += -(-nbytes // 16) * 16
        self._pinned = torch.empty(max(total, 16), dtype=torch.uint8,
                                   pin_memory=True)
        self._buf = torch.empty(max(total, 16), dtype=torch.uint8,
                                device=device)
        self._host, self.inputs = [], []
        for (shape, dtype), off in zip(specs, offs):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            host = self._pinned[off:off + n].view(dtype).view(shape)
            # a dtype numpy lacks (bfloat16) arrives as a torch tensor only
            self._host.append(host.numpy() if dtype != torch.bfloat16
                              else None)
            self.inputs.append(self._buf[off:off + n].view(dtype).view(
                shape))
        self._copied = torch.cuda.Event()

    @classmethod
    def of(cls, values, device):
        """Slots shaped as ``values`` (numpy arrays or torch tensors)."""
        return cls([(tuple(np.shape(a)), _torch_dtype(a)) for a in values],
                   device)

    def load(self, values):
        """Stage ``values`` into the static inputs, on the current stream.
        The pinned buffer is rewritten only once its last copy is done."""
        self._copied.synchronize()
        tensors = []
        for dst, slot, a in zip(self._host, self.inputs, values):
            if isinstance(a, torch.Tensor):
                if a.is_cuda or dst is None:
                    tensors.append((slot, a))
                    continue
                a = a.detach().numpy()
            dst[...] = a
        self._buf.copy_(self._pinned, non_blocking=True)
        self._copied.record()
        for slot, a in tensors:  # after the bulk copy, which they overwrite
            slot.copy_(a, non_blocking=True)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def fresh(tree, keep=frozenset()):
    """A copy of every tensor in ``tree`` (tuples, lists, dicts), so the
    caller owns what a graph's static outputs held; a tensor whose
    ``id`` is in ``keep`` passes as it is."""
    if isinstance(tree, torch.Tensor):
        return tree if id(tree) in keep else tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(fresh(t, keep) for t in tree)
    if isinstance(tree, dict):
        return {k: fresh(v, keep) for k, v in tree.items()}
    return tree


class _Entry:
    __slots__ = ("staged", "graph", "out")


class SignatureGraphs:
    """One CUDA graph of ``fn`` a signature of its inputs (names, shapes,
    dtypes), captured at the signature's first call and replayed after:
    the port's counterpart of the JAX package's one executable a feed
    signature.  ``fn`` takes a dict of device tensors and returns a tree
    of tensors.

    A signature's first call stages its inputs, runs ``fn`` eagerly on a
    side stream (that call's result; its kernels count as launches), then
    captures it.  Later calls stage their inputs into the static ones and
    replay.  Each call hands its result through ``take`` while it holds
    the lock, before any other call can replay over the graph's static
    outputs: by default `fresh` copies, so a result stays the caller's
    after later calls; a caller that copies to the host anyway passes
    its own.  The lock serializes calls, so threads may share one
    instance (the Predictor's clones)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self._graphs: Dict[Any, _Entry] = {}
        self._lock = threading.Lock()
        # recorded after each call's ``take``: the next call, on whatever
        # stream, waits for it before it writes the static inputs
        self._done = None

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        with self._lock:
            self._graphs.clear()

    def __call__(self, inputs: Dict[str, Any], take=fresh):
        sig = tuple((k, tuple(np.shape(v)), _torch_dtype(v))
                    for k, v in inputs.items())
        with self._lock:
            cur = torch.cuda.current_stream(self.device)
            if self._done is None:
                self._done = torch.cuda.Event()
            else:
                cur.wait_event(self._done)
            entry = self._graphs.get(sig)
            if entry is None:
                entry, out = self._capture(inputs)
                self._graphs[sig] = entry
            else:
                entry.staged.load(list(inputs.values()))
                entry.graph.replay()
                out = entry.out
            out = take(out)
            self._done.record(cur)
            return out

    def _capture(self, inputs):
        entry = _Entry()
        entry.staged = StagedInputs.of(list(inputs.values()), self.device)
        entry.staged.load(list(inputs.values()))
        static = dict(zip(inputs, entry.staged.inputs))
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self.fn(static)
            entry.graph, entry.out = capture(lambda: self.fn(static))
        cur.wait_stream(side)
        for t in _tensors(first):  # made on the side stream, used on cur
            t.record_stream(cur)
        return entry, first
