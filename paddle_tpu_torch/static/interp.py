"""ProgramDesc interpreter over torch (counterpart:
paddle_tpu/static/interp.py).

Reference counterpart: the single-thread `Executor::Run` op loop
(`framework/executor.cc:292`) + `NaiveExecutor` used by the inference
predictor (`inference/api/analysis_predictor.cc:889`).  Each op of a
block is translated to torch / paddle_tpu_torch functional calls and run
in program order.  Where the JAX package compiles a whole block to one
XLA executable a feed signature, `ProgramRunner` captures one CUDA graph
a feed signature on the card and replays it after (the port's
``switch_ir_optim``); on the CPU, with ``jit=False`` and for programs
that cannot be captured, the ops run one by one.

The op set is the JAX interpreter's: the hand-written translators here
plus the declarative OpDesc->eager bridge (`op_bridge.py`, imported at
the end of this module), less the ``*_grad`` ops (`run_grad_op`, static
training, comes with the next slice).  Unknown ops raise with the op
name.

Control flow runs eagerly: `while`, `conditional_block` and `recurrent`
read their condition (or trip count) on the host, so a program holding
one is never captured.  TensorArrays keep the JAX package's
fixed-capacity ``[cap, ...]`` buffer with a length; the length is a
host integer here.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import warnings
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops.capture import SignatureGraphs, fresh
from .proto import vartype_to_np_dtype

OP_TRANSLATORS: Dict[str, Callable] = {}

# op types whose OUTPUT SHAPE depends on input VALUES, or that do host
# IO: a CUDA graph cannot hold them, so ProgramRunner runs programs
# holding one op by op.  op_bridge extends this set as it registers
# such ops.
DYNAMIC_SHAPE_OPS = {"masked_select", "where_index", "unique",
                     "unique_with_counts", "linspace", "sequence_unpad"}

# sub-block ops that read their condition on the host (eager here; the
# JAX package compiles them into lax.while_loop / lax.cond / lax.scan)
HOST_CONTROL_OPS = {"while", "conditional_block", "conditional_block_infer",
                    "recurrent"}


def register(*names):
    def deco(fn):
        for n in names:
            OP_TRANSLATORS[n] = fn
        return fn
    return deco


class OpView:
    """Convenience accessor over a decoded OpDesc dict."""

    def __init__(self, desc: Dict[str, Any]):
        self.desc = desc
        self.type = desc["type"]
        self._in = {v["parameter"]: v.get("arguments", [])
                    for v in desc.get("inputs", [])}
        self._out = {v["parameter"]: v.get("arguments", [])
                     for v in desc.get("outputs", [])}
        self._attrs = {}
        for a in desc.get("attrs", []):
            self._attrs[a["name"]] = _attr_value(a)

    def input(self, name, idx=0, default=None):
        args = self._in.get(name) or []
        return args[idx] if len(args) > idx else default

    def inputs(self, name):
        return self._in.get(name) or []

    def output(self, name, idx=0, default=None):
        args = self._out.get(name) or []
        return args[idx] if len(args) > idx else default

    def outputs(self, name):
        return self._out.get(name) or []

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def _attr_value(a: Dict[str, Any]):
    from .proto import AttrType as T

    t = a.get("type")
    if t == T.INT:
        return a.get("i", 0)
    if t == T.FLOAT:
        return a.get("f", 0.0)
    if t == T.STRING:
        return a.get("s", "")
    if t == T.INTS:
        return a.get("ints", [])
    if t == T.FLOATS:
        return a.get("floats", [])
    if t == T.STRINGS:
        return a.get("strings", [])
    if t == T.BOOLEAN:
        return a.get("b", False)
    if t == T.BOOLEANS:
        return a.get("bools", [])
    if t == T.LONG:
        return a.get("l", 0)
    if t == T.LONGS:
        return a.get("longs", [])
    if t == T.FLOAT64S:
        return a.get("float64s", [])
    if t == T.BLOCK:
        return a.get("block_idx", 0)
    if t == T.BLOCKS:
        return a.get("blocks_idx", [])
    return None


# ---------------------------------------------------------------------------
# run context: the blocks of the program, the device new tensors land on,
# the desc-level constants and bounds
# ---------------------------------------------------------------------------
_BLOCKS_TLS = threading.local()


@contextlib.contextmanager
def blocks_context(blocks, device=None, host_consts=None):
    """The program run's context: its blocks, its device, and
    ``host_consts``, the device copies of constants the program builds
    from host data (a runner keeps its own across runs: a CUDA-graph
    capture cannot copy host memory to the card)."""
    prev = (getattr(_BLOCKS_TLS, "blocks", None),
            getattr(_BLOCKS_TLS, "consts", None),
            getattr(_BLOCKS_TLS, "bounds", None),
            getattr(_BLOCKS_TLS, "device", None),
            getattr(_BLOCKS_TLS, "host_consts", None))
    _BLOCKS_TLS.blocks = blocks
    _BLOCKS_TLS.consts = {}
    _BLOCKS_TLS.bounds = {}
    _BLOCKS_TLS.device = torch.device(device) if device is not None \
        else torch.device("cpu")
    _BLOCKS_TLS.host_consts = {} if host_consts is None else host_consts
    try:
        yield
    finally:
        (_BLOCKS_TLS.blocks, _BLOCKS_TLS.consts, _BLOCKS_TLS.bounds,
         _BLOCKS_TLS.device, _BLOCKS_TLS.host_consts) = prev


def _host_const(key, make):
    """The device tensor ``make()`` builds from host data, made once a
    program run context and reused (an op's attrs, or a static shape,
    define it)."""
    cache = getattr(_BLOCKS_TLS, "host_consts", None)
    if cache is None:
        return make()
    t = cache.get(key)
    if t is None:
        t = cache[key] = make()
    return t


def _current_blocks():
    blocks = getattr(_BLOCKS_TLS, "blocks", None)
    if blocks is None:
        raise RuntimeError(
            "control-flow op interpreted outside a program context; run "
            "through ProgramRunner / static.Executor / the Predictor")
    return blocks


def _dev() -> torch.device:
    """The device of the program run (new tensors land here)."""
    d = getattr(_BLOCKS_TLS, "device", None)
    return d if d is not None else torch.device("cpu")


def _dt(code) -> torch.dtype:
    """VarType POD code -> torch dtype."""
    return getattr(torch, vartype_to_np_dtype(int(code)))


def _tensor(v, dtype=None) -> torch.Tensor:
    """A tensor on the run's device (numpy, lists and scalars too)."""
    if isinstance(v, torch.Tensor):
        return v if dtype is None else v.to(dtype)
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(v)).to(_dev())
        return t if dtype is None else t.to(dtype)
    return torch.as_tensor(v, dtype=dtype, device=_dev())


def _fl(x):
    """x as a floating tensor (jnp promotes integers to float32)."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _host_read(t, what="a value"):
    """Read a device tensor on the host; loud inside a CUDA-graph
    capture, where the read would sync the stream."""
    if isinstance(t, torch.Tensor) and t.is_cuda and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"program op reads {what} on the host while a CUDA graph "
            "captures (the read would sync the stream); run the program "
            "with switch_ir_optim(False) / ProgramRunner(jit=False)")
    return t


def _full(shape, value, dtype):
    if not dtype.is_floating_point and not dtype.is_complex:
        value = bool(value) if dtype == torch.bool else int(value)
    return torch.full([int(s) for s in shape], value, dtype=dtype,
                      device=_dev())


class FusedSlice:
    """coalesce_tensor output alias: a live view into the fused buffer
    (reference `operators/coalesce_tensor_op.cc` makes each Output a
    sub-tensor of FusedOutput, so a later write to the fused buffer —
    the fleet's single fused allreduce — must be observed by reads of
    the component vars).  Resolved lazily at scope-read time; a direct
    write to the component var replaces the view."""

    __slots__ = ("fused", "offset", "shape")

    def __init__(self, fused, offset, shape):
        self.fused = fused
        self.offset = int(offset)
        self.shape = tuple(int(s) for s in shape)

    def resolve(self, scope):
        buf = scope[self.fused].reshape(-1)
        n = int(np.prod(self.shape)) if self.shape else 1
        return buf[self.offset:self.offset + n].reshape(self.shape)


class Scope(dict):
    """name -> tensor (or a TensorArray / rank table / FusedSlice)."""

    def __getitem__(self, name):
        v = dict.__getitem__(self, name)
        if isinstance(v, FusedSlice):
            return v.resolve(self)
        return v

    def __setitem__(self, name, value):
        # two-way aliasing for coalesce_tensor components: a write to a
        # var that currently holds a FusedSlice view lands in the fused
        # buffer
        cur = dict.get(self, name)
        if isinstance(cur, FusedSlice) and \
                not isinstance(value, FusedSlice):
            n = int(np.prod(cur.shape)) if cur.shape else 1
            flat = _tensor(value).reshape(-1)
            if flat.numel() == n and cur.fused in self:
                buf = self[cur.fused].reshape(-1).clone()
                buf[cur.offset:cur.offset + n] = flat.to(buf.dtype)
                self[cur.fused] = buf
                return  # the view stays live over the updated buffer
        dict.__setitem__(self, name, value)

    def update(self, other=(), **kw):
        # dict.update bypasses __setitem__ at the C level; route through
        # it so aliased writes keep their write-through semantics
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def get(self, name, default=None):  # route through view resolution
        return self[name] if name in self else default

    def fetch(self, name):
        if name not in self:
            raise KeyError(f"variable {name!r} not produced by the program")
        return self[name]


def run_block(block_ops: List[Dict[str, Any]], scope: Scope,
              feeds: Dict[str, Any], fetch_holder: Dict[int, Any]):
    """Interpret a block's ops in order (program order IS execution order
    in the reference executor)."""
    for raw in block_ops:
        op = OpView(raw)
        fn = OP_TRANSLATORS.get(op.type)
        if fn is None:
            if op.type.endswith("_grad") and \
                    op.attr("__forward_op__") is not None:
                run_grad_op(op, scope, feeds, fetch_holder)
                continue
            raise NotImplementedError(
                f"ProgramDesc op {op.type!r} has no translation in "
                "paddle_tpu_torch")
        fn(op, scope, feeds, fetch_holder)
        _fold_consts(op)
        _propagate_lod(op, scope)


# Ops whose outputs keep row-for-row correspondence with their primary
# input, so the padded+lengths @LOD sidecar travels through them
_LOD_PRESERVING = {
    "lookup_table", "lookup_table_v2", "c_embedding", "cast", "scale",
    "assign", "dropout", "relu", "sigmoid", "tanh", "gelu", "softmax",
    "layer_norm", "matmul_v2", "matmul", "mul", "fc",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "reshape2", "reshape", "sequence_softmax",
}


def _propagate_lod(op: OpView, scope: Scope):
    if op.type not in _LOD_PRESERVING:
        return
    slot = "Ids" if op.type in ("lookup_table", "lookup_table_v2",
                                "c_embedding") else "X"
    name = op.input(slot)
    if not name or name + "@LOD" not in scope:
        return
    lod = scope[name + "@LOD"]
    b = lod.shape[0]
    for s in op.desc.get("outputs", []):
        for a in s.get("arguments", []):
            out = scope.get(a)
            if isinstance(out, torch.Tensor) and out.ndim >= 1 and \
                    out.shape[0] == b:
                scope[a + "@LOD"] = lod


def _consts() -> Dict[str, Any]:
    """Desc-level constant map for the active program run: ops whose
    value is defined purely by attrs (fill_constant chains) are known as
    numpy values without reading a device tensor; translators that need
    static values (TensorArray write indices, while trip bounds) consult
    this instead of the scope."""
    c = getattr(_BLOCKS_TLS, "consts", None)
    if c is None:
        c = _BLOCKS_TLS.consts = {}
    return c


def _consts_bounds() -> Dict[str, int]:
    b = getattr(_BLOCKS_TLS, "bounds", None)
    if b is None:
        b = _BLOCKS_TLS.bounds = {}
    return b


def _fold_consts(op: OpView):
    """Track outputs of statically-evaluable op chains as numpy values;
    any op outside the folding set invalidates its outputs."""
    c = _consts()
    t = op.type
    try:
        if t == "fill_constant":
            shape = [int(s) for s in op.attr("shape", [])]
            dt = vartype_to_np_dtype(op.attr("dtype", 5))
            c[op.output("Out")] = np.full(shape, op.attr("value", 0.0),
                                          dt)
            return
        if t == "assign_value":
            for key in ("fp32_values", "int32_values", "int64_values",
                        "bool_values"):
                vals = op.attr(key)
                if vals:
                    shape = [int(s) for s in op.attr("shape", [])]
                    c[op.output("Out")] = np.asarray(vals).reshape(shape)
                    return
        if t == "cast" and op.input("X") in c:
            c[op.output("Out")] = c[op.input("X")].astype(
                vartype_to_np_dtype(op.attr("out_dtype", 5)))
            return
        if t == "scale" and op.input("X") in c:
            x = c[op.input("X")]
            s, b = op.attr("scale", 1.0), op.attr("bias", 0.0)
            c[op.output("Out")] = (x * s + b) \
                if op.attr("bias_after_scale", True) else (x + b) * s
            return
        if t == "increment" and op.input("X") in c:
            x = c[op.input("X")]
            c[op.output("Out")] = x + np.asarray(
                op.attr("step", 1.0)).astype(x.dtype)
            return
        if t == "assign" and op.input("X") in c:
            c[op.output("Out")] = c[op.input("X")]
            return
    except Exception:
        pass
    for args in op._out.values():
        for a in args:
            c.pop(a, None)


def run_grad_op(op: OpView, scope: Scope, feeds, fetch_holder):
    """The generic grad-op executor of static training.  The JAX package
    differentiates the embedded forward op under ``jax.vjp``; its port
    (`static/backward.py`, ``append_backward``) comes with the next
    slice, 4b."""
    raise NotImplementedError(
        f"grad op {op.type!r}: static training (run_grad_op, "
        "append_backward) is not ported yet; it lands with slice 4b "
        "(ROADMAP.md Queue 1, item 4b)")


# ---------------------------------------------------------------------------
# ProgramRunner: the block interpreter, eager or one CUDA graph a feed
# signature
# ---------------------------------------------------------------------------
def _to_device(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device)


def host_read_ops(program) -> List[str]:
    """The op types of ``program`` a CUDA graph cannot hold: data-
    dependent output shapes and host IO (`DYNAMIC_SHAPE_OPS`, as the
    JAX package), and sub-block ops that read their condition on the
    host (`HOST_CONTROL_OPS`; the JAX package compiles those)."""
    types = {o["type"] for blk in program.desc["blocks"]
             for o in blk["ops"]}
    return sorted(types & (DYNAMIC_SHAPE_OPS | HOST_CONTROL_OPS))


class ProgramRunner:
    """Block interpreter shared by `static.Executor` and the inference
    Predictor.  ``jit=True`` (the default, ``Config.switch_ir_optim``)
    captures one CUDA graph a feed signature on the card, at the first
    run of that signature, and replays it after — the counterpart of
    the JAX package's one XLA executable a signature; on the CPU it runs
    the ops one by one.  ``jit=False`` always runs op by op (the
    reference's un-optimized NaiveExecutor loop).

    Programs a graph cannot hold run op by op with a warning: those with
    a data-dependent-shape op (as the JAX package) and, unlike the JAX
    package, which compiles them, those with a sub-block op that reads
    its condition on the host (``while``, ``conditional_block``,
    ``recurrent``).  A translator that reads a device value on the host
    while a graph captures raises; there is no quiet fallback.

    ``donate_feeds`` (``Config.enable_memory_optim``): the JAX package
    donates the feed buffers to its executable; here the feeds are
    copied into the graph's static inputs, so the flag changes nothing
    but is taken.  Results are equal either way.

    Parameters live on ``device`` (default: the card).  The runner owns
    its parameter storage: `run_with_scope` copies new values into it
    (a captured graph reads those addresses).  What a run hands out is
    the caller's: a replay's fetches are copies of the graph's outputs,
    which the next replay rewrites.  Calls through one runner are
    serialized on its graphs, so threads may share it."""

    def __init__(self, program, scope: Dict[str, Any], jit: bool = True,
                 donate_feeds: bool = False, device=None):
        from ..core.place import to_device
        from ..device import resolve_device

        self.program = program
        self.device = resolve_device(None if device is None
                                     else to_device(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = {k: _to_device(v, self.device)
                       for k, v in scope.items()}
        self.feed_names = program.feed_target_names()
        self.fetch_names = program.fetch_target_names()
        self.donate_feeds = bool(donate_feeds)
        if jit:
            held = host_read_ops(program)
            if held:
                warnings.warn(
                    f"program contains ops a CUDA graph cannot hold "
                    f"{held}; running op-by-op without the captured graph")
                jit = False
        self.jit = bool(jit)
        # one CUDA graph a feed signature (`ops.capture.SignatureGraphs`);
        # None when the ops run one by one
        self._graphs = SignatureGraphs(
            lambda feeds: self._pure(self.params, feeds), self.device) \
            if self.jit and self.device.type == "cuda" else None
        self._host_consts: Dict[Any, torch.Tensor] = {}
        self._ops = program.desc["blocks"][0]["ops"]
        self._blocks = program.desc["blocks"]

    def _pure(self, params, feeds):
        s = Scope(params)
        fetches: Dict[int, Any] = {}
        with blocks_context(self._blocks, self.device, self._host_consts):
            run_block(self._ops, s, feeds, fetches)
        return tuple(fetches[k] for k in sorted(fetches)), \
            {k: s[k] for k in s}

    def _run(self, feeds, pick, take=None):
        """Run the block on ``feeds`` (host arrays or tensors, by name).
        ``pick(fetches, scope)`` chooses what is handed out and ``take``
        makes it the caller's: by default the values themselves when the
        ops ran eagerly, and from a graph fresh copies (the runner's own
        parameters pass as they are), since the next replay rewrites the
        graph's outputs."""
        if self._graphs is None:
            feeds = {k: _to_device(v, self.device) for k, v in feeds.items()}
            out = pick(*self._pure(self.params, feeds))
            return out if take is None else take(out)
        if take is None:
            own = {id(p) for p in self.params.values()}
            take = functools.partial(fresh, keep=own)
        return self._graphs(feeds, lambda out: take(pick(*out)))

    def graph_count(self) -> int:
        """CUDA graphs captured so far (one a feed signature)."""
        return 0 if self._graphs is None else len(self._graphs)

    def _feeds(self, inputs):
        return dict(zip(self.feed_names, inputs))

    def __call__(self, *inputs, take=None):
        """The fetch targets on positional feeds.  ``take`` (keyword):
        see `_run`; the Predictor copies to the host with it."""
        return self._run(self._feeds(inputs), lambda f, s: f, take)

    def run_with_lods(self, inputs, lods, return_lods=False, take=None):
        """Run with per-feed sequence lengths (`<name>@LOD` sidecars,
        the padded+lengths LoD redesign — Predictor handle set_lod).
        With ``return_lods``, also return each fetch target's output
        lengths sidecar."""
        feeds = self._feeds(inputs)
        for name, lengths in lods.items():
            if name in feeds and np.shape(lengths)[0] != \
                    np.shape(feeds[name])[0]:
                raise ValueError(
                    f"set_lod for {name!r}: {np.shape(lengths)[0]} sequence "
                    f"lengths for a batch of {np.shape(feeds[name])[0]} rows")
            feeds[name + "@LOD"] = lengths
        if not return_lods:
            return self._run(feeds, lambda f, s: f, take)
        return self._run(feeds, lambda f, s: (f, [
            s.get(fn + "@LOD") for fn in self.fetch_names]), take)

    def run_with_scope(self, feeds, params=None, names=None):
        """``(fetches, scope)`` of a run, the scope cut to ``names`` when
        given.  ``params`` overrides parameter values: each is copied
        into the runner's own storage (a new name joins it and drops the
        captured graphs)."""
        if params:
            for k, v in params.items():
                v = _to_device(v, self.device)
                cur = self.params.get(k)
                if cur is v:
                    continue
                if cur is not None and cur.shape == v.shape and \
                        cur.dtype == v.dtype:
                    cur.copy_(v)
                else:
                    self.params[k] = v
                    if self._graphs is not None:
                        self._graphs.clear()
        if names is None:
            return self._run(feeds, lambda f, s: (f, s))
        return self._run(feeds, lambda f, s: (
            f, {k: s[k] for k in names if k in s}))


# ---------------------------------------------------------------------------
# feed / fetch / data movement
# ---------------------------------------------------------------------------
@register("feed")
def _feed(op, scope, feeds, fetches):
    name = op.output("Out")
    if name not in feeds:
        raise KeyError(f"feed variable {name!r} missing from feed dict")
    scope[name] = _tensor(feeds[name])
    if name + "@LOD" in feeds:
        scope[name + "@LOD"] = _tensor(feeds[name + "@LOD"])


@register("fetch")
def _fetch(op, scope, feeds, fetches):
    col = op.attr("col", 0)
    fetches[col] = scope.fetch(op.input("X"))


@register("assign", "share_data", "memcpy")
def _assign(op, scope, feeds, fetches):
    scope[op.output("Out")] = scope.fetch(op.input("X"))


@register("assign_value")
def _assign_value(op, scope, feeds, fetches):
    shape = [int(s) for s in op.attr("shape", [])]
    dtype = _dt(op.attr("dtype", 5))

    def make():
        for key in ("fp32_values", "int32_values", "int64_values",
                    "bool_values"):
            vals = op.attr(key)
            if vals:
                return _tensor(np.asarray(vals).reshape(shape)).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=_dev())

    scope[op.output("Out")] = _host_const(("assign_value", id(op.desc)),
                                          make)


@register("fill_constant")
def _fill_constant(op, scope, feeds, fetches):
    shape = [int(s) for s in op.attr("shape", [])]
    scope[op.output("Out")] = _full(shape, op.attr("value", 0.0),
                                    _dt(op.attr("dtype", 5)))


@register("fill_any_like")
def _fill_any_like(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = _full(x.shape, op.attr("value", 0.0),
                                    x.dtype)


@register("cast")
def _cast(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = x.to(_dt(op.attr("out_dtype", 5)))


@register("shape")
def _shape(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    scope[op.output("Out")] = _host_const(
        ("shape", tuple(x.shape)), lambda: torch.tensor(
            list(x.shape), dtype=torch.int32, device=_dev()))


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------
@register("mul")
def _mul(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    y = scope.fetch(op.input("Y"))
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    xm = x.reshape(int(np.prod(x.shape[:xnc])), -1)
    ym = y.reshape(int(np.prod(y.shape[:ync])), -1)
    out = xm @ ym
    scope[op.output("Out")] = out.reshape(
        tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))


@register("matmul")
def _matmul(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    y = scope.fetch(op.input("Y"))
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    scope[op.output("Out")] = torch.matmul(x, y) * op.attr("alpha", 1.0)


@register("matmul_v2")
def _matmul_v2(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    y = scope.fetch(op.input("Y"))
    if op.attr("trans_x", False):
        x = x.transpose(-1, -2)
    if op.attr("trans_y", False):
        y = y.transpose(-1, -2)
    scope[op.output("Out")] = torch.matmul(x, y)


@register("fc")
def _fc(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("W"))
    in_num_col_dims = op.attr("in_num_col_dims", 1)
    xm = x.reshape(int(np.prod(x.shape[:in_num_col_dims])), -1)
    out = xm @ w
    b = op.input("Bias")
    if b:
        out = out + scope.fetch(b)
    if op.attr("activation_type", "") == "relu":
        out = torch.clamp_min(out, 0)
    scope[op.output("Out")] = out.reshape(
        tuple(x.shape[:in_num_col_dims]) + (w.shape[1],))


# ---------------------------------------------------------------------------
# elementwise / unary
# ---------------------------------------------------------------------------
def _broadcast_ew(op, scope, fn):
    x = scope.fetch(op.input("X"))
    y = scope.fetch(op.input("Y"))
    axis = op.attr("axis", -1)
    if axis != -1 and y.ndim < x.ndim:
        # reference broadcast: align y's dims starting at `axis`
        shape = [1] * x.ndim
        for i, d in enumerate(y.shape):
            shape[axis + i] = d
        y = y.reshape(shape)
    scope[op.output("Out")] = fn(x, y)


def _true_div(x, y):
    return torch.true_divide(x, y)


for _name, _fn in [
    ("elementwise_add", torch.add), ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul), ("elementwise_div", _true_div),
    ("elementwise_max", torch.maximum), ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
    ("elementwise_mod", torch.remainder),
    ("elementwise_floordiv", torch.floor_divide),
]:
    def _mk(fn):
        def _op(op, scope, feeds, fetches):
            _broadcast_ew(op, scope, fn)
        return _op
    OP_TRANSLATORS[_name] = _mk(_fn)


def _softplus(x):
    x = _fl(x)
    return torch.logaddexp(x, torch.zeros_like(x))


for _name, _fn in [
    ("relu", lambda x: torch.clamp_min(x, 0)),
    ("sigmoid", lambda x: torch.sigmoid(_fl(x))),
    ("tanh", lambda x: torch.tanh(_fl(x))),
    ("sqrt", lambda x: torch.sqrt(_fl(x))),
    ("rsqrt", lambda x: torch.rsqrt(_fl(x))),
    ("square", torch.square), ("abs", torch.abs),
    ("exp", lambda x: torch.exp(_fl(x))),
    ("log", lambda x: torch.log(_fl(x))),
    ("floor", lambda x: torch.floor(_fl(x))),
    ("ceil", lambda x: torch.ceil(_fl(x))),
    ("round", lambda x: torch.round(_fl(x))),
    ("reciprocal", lambda x: 1.0 / x),
    ("softsign", lambda x: x / (1 + torch.abs(x))),
    ("softplus", _softplus), ("silu", lambda x: TF.silu(_fl(x))),
    ("logsigmoid", lambda x: TF.logsigmoid(_fl(x))),
    ("relu6", lambda x: torch.clamp(x, 0, 6)),
    ("mish", lambda x: x * torch.tanh(_softplus(x))),
    ("sin", lambda x: torch.sin(_fl(x))),
    ("cos", lambda x: torch.cos(_fl(x))),
    ("erf", lambda x: torch.special.erf(_fl(x))),
    ("sign", torch.sign),
]:
    def _mk1(fn):
        def _op(op, scope, feeds, fetches):
            scope[op.output("Out")] = fn(scope.fetch(op.input("X")))
        return _op
    OP_TRANSLATORS[_name] = _mk1(_fn)


@register("gelu")
def _gelu(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = TF.gelu(
        _fl(x), approximate="tanh" if op.attr("approximate", False)
        else "none")


@register("leaky_relu")
def _leaky_relu(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    alpha = op.attr("alpha", 0.02)
    if op.attr("__legacy_formula__", False):
        # pre-version-1 programs (op_version.py): out = max(x, alpha*x)
        scope[op.output("Out")] = torch.maximum(x, alpha * x)
        return
    scope[op.output("Out")] = torch.where(x > 0, x, alpha * x)


@register("prelu")
def _prelu(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    alpha = scope.fetch(op.input("Alpha"))
    mode = op.attr("mode", "all")
    if mode == "channel" and alpha.numel() > 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    scope[op.output("Out")] = torch.where(x > 0, x, alpha * x)


@register("hard_sigmoid")
def _hard_sigmoid(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    slope = op.attr("slope", 0.2)
    offset = op.attr("offset", 0.5)
    scope[op.output("Out")] = torch.clamp(slope * x + offset, 0.0, 1.0)


@register("hard_swish")
def _hard_swish(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    threshold = op.attr("threshold", 6.0)
    scale = op.attr("scale", 6.0)
    offset = op.attr("offset", 3.0)
    scope[op.output("Out")] = x * torch.clamp(x + offset, 0,
                                              threshold) / scale


@register("swish")
def _swish(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    beta = op.attr("beta", 1.0)
    scope[op.output("Out")] = x * torch.sigmoid(beta * x)


@register("scale")
def _scale(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    s = op.attr("scale", 1.0)
    b = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    scope[op.output("Out")] = out


@register("clip")
def _clip(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.clamp(x, op.attr("min", 0.0),
                                          op.attr("max", 0.0))


@register("pow")
def _pow(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.pow(x, op.attr("factor", 1.0))


@register("sum")
def _sum(op, scope, feeds, fetches):
    xs = [scope.fetch(n) for n in op.inputs("X")]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    scope[op.output("Out")] = out


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
@register("reshape", "reshape2")
def _reshape(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    shape = [int(s) for s in op.attr("shape", [])]
    # 0 means "copy input dim" in the reference reshape
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    scope[op.output("Out")] = x.reshape(shape)


@register("transpose", "transpose2")
def _transpose(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    axis = op.attr("axis", None)
    if axis is None or (not axis and x.ndim):
        axis = list(range(x.ndim))[::-1]
    scope[op.output("Out")] = x.permute([int(a) for a in axis])


@register("flatten2", "flatten", "flatten_contiguous_range")
def _flatten(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    if op.type == "flatten_contiguous_range":
        start = op.attr("start_axis", 1)
        stop = op.attr("stop_axis", -1)
        stop = stop % x.ndim
        shape = (tuple(x.shape[:start])
                 + (int(np.prod(x.shape[start:stop + 1])),)
                 + tuple(x.shape[stop + 1:]))
    else:
        ax = op.attr("axis", 1)
        shape = (int(np.prod(x.shape[:ax])), int(np.prod(x.shape[ax:])))
    scope[op.output("Out")] = x.reshape(shape)


@register("squeeze", "squeeze2")
def _squeeze(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    axes = op.attr("axes", [])
    if axes:
        for ax in sorted((a % x.ndim for a in axes), reverse=True):
            if x.shape[ax] == 1:
                x = x.squeeze(ax)
    else:
        x = x.squeeze()
    scope[op.output("Out")] = x


@register("unsqueeze", "unsqueeze2")
def _unsqueeze(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    for ax in sorted(op.attr("axes", [])):
        x = x.unsqueeze(ax)
    scope[op.output("Out")] = x


@register("concat")
def _concat(op, scope, feeds, fetches):
    xs = [scope.fetch(n) for n in op.inputs("X")]
    scope[op.output("Out")] = torch.cat(xs, dim=op.attr("axis", 0))


def _split_parts(x, axis, sections, num):
    if sections:
        idx = np.cumsum(sections[:-1]).tolist()
        return list(torch.tensor_split(x, idx, dim=axis))
    return list(torch.tensor_split(x, num, dim=axis))


@register("split")
def _split(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    outs = op._out.get("Out", [])
    parts = _split_parts(x, op.attr("axis", 0), op.attr("sections", []),
                         op.attr("num", 0) or len(outs))
    for name, part in zip(outs, parts):
        scope[name] = part


@register("stack")
def _stack(op, scope, feeds, fetches):
    xs = [scope.fetch(n) for n in op.inputs("X")]
    scope[op.output("Y")] = torch.stack(xs, dim=op.attr("axis", 0))


@register("slice")
def _slice(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    axes = op.attr("axes", [])
    starts = op.attr("starts", [])
    ends = op.attr("ends", [])
    idx = [slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = slice(int(s), int(min(e, x.shape[ax])))
    out = x[tuple(idx)]
    for ax in sorted(op.attr("decrease_axis", []), reverse=True):
        if out.shape[ax] != 1:  # jnp.squeeze refuses a dim of another size
            raise ValueError(
                f"slice: decrease_axis {ax} has size {out.shape[ax]}, not 1")
        out = out.squeeze(ax)
    scope[op.output("Out")] = out


@register("gather")
def _gather(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    idx = scope.fetch(op.input("Index"))
    scope[op.output("Out")] = x[idx.long()]


@register("expand_v2")
def _expand_v2(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    shape = [int(s) for s in op.attr("shape", [])]
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    scope[op.output("Out")] = torch.broadcast_to(x, shape)


@register("tile")
def _tile(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = x.tile(tuple(op.attr("repeat_times", [])))


# ---------------------------------------------------------------------------
# reductions / search
# ---------------------------------------------------------------------------
def _reduce_tensor(kind, x, axes, keep):
    """jnp's reductions over a tuple of axes (None: all)."""
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(sorted(int(a) % max(x.ndim, 1) for a in axes))
    if x.ndim == 0:
        if kind == "mean":
            return _fl(x)
        if kind in ("all", "any"):
            return x.bool()
        return x
    if kind == "sum":
        return torch.sum(x, dim=axes, keepdim=keep)
    if kind == "mean":
        return torch.mean(_fl(x), dim=axes, keepdim=keep)
    if kind == "max":
        return torch.amax(x, dim=axes, keepdim=keep)
    if kind == "min":
        return torch.amin(x, dim=axes, keepdim=keep)
    fn = {"prod": torch.prod, "all": torch.all, "any": torch.any}[kind]
    out = x.bool() if kind in ("all", "any") else x
    for a in sorted(axes, reverse=True):
        out = fn(out, dim=a, keepdim=keep)
    return out


def _reduce_axes(op, x):
    if op.attr("reduce_all", False):
        return None
    dims = op.attr("dim", [0]) or [0]
    return tuple(int(d) % x.ndim for d in dims)


for _name, _kind in [
    ("reduce_sum", "sum"), ("reduce_mean", "mean"),
    ("reduce_max", "max"), ("reduce_min", "min"),
    ("reduce_prod", "prod"), ("reduce_all", "all"),
    ("reduce_any", "any"),
]:
    def _mkr(kind):
        def _op(op, scope, feeds, fetches):
            x = scope.fetch(op.input("X"))
            scope[op.output("Out")] = _reduce_tensor(
                kind, x, _reduce_axes(op, x), op.attr("keep_dim", False))
        return _op
    OP_TRANSLATORS[_name] = _mkr(_kind)


@register("mean")
def _mean(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.mean(_fl(scope.fetch(op.input("X"))))


@register("arg_max")
def _arg_max(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    axis = int(op.attr("axis", -1))
    out = torch.argmax(x, dim=axis)
    if op.attr("keepdims", False):
        out = out.unsqueeze(axis)
    scope[op.output("Out")] = out.to(torch.int64)


def _top_k_last(x, k):
    """lax.top_k: the k largest along the last axis, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("top_k", "top_k_v2")
def _top_k(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    vals, idx = _top_k_last(x, int(op.attr("k", 1)))
    scope[op.output("Out")] = vals
    scope[op.output("Indices")] = idx.to(torch.int64)


for _name, _cmp in [
    ("equal", torch.eq), ("not_equal", torch.ne),
    ("less_than", torch.lt), ("less_equal", torch.le),
    ("greater_than", torch.gt), ("greater_equal", torch.ge),
    ("logical_and", lambda a, b: torch.logical_and(a, b)),
    ("logical_or", lambda a, b: torch.logical_or(a, b)),
    ("logical_xor", lambda a, b: torch.logical_xor(a, b)),
]:
    def _mkc(fn):
        def _op(op, scope, feeds, fetches):
            scope[op.output("Out")] = fn(scope.fetch(op.input("X")),
                                         scope.fetch(op.input("Y")))
        return _op
    OP_TRANSLATORS[_name] = _mkc(_cmp)


@register("logical_not")
def _logical_not(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.logical_not(scope.fetch(op.input("X")))


@register("where")
def _where(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.where(
        scope.fetch(op.input("Condition")).bool(),
        scope.fetch(op.input("X")), scope.fetch(op.input("Y")))


@register("fill_zeros_like", "fill_zeros_like2")
def _fill_zeros_like(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.zeros_like(scope.fetch(op.input("X")))


@register("clip_by_norm")
def _clip_by_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    mn = op.attr("max_norm", 1.0)
    n = torch.sqrt(torch.sum(torch.square(x)))
    scope[op.output("Out")] = torch.where(n > mn, x * (mn / n), x)


@register("p_norm")
def _p_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    p = op.attr("porder", 2.0)
    axis = op.attr("axis", -1)
    keep = op.attr("keepdim", False)
    eps = op.attr("epsilon", 1e-12)
    if op.attr("asvector", False):
        x = x.reshape(-1)
        axis = 0
    ax = torch.abs(x)
    if p == float("inf"):
        out = ax.amax(dim=axis, keepdim=keep)
    elif p == float("-inf"):
        out = ax.amin(dim=axis, keepdim=keep)
    elif p == 0:
        out = (ax > 0).sum(dim=axis, keepdim=keep).to(x.dtype)
    else:
        out = (torch.sum(ax ** p, dim=axis, keepdim=keep)
               + eps) ** (1.0 / p)
    scope[op.output("Out")] = out


@register("norm")
def _norm_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    axis = op.attr("axis", -1)
    eps = op.attr("epsilon", 1e-10)
    n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True) + eps)
    scope[op.output("Out")] = x / n
    if op.output("Norm"):
        scope[op.output("Norm")] = n


@register("sigmoid_cross_entropy_with_logits")
def _sce_logits(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    label = scope.fetch(op.input("Label")).to(x.dtype)
    loss = torch.clamp_min(x, 0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    ignore = op.attr("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if op.attr("normalize", False):
        denom = torch.clamp_min((label != ignore).sum(), 1)
        loss = loss / denom
    scope[op.output("Out")] = loss


@register("cross_entropy", "cross_entropy2")
def _cross_entropy_op(op, scope, feeds, fetches):
    # input X holds PROBABILITIES (softmax output) in the reference op
    x = scope.fetch(op.input("X"))
    label = scope.fetch(op.input("Label"))
    if op.attr("soft_label", False):
        loss = -(label * torch.log(torch.clamp_min(x, 1e-12))).sum(
            -1, keepdim=True)
    else:
        ignore = op.attr("ignore_index", -100)
        c = x.shape[-1]
        lead = tuple(x.shape[:-1])
        xf = x.reshape(-1, c)
        lab = label.reshape(-1).long()
        picked = torch.gather(xf, -1, torch.clamp(lab, 0, c - 1)[:, None])
        loss = -torch.log(torch.clamp_min(picked, 1e-12))
        loss = torch.where(lab[:, None] == ignore, torch.zeros_like(loss),
                           loss)
        loss = loss.reshape(lead + (1,))
    scope[op.output("Y") or op.output("Out")] = loss


# ---------------------------------------------------------------------------
# NN layers (delegate to paddle_tpu_torch functional for exact semantics)
# ---------------------------------------------------------------------------
@register("conv2d", "depthwise_conv2d")
def _conv2d(op, scope, feeds, fetches):
    from ..nn import functional as F

    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("Filter"))
    groups = op.attr("groups", 1)
    if op.type == "depthwise_conv2d" and groups in (0, 1):
        groups = x.shape[1]
    pad = op.attr("paddings", [0, 0])
    algo = op.attr("padding_algorithm", "EXPLICIT")
    if algo in ("SAME", "VALID"):
        pad = algo
    scope[op.output("Output")] = F.conv2d(
        x, w, None, stride=op.attr("strides", [1, 1]), padding=pad,
        dilation=op.attr("dilations", [1, 1]), groups=max(groups, 1))


@register("conv2d_transpose")
def _conv2d_transpose(op, scope, feeds, fetches):
    from ..nn import functional as F

    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("Filter"))
    scope[op.output("Output")] = F.conv2d_transpose(
        x, w, None, stride=op.attr("strides", [1, 1]),
        padding=op.attr("paddings", [0, 0]),
        dilation=op.attr("dilations", [1, 1]),
        groups=max(op.attr("groups", 1), 1))


@register("batch_norm", "sync_batch_norm")
def _batch_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    mean = scope.fetch(op.input("Mean"))
    var = scope.fetch(op.input("Variance"))
    scale = scope.fetch(op.input("Scale"))
    bias = scope.fetch(op.input("Bias"))
    eps = op.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var + eps)
    scope[op.output("Y")] = (x - mean.reshape(shape)) * \
        (inv * scale).reshape(shape) + bias.reshape(shape)


@register("layer_norm")
def _layer_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    begin = op.attr("begin_norm_axis", 1)
    eps = op.attr("epsilon", 1e-5)
    red = tuple(range(begin, x.ndim))
    mu = torch.mean(x, dim=red, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=red, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    s = op.input("Scale")
    b = op.input("Bias")
    norm_shape = tuple(x.shape[begin:])
    if s:
        out = out * scope.fetch(s).reshape(norm_shape)
    if b:
        out = out + scope.fetch(b).reshape(norm_shape)
    scope[op.output("Y")] = out


@register("pool2d")
def _pool2d(op, scope, feeds, fetches):
    from ..nn import functional as F

    x = scope.fetch(op.input("X"))
    ptype = op.attr("pooling_type", "max")
    ksize = op.attr("ksize", [1, 1])
    if op.attr("global_pooling", False) or op.attr("adaptive", False) and \
            list(ksize) == [1, 1]:
        out = torch.mean(x, dim=(2, 3), keepdim=True) if ptype == "avg" \
            else torch.amax(x, dim=(2, 3), keepdim=True)
        scope[op.output("Out")] = out
        return
    if op.attr("adaptive", False):
        out = F.adaptive_avg_pool2d(x, ksize) if ptype == "avg" \
            else F.adaptive_max_pool2d(x, ksize)
        scope[op.output("Out")] = out
        return
    kwargs = dict(kernel_size=ksize, stride=op.attr("strides", [1, 1]),
                  padding=op.attr("paddings", [0, 0]),
                  ceil_mode=op.attr("ceil_mode", False))
    if ptype == "avg":
        out = F.avg_pool2d(x, exclusive=op.attr("exclusive", True),
                           **kwargs)
    else:
        out = F.max_pool2d(x, **kwargs)
    scope[op.output("Out")] = out


@register("softmax")
def _softmax(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.softmax(_fl(x), dim=op.attr("axis", -1))


@register("log_softmax")
def _log_softmax(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.log_softmax(_fl(x),
                                                dim=op.attr("axis", -1))


@register("dropout")
def _dropout(op, scope, feeds, fetches):
    # inference: upscale_in_train => identity; downgrade => scale
    x = scope.fetch(op.input("X"))
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    p = op.attr("dropout_prob", 0.5)
    scope[op.output("Out")] = x if impl == "upscale_in_train" \
        else x * (1.0 - p)


@register("lookup_table", "lookup_table_v2")
def _lookup_table(op, scope, feeds, fetches):
    w = scope.fetch(op.input("W"))
    ids = scope.fetch(op.input("Ids"))
    if op.type == "lookup_table" and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = w[ids.long()]
    pad = op.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((ids == pad)[..., None], torch.zeros_like(out),
                          out)
    scope[op.output("Out")] = out


@register("softmax_with_cross_entropy")
def _softmax_ce(op, scope, feeds, fetches):
    logits = scope.fetch(op.input("Logits"))
    label = scope.fetch(op.input("Label"))
    logp = torch.log_softmax(_fl(logits), dim=-1)
    if op.attr("soft_label", False):
        loss = -(label * logp).sum(-1, keepdim=True)
    else:
        lab = label[..., 0] if label.shape[-1] == 1 else label
        loss = -torch.gather(logp, -1, lab.long()[..., None])
    scope[op.output("Softmax")] = torch.exp(logp)
    scope[op.output("Loss")] = loss


@register("accuracy")
def _accuracy(op, scope, feeds, fetches):
    pred_idx = scope.fetch(op.input("Indices"))
    label = scope.fetch(op.input("Label"))
    correct = (pred_idx[:, :1].long() == label.long()).any(dim=1)
    scope[op.output("Accuracy")] = correct.float().mean()
    if op.output("Correct"):
        scope[op.output("Correct")] = correct.sum().to(torch.int32)
    if op.output("Total"):
        scope[op.output("Total")] = torch.tensor(
            label.shape[0], dtype=torch.int32, device=_dev())


# jax.image.resize, exactly: separable weight matrices with half-pixel
# centres, the triangle (linear) or Keys a=-0.5 (cubic) kernel, widened
# by the scale when shrinking (antialias), rows renormalised; nearest
# picks floor((i + 0.5) * in / out)
def _resize_kernel(method, x):
    x = torch.abs(x)
    if method == "linear":
        return torch.clamp_min(1 - x, 0)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _resize_weights(n_in, n_out, method, device):
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kscale
    w = _resize_kernel(method, dist)
    tot = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(
        np.finfo(np.float32).eps), w / torch.where(tot != 0, tot, 1.0),
        torch.zeros_like(w))
    ok = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(ok[None, :], w, torch.zeros_like(w))  # [in, out]


def jax_resize(x, shape, method):
    """``jax.image.resize(x, shape, method)`` over torch ("nearest",
    "linear"/"bilinear"/"trilinear", "cubic"/"bicubic")."""
    method = {"bilinear": "linear", "trilinear": "linear",
              "bicubic": "cubic"}.get(method, method)
    out = x
    for d in range(x.ndim):
        n_in, n_out = int(x.shape[d]), int(shape[d])
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * n_in / n_out).long()
            out = out.index_select(d, idx)
            continue
        w = _resize_weights(n_in, n_out, method, x.device)
        moved = _fl(out).movedim(d, -1)
        out = (moved @ w.to(moved.dtype)).movedim(-1, d)
    return out


@register("nearest_interp", "nearest_interp_v2", "bilinear_interp",
          "bilinear_interp_v2")
def _interp(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    out_h = op.attr("out_h", -1)
    out_w = op.attr("out_w", -1)
    scale = op.attr("scale", [])
    if out_h <= 0 or out_w <= 0:
        if isinstance(scale, (int, float)):
            scale = [scale, scale]
        out_h = int(x.shape[2] * scale[0])
        out_w = int(x.shape[3] * scale[1])
    method = "nearest" if op.type.startswith("nearest") else "linear"
    out = jax_resize(x, tuple(x.shape[:2]) + (out_h, out_w), method)
    scope[op.output("Out")] = out.to(x.dtype)


def np_pad(x, cfg, mode="constant", value=0.0):
    """``jnp.pad(x, cfg, mode)``: ``cfg`` one (lo, hi) a dim; modes
    constant, reflect, edge."""
    flat = []
    for lo, hi in reversed(list(cfg)):
        flat += [int(lo), int(hi)]
    if mode == "constant":
        return TF.pad(x, flat, value=value)
    tmode = {"reflect": "reflect", "edge": "replicate"}[mode]
    # torch pads the trailing 1-3 dims of a batched input: trim the
    # leading all-zero pairs
    lead = 0
    while lead < len(cfg) and tuple(cfg[lead]) == (0, 0):
        lead += 1
    nd = x.ndim - lead
    y = x.reshape((-1,) + tuple(x.shape[lead:])) if lead else x[None]
    if not y.is_floating_point():
        y = y.float()
        out = TF.pad(y, flat[:2 * nd], mode=tmode).to(x.dtype)
    else:
        out = TF.pad(y, flat[:2 * nd], mode=tmode)
    return out.reshape(tuple(x.shape[:lead]) + tuple(out.shape[1:])) \
        if lead else out[0]


@register("pad2d", "pad3d")
def _pad(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    pads = op.attr("paddings", [])
    mode = op.attr("mode", "constant")
    value = op.attr("pad_value", op.attr("value", 0.0))
    if op.type == "pad2d":
        cfg = [(0, 0), (0, 0), (pads[0], pads[1]), (pads[2], pads[3])]
    else:
        cfg = [(0, 0), (0, 0), (pads[4], pads[5]), (pads[2], pads[3]),
               (pads[0], pads[1])]
    if mode == "constant":
        out = np_pad(x, cfg, "constant", value)
    else:
        out = np_pad(x, cfg, {"reflect": "reflect", "edge": "edge",
                              "replicate": "edge"}[mode])
    scope[op.output("Out")] = out


@register("pixel_shuffle")
def _pixel_shuffle(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    r = op.attr("upscale_factor", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w)
    scope[op.output("Out")] = out.permute(0, 1, 4, 2, 5, 3).reshape(
        n, c // (r * r), h * r, w * r)


def _generator(seed):
    g = torch.Generator(device=_dev())
    g.manual_seed(int(seed or 0))
    return g


@register("uniform_random")
def _uniform_random(op, scope, feeds, fetches):
    shape = [int(s) for s in op.attr("shape", [])]
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = torch.rand(shape, generator=_generator(op.attr("seed", 0)),
                   device=_dev())
    scope[op.output("Out")] = (lo + (hi - lo) * u).to(
        _dt(op.attr("dtype", 5)))


@register("gaussian_random")
def _gaussian_random(op, scope, feeds, fetches):
    shape = [int(s) for s in op.attr("shape", [])]
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * torch.randn(
        shape, generator=_generator(op.attr("seed", 0)), device=_dev())
    scope[op.output("Out")] = out.to(_dt(op.attr("dtype", 5)))


@register("range")
def _range(op, scope, feeds, fetches):
    vals = [float(_host_read(scope.fetch(op.input(n)), "range bounds")
                  .reshape(()))
            for n in ("Start", "End", "Step")]
    scope[op.output("Out")] = torch.arange(*vals, dtype=torch.float32,
                                           device=_dev())


@register("cumsum")
def _cumsum(op, scope, feeds, fetches):
    """reference `operators/cum_op.cc`: flatten/exclusive/reverse."""
    x = scope.fetch(op.input("X"))
    axis = op.attr("axis", -1)
    if op.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    if op.attr("reverse", False):
        x = torch.flip(x, [axis])
    out = torch.cumsum(x, dim=axis)
    if x.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8,
                   torch.bool):
        out = out.to(torch.int32)  # jnp keeps 32-bit integer sums
    if op.attr("exclusive", False):
        out = out - x
    if op.attr("reverse", False):
        out = torch.flip(out, [axis])
    scope[op.output("Out")] = out


# ---------------------------------------------------------------------------
# optimizer ops (reference operators/optimizers/) — run in-program, so
# Executor.run on a program holding one updates its persistables
# ---------------------------------------------------------------------------
@register("sgd")
def _sgd(op, scope, feeds, fetches):
    p = scope.fetch(op.input("Param"))
    g = scope.fetch(op.input("Grad"))
    lr = scope.fetch(op.input("LearningRate")).reshape(())
    scope[op.output("ParamOut")] = p - lr * g


@register("momentum")
def _momentum_op(op, scope, feeds, fetches):
    p = scope.fetch(op.input("Param"))
    g = scope.fetch(op.input("Grad"))
    lr = scope.fetch(op.input("LearningRate")).reshape(())
    v = scope.get(op.input("Velocity"))
    if v is None:
        v = torch.zeros_like(p)
    mu = op.attr("mu", 0.9)
    v_new = mu * v + g
    if op.attr("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    scope[op.output("ParamOut")] = p_new
    scope[op.output("VelocityOut")] = v_new


@register("group_norm")
def _group_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    groups = op.attr("groups", 1)
    eps = op.attr("epsilon", 1e-5)
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1)
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)
    out = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.ndim - 2)
    if op.input("Scale"):
        out = out * scope.fetch(op.input("Scale")).reshape(cshape)
    if op.input("Bias"):
        out = out + scope.fetch(op.input("Bias")).reshape(cshape)
    scope[op.output("Y")] = out


@register("instance_norm")
def _instance_norm(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    eps = op.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mu = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    cshape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    if op.input("Scale"):
        out = out * scope.fetch(op.input("Scale")).reshape(cshape)
    if op.input("Bias"):
        out = out + scope.fetch(op.input("Bias")).reshape(cshape)
    scope[op.output("Y")] = out


@register("grid_sampler")
def _grid_sampler(op, scope, feeds, fetches):
    from ..nn.functional.common import grid_sample

    scope[op.output("Output")] = grid_sample(
        scope.fetch(op.input("X")), scope.fetch(op.input("Grid")),
        mode=op.attr("mode", "bilinear"),
        padding_mode=op.attr("padding_mode", "zeros"),
        align_corners=op.attr("align_corners", True))


@register("roi_align")
def _roi_align_op(op, scope, feeds, fetches):
    from ..vision.ops import roi_align

    rois = scope.fetch(op.input("ROIs"))
    if op.input("RoisNum"):
        num = scope.fetch(op.input("RoisNum"))
    else:
        if scope.fetch(op.input("X")).shape[0] != 1:
            raise NotImplementedError(
                "roi_align without RoisNum needs batch size 1 "
                "(LoD-carried ROI counts are not representable here)")
        num = torch.tensor([rois.shape[0]], dtype=torch.int32,
                           device=_dev())
    scope[op.output("Out")] = roi_align(
        scope.fetch(op.input("X")), rois, num,
        (op.attr("pooled_height", 1), op.attr("pooled_width", 1)),
        spatial_scale=op.attr("spatial_scale", 1.0),
        sampling_ratio=op.attr("sampling_ratio", -1),
        aligned=op.attr("aligned", True))


@register("box_coder")
def _box_coder_op(op, scope, feeds, fetches):
    from ..vision.ops import box_coder

    scope[op.output("OutputBox")] = box_coder(
        scope.fetch(op.input("PriorBox")),
        scope.fetch(op.input("PriorBoxVar"))
        if op.input("PriorBoxVar") else None,
        scope.fetch(op.input("TargetBox")),
        code_type=op.attr("code_type", "encode_center_size"),
        box_normalized=op.attr("box_normalized", True),
        axis=op.attr("axis", 0))


@register("prior_box")
def _prior_box_op(op, scope, feeds, fetches):
    from ..vision.ops import prior_box

    boxes, var = prior_box(
        scope.fetch(op.input("Input")), scope.fetch(op.input("Image")),
        min_sizes=op.attr("min_sizes", []),
        max_sizes=op.attr("max_sizes", []) or None,
        aspect_ratios=op.attr("aspect_ratios", [1.0]),
        variance=op.attr("variances", [0.1, 0.1, 0.2, 0.2]),
        flip=op.attr("flip", False), clip=op.attr("clip", False),
        steps=(op.attr("step_w", 0.0), op.attr("step_h", 0.0)),
        offset=op.attr("offset", 0.5),
        min_max_aspect_ratios_order=op.attr("min_max_aspect_ratios_order",
                                            False))
    scope[op.output("Boxes")] = boxes
    scope[op.output("Variances")] = var


@register("yolo_box")
def _yolo_box_op(op, scope, feeds, fetches):
    from ..vision.ops import yolo_box

    if op.attr("iou_aware", False):
        raise NotImplementedError(
            "yolo_box iou_aware=True (PP-YOLO layout) is not translated")
    boxes, scores = yolo_box(
        scope.fetch(op.input("X")), scope.fetch(op.input("ImgSize")),
        anchors=op.attr("anchors", []), class_num=op.attr("class_num", 1),
        conf_thresh=op.attr("conf_thresh", 0.01),
        downsample_ratio=op.attr("downsample_ratio", 32),
        clip_bbox=op.attr("clip_bbox", True),
        scale_x_y=op.attr("scale_x_y", 1.0))
    scope[op.output("Boxes")] = boxes
    scope[op.output("Scores")] = scores


@register("multiclass_nms", "multiclass_nms2", "multiclass_nms3")
def _multiclass_nms_op(op, scope, feeds, fetches):
    from ..vision.detection import multiclass_nms2

    if op.input("RoisNum"):
        raise NotImplementedError(
            "multiclass_nms with LoD-batched RoisNum input is not "
            "supported; export with dense [N, M, 4] boxes")
    want_index = bool(op.output("Index"))
    res = multiclass_nms2(
        scope.fetch(op.input("BBoxes")), scope.fetch(op.input("Scores")),
        op.attr("score_threshold", 0.05), op.attr("nms_top_k", 1000),
        op.attr("keep_top_k", 100),
        nms_threshold=op.attr("nms_threshold", 0.3),
        normalized=op.attr("normalized", True),
        nms_eta=op.attr("nms_eta", 1.0),
        background_label=op.attr("background_label", 0),
        return_index=want_index)
    if want_index:
        out, counts, index = res
        scope[op.output("Index")] = index
    else:
        out, counts = res
    scope[op.output("Out")] = out
    if op.output("NmsRoisNum"):
        scope[op.output("NmsRoisNum")] = counts


# ---------------------------------------------------------------------------
# Control flow: while / conditional_block / TensorArray family / recurrent /
# lstm / gru / beam search.
#
# Reference: `operators/controlflow/while_op.cc:59`,
# `conditional_block_op.cc:29`, `tensor_array_read_write_op.cc`,
# `tensor_array_to_tensor_op.cc`, `recurrent_op.cc`, `lstm_op.cc`,
# `gru_op.cc`, `beam_search_op.cc`, `beam_search_decode_op.cc:123`.
#
# The JAX package keeps static shapes for XLA; the port keeps its
# observable semantics eagerly:
#  * `while` loops on the host; the carry is the set of outer vars the
#    body writes (the step-scope write-back);
#  * TensorArray -> a fixed-capacity [cap, ...] buffer + length, the
#    capacity inferred from the loop bound or
#    FLAGS_interp_tensor_array_capacity, as in the JAX package;
#  * `recurrent`/`lstm`/`gru` -> a Python loop over the time axis;
#  * beam search -> fixed beam width K, finished-beam masking, parent
#    pointers in an explicit "ParentIdx" TensorArray.
# ---------------------------------------------------------------------------
class TensorArrayVal:
    """Static-capacity stand-in for the reference LoDTensorArray: a
    [capacity, *elem] buffer plus a host integer length.  ``buffer`` is
    None until the first write (a `while` pre-creates the arrays its
    body writes with the loop's capacity)."""

    def __init__(self, buffer, length, capacity=None):
        self.buffer = buffer
        self.length = int(length)
        self.capacity = capacity if buffer is None else buffer.shape[0]

    def __repr__(self):
        shape = None if self.buffer is None else tuple(self.buffer.shape)
        return f"TensorArrayVal({shape}, len={self.length})"


_TA_CREATE_CAP_TLS = threading.local()


def _const_index(op, slot="I"):
    c = _consts().get(op.input(slot))
    return None if c is None else int(np.asarray(c).reshape(-1)[0])


def _index_of(op, scope, slot="I"):
    """The array index: the desc-level constant when the program defines
    it by attrs, else the tensor's value read on the host."""
    i = _const_index(op, slot)
    if i is not None:
        return i
    t = _host_read(scope.fetch(op.input(slot)), "a TensorArray index")
    return int(t.reshape(()))


@register("write_to_array")
def _write_to_array(op, scope, feeds, fetches):
    x = _tensor(scope.fetch(op.input("X")))
    i_const = _const_index(op)
    i = _index_of(op, scope)
    name = op.output("Out")
    arr = scope.get(name)
    if not isinstance(arr, TensorArrayVal):
        if i_const is not None:
            cap = i_const + 1
        else:
            cap = getattr(_TA_CREATE_CAP_TLS, "cap", None)
            if cap is None:
                raise NotImplementedError(
                    f"write_to_array into {name!r} at a dynamic index but "
                    "the array was not pre-created; writes inside `while` "
                    "require the loop bound to be inferable (a "
                    "less_than/less_equal feeding Condition with a "
                    "statically-known bound) or "
                    "FLAGS_interp_tensor_array_capacity set")
        arr = TensorArrayVal(None, 0, cap)
    if arr.buffer is None:
        arr = TensorArrayVal(
            torch.zeros((arr.capacity,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device), arr.length)
    buf = arr.buffer
    if tuple(x.shape) != tuple(buf.shape[1:]):
        raise ValueError(
            f"write_to_array {name!r}: element shape {tuple(x.shape)} != "
            f"array element shape {tuple(buf.shape[1:])} (static-shape "
            "arrays require uniform elements)")
    if i_const is not None and i_const >= buf.shape[0]:
        grow = i_const + 1 - buf.shape[0]
        buf = torch.cat([buf, torch.zeros((grow,) + tuple(x.shape),
                                          dtype=buf.dtype,
                                          device=buf.device)])
    if not 0 <= i < buf.shape[0]:
        i = min(max(i, 0), buf.shape[0] - 1)  # lax clamps the index
    buf = buf.clone()
    buf[i] = x.to(buf.dtype)
    scope[name] = TensorArrayVal(buf, max(arr.length, i + 1))


@register("read_from_array")
def _read_from_array(op, scope, feeds, fetches):
    arr = scope.fetch(op.input("X"))
    if not isinstance(arr, TensorArrayVal):
        raise TypeError(f"read_from_array: {op.input('X')!r} is not a "
                        "TensorArray")
    i = _index_of(op, scope)
    i = min(max(i, 0), arr.buffer.shape[0] - 1)
    scope[op.output("Out")] = arr.buffer[i]


@register("lod_array_length")
def _lod_array_length(op, scope, feeds, fetches):
    arr = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.tensor([arr.length], dtype=torch.int64,
                                           device=_dev())


@register("tensor_array_to_tensor")
def _tensor_array_to_tensor(op, scope, feeds, fetches):
    """Stack/concat the array's written prefix ([length, ...])."""
    arr = scope.fetch(op.input("X"))
    axis = op.attr("axis", 0)
    buf, n = arr.buffer, arr.length
    buf = buf[:n]
    elems = buf.shape[0]
    if op.attr("use_stack", False):
        out = buf.movedim(0, axis) if axis else buf
    elif elems:
        out = torch.cat([buf[i] for i in range(elems)], dim=axis)
    else:
        shape = list(buf.shape[1:])
        shape[axis if axis >= 0 else axis + len(shape)] = 0
        out = torch.zeros(shape, dtype=buf.dtype, device=buf.device)
    scope[op.output("Out")] = out
    if op.output("OutIndex"):
        scope[op.output("OutIndex")] = torch.tensor(
            [n], dtype=torch.int32, device=_dev())


@register("increment")
def _increment(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    step = op.attr("step", 1.0)
    scope[op.output("Out")] = x + (step if x.is_floating_point()
                                   else int(step))


@register("is_empty")
def _is_empty(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.tensor([x.numel() == 0], device=_dev())


@register("select_input")
def _select_input(op, scope, feeds, fetches):
    """reference `operators/select_input_op.cc`: Out = X[Mask] (the mask
    clipped into range, as lax.switch), chosen on the device."""
    xs = [scope.fetch(n) for n in op.inputs("X")]
    mask = scope.fetch(op.input("Mask")).reshape(()).long()
    mask = torch.clamp(mask, 0, len(xs) - 1)
    scope[op.output("Out")] = torch.stack(xs)[mask]


@register("select_output")
def _select_output(op, scope, feeds, fetches):
    """reference `operators/select_output_op.cc` routes X to Out[Mask];
    as in the JAX package, X is written to every listed output — only
    the branch later chosen by `select_input` reaches the outputs."""
    x = scope.fetch(op.input("X"))
    for n in op._out.get("Out", []):
        scope[n] = x


def _sub_block_ops(op):
    return _current_blocks()[op.attr("sub_block", 0)]["ops"]


def _block_written_names(ops):
    out: List[str] = []
    seen = set()
    for raw in ops:
        for slot in raw.get("outputs", []):
            for a in slot.get("arguments", []):
                if a not in seen:
                    seen.add(a)
                    out.append(a)
    return out


def _pred(scope, name, what):
    v = _host_read(scope.fetch(name), what)
    return bool(v.reshape(()))


@register("conditional_block", "conditional_block_infer")
def _conditional_block(op, scope, feeds, fetches):
    """reference `operators/controlflow/conditional_block_op.cc:29`, run
    eagerly: the condition is read on the host and only the taken branch
    writes.  Out vars that don't pre-exist get zeros of the branch's
    shapes on the false path, as in the JAX package."""
    sub = _sub_block_ops(op)
    out_names = list(op._out.get("Out", []))

    def _run_sub():
        local = Scope(scope)
        run_block(sub, local, feeds, {})
        return tuple(_tensor(local.fetch(n)) for n in out_names)

    if not op.attr("is_scalar_condition", False):
        # the non-scalar mode gates on ALL Input tensors being non-empty
        if all(scope.fetch(n).numel() != 0 for n in op.inputs("Input")):
            for n, v in zip(out_names, _run_sub()):
                scope[n] = v
        return
    if _pred(scope, op.input("Cond"), "a conditional_block condition"):
        for n, v in zip(out_names, _run_sub()):
            scope[n] = v
        return
    missing = [n for n in out_names if n not in scope]
    if missing:
        shapes = dict(zip(out_names, _run_sub()))
        for n in missing:
            scope[n] = torch.zeros_like(shapes[n])


def _infer_trip_bound(op, scope, sub_ops):
    """Upper bound on while trip count, for TensorArray capacity: find a
    less_than/less_equal writing the Condition var and read its RHS from
    the desc-level constant map; else
    FLAGS_interp_tensor_array_capacity."""
    cond_name = op.input("Condition")
    for raw in sub_ops:
        v = OpView(raw)
        if v.type in ("less_than", "less_equal") and \
                v.output("Out") == cond_name:
            y = _consts().get(v.input("Y"))
            if y is not None:
                bound = int(np.asarray(y).reshape(-1)[0])
            else:
                bound = _consts_bounds().get(v.input("Y"))
            if bound is not None:
                return int(bound) + (1 if v.type == "less_equal" else 0)
    from ..core import flags as _flags

    cap = int(_flags.flag("interp_tensor_array_capacity"))
    return cap if cap > 0 else None


@register("while")
def _while(op, scope, feeds, fetches):
    """reference `operators/controlflow/while_op.cc:59`, run eagerly: the
    Condition var is read on the host before each step.  The carry is
    every outer-scope var the body writes (the reference's step-scope
    write-back); iteration-local temporaries are dropped after the
    loop, as the JAX package's lax.while_loop drops them."""
    sub = _sub_block_ops(op)
    cond_name = op.input("Condition")
    written = _block_written_names(sub)
    consts = _consts()
    for n in written:
        consts.pop(n, None)

    ta_targets = [OpView(r).output("Out") for r in sub
                  if r["type"] == "write_to_array"]
    missing_tas = [n for n in ta_targets
                   if not isinstance(scope.get(n), TensorArrayVal)]
    if missing_tas:
        bound = _infer_trip_bound(op, scope, sub)
        if bound is None:
            raise NotImplementedError(
                f"while: cannot infer a trip bound for TensorArray(s) "
                f"{missing_tas}; make the loop condition a "
                "less_than(i, bound) with a constant bound, or set "
                "FLAGS_interp_tensor_array_capacity")
        for n in missing_tas:
            scope[n] = TensorArrayVal(None, 0, bound)

    carry_names = [n for n in written if n in scope]
    if cond_name not in carry_names:
        raise ValueError(
            f"while: body never updates Condition var {cond_name!r} "
            "(infinite loop in the source program?)")
    dropped = [n for n in op._out.get("Out", [])
               if n not in carry_names and n != op.output("StepScopes")]
    if dropped:
        raise ValueError(
            f"while: Out var(s) {dropped} are written by the body but "
            "have no value before the loop; initialize them (e.g. "
            "fill_constant) so they can join the loop carry")
    carry = {n: dict.__getitem__(scope, n) for n in carry_names}
    while _pred(Scope(carry), cond_name, "a while condition"):
        local = Scope(scope)
        dict.update(local, carry)
        run_block(sub, local, feeds, {})
        carry = {n: local[n] for n in carry_names}
    for n, v in carry.items():
        scope[n] = v


@register("recurrent")
def _recurrent(op, scope, feeds, fetches):
    """reference `operators/recurrent_op.cc` (StaticRNN): time-major
    inputs sliced per step, ex_states <- previous states, outputs stacked
    by name — a Python loop over dim 0."""
    sub = _sub_block_ops(op)
    in_names = op.inputs("inputs")
    init_names = op.inputs("initial_states")
    out_names = op._out.get("outputs", [])
    ex_names = op.attr("ex_states", []) or []
    st_names = op.attr("states", []) or []
    reverse = bool(op.attr("reverse", False))
    has_states = bool(op.attr("has_states", bool(st_names)))

    xs = [_tensor(scope.fetch(n)) for n in in_names]
    carry = tuple(_tensor(scope.fetch(n)) for n in init_names)
    steps = range(xs[0].shape[0]) if xs else range(0)
    if reverse:
        steps = reversed(list(steps))
    ys = []
    for t in steps:
        local = Scope(scope)
        local.update(zip(in_names, (x[t] for x in xs)))
        if has_states:
            local.update(zip(ex_names, carry))
        run_block(sub, local, feeds, {})
        if has_states:
            carry = tuple(local.fetch(n) for n in st_names)
        ys.append(tuple(local.fetch(n) for n in out_names))
    if reverse:
        ys = ys[::-1]
    for j, n in enumerate(out_names):
        scope[n] = torch.stack([y[j] for y in ys])


def _rnn_act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": lambda x: torch.clamp_min(x, 0),
            "identity": lambda x: x}[name or "sigmoid"]


def _scan_time(step, carry, xs_tm, reverse=False):
    """lax.scan over the leading (time) axis: ``step(carry, x_t) ->
    (carry, y_t)``; returns the final carry and y stacked in time
    order."""
    order = range(xs_tm.shape[0])
    if reverse:
        order = reversed(list(order))
    ys = {}
    for t in order:
        carry, ys[t] = step(carry, xs_tm[t])
    return carry, [ys[t] for t in range(xs_tm.shape[0])]


@register("lstm")
def _lstm_op(op, scope, feeds, fetches):
    """reference `operators/lstm_op.cc`: Input is the pre-projected
    x·W_x [*, 4D] sequence; Weight = {W_ch, W_ih, W_fh, W_oh} [D, 4D]
    (gate order c, i, f, o), Bias [1, 4D] (+{W_ic, W_fc, W_oc} when
    use_peepholes).  Input is padded [B, T, 4D] (or a single [T, 4D]
    sequence)."""
    x = _tensor(scope.fetch(op.input("Input")))
    w = _tensor(scope.fetch(op.input("Weight")))
    d = w.shape[0]
    single = x.ndim == 2
    if single:
        x = x[None]
    b = x.shape[0]
    gates_b = torch.zeros((4 * d,), dtype=x.dtype, device=x.device)
    peep = op.attr("use_peepholes", True) and op.input("Bias")
    w_ic = w_fc = w_oc = None
    if op.input("Bias"):
        bias = _tensor(scope.fetch(op.input("Bias"))).reshape(-1)
        gates_b = bias[: 4 * d]
        if peep and bias.numel() >= 7 * d:
            w_ic = bias[4 * d:5 * d]
            w_fc = bias[5 * d:6 * d]
            w_oc = bias[6 * d:7 * d]
    h0 = _tensor(scope.fetch(op.input("H0"))) if op.input("H0") \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    c0 = _tensor(scope.fetch(op.input("C0"))) if op.input("C0") \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    actg = _rnn_act(op.attr("gate_activation", "sigmoid"))
    actc = _rnn_act(op.attr("cell_activation", "tanh"))
    actn = _rnn_act(op.attr("candidate_activation", "tanh"))

    def step(carry, xt):
        h, c = carry
        g = xt + h @ w + gates_b
        gc, gi, gf, go = torch.chunk(g, 4, dim=-1)
        if w_ic is not None:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = actg(gf) * c + actg(gi) * actc(gc)
        if w_oc is not None:
            go = go + c_new * w_oc
        h_new = actg(go) * actn(c_new)
        return (h_new, c_new), (h_new, c_new)

    _, ys = _scan_time(step, (h0, c0), x.movedim(1, 0),
                       reverse=bool(op.attr("is_reverse", False)))
    hidden = torch.stack([y[0] for y in ys], 1)
    cell = torch.stack([y[1] for y in ys], 1)
    if single:
        hidden, cell = hidden[0], cell[0]
    scope[op.output("Hidden")] = hidden
    if op.output("Cell"):
        scope[op.output("Cell")] = cell


@register("gru")
def _gru_op(op, scope, feeds, fetches):
    """reference `operators/gru_op.cc`: Input = pre-projected [*, 3D]
    (xu, xr, xc), Weight [D, 3D] = {W_u|W_r [D,2D], W_c [D,D]}.
    h_t = (1-u)h_{t-1} + u*h~ (origin_mode flips the blend)."""
    x = _tensor(scope.fetch(op.input("Input")))
    w = _tensor(scope.fetch(op.input("Weight")))
    d = w.shape[0]
    single = x.ndim == 2
    if single:
        x = x[None]
    b = x.shape[0]
    w_ur, w_c = w[:, : 2 * d], w[:, 2 * d:]
    bias = torch.zeros((3 * d,), dtype=x.dtype, device=x.device)
    if op.input("Bias"):
        bias = _tensor(scope.fetch(op.input("Bias"))).reshape(-1)
    h0 = _tensor(scope.fetch(op.input("H0"))) if op.input("H0") \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    actg = _rnn_act(op.attr("gate_activation", "sigmoid"))
    actn = _rnn_act(op.attr("activation", "tanh"))
    origin = bool(op.attr("origin_mode", False))

    def step(h, xt):
        xur = xt[:, : 2 * d] + h @ w_ur + bias[: 2 * d]
        u = actg(xur[:, :d])
        r = actg(xur[:, d:])
        cand = actn(xt[:, 2 * d:] + (r * h) @ w_c + bias[2 * d:])
        h_new = u * h + (1 - u) * cand if origin \
            else (1 - u) * h + u * cand
        return h_new, h_new

    _, hs = _scan_time(step, h0, x.movedim(1, 0),
                       reverse=bool(op.attr("is_reverse", False)))
    hidden = torch.stack(hs, 1)
    scope[op.output("Hidden")] = hidden[0] if single else hidden


@register("beam_search")
def _beam_search(op, scope, feeds, fetches):
    """reference `operators/beam_search_op.cc`, static-shape redesign:
    fixed beam width K per source; finished beams (pre_id == end_id)
    compete with their frozen score on the end_id column only.
    parent_idx is the global [B*K] source-beam index."""
    k = int(op.attr("beam_size", 4))
    end_id = int(op.attr("end_id", 1))
    is_acc = bool(op.attr("is_accumulated", True))
    pre_ids = scope.fetch(op.input("pre_ids")).reshape(-1)
    pre_scores = scope.fetch(op.input("pre_scores")).reshape(-1)
    scores = scope.fetch(op.input("scores"))
    bk, v = scores.shape
    bsz = bk // k
    acc = scores.float() if is_acc else pre_scores[:, None] + torch.log(
        torch.clamp_min(scores.float(), 1e-20))
    finished = pre_ids == end_id
    acc = torch.where(finished[:, None], torch.full_like(acc, -1e30), acc)
    acc = acc.clone()
    acc[:, end_id] = torch.where(finished, pre_scores.to(acc.dtype),
                                 acc[:, end_id])
    top_s, top_i = _top_k_last(acc.reshape(bsz, k * v), k)
    parent_local = torch.div(top_i, v, rounding_mode="floor")
    token = (top_i % v).to(pre_ids.dtype)
    parent = (torch.arange(bsz, dtype=torch.int32, device=acc.device)[
        :, None] * k + parent_local.to(torch.int32)).reshape(bk)
    scope[op.output("selected_ids")] = token.reshape(bk, 1)
    scope[op.output("selected_scores")] = top_s.reshape(bk, 1)
    if op.output("parent_idx"):
        scope[op.output("parent_idx")] = parent


@register("beam_search_decode")
def _beam_search_decode(op, scope, feeds, fetches):
    """reference `operators/beam_search_decode_op.cc:123`, backtracking
    the explicit ParentIdx TensorArray.  SentenceIds is [B, K, T_cap]
    end_id-padded; SentenceScores [B, K] is each surviving beam's final
    accumulated score."""
    end_id = int(op.attr("end_id", 1))
    k = int(op.attr("beam_size", 4))
    ids_ta = scope.fetch(op.input("Ids"))
    scores_ta = scope.fetch(op.input("Scores"))
    if not op.input("ParentIdx"):
        raise NotImplementedError(
            "beam_search_decode requires the ParentIdx TensorArray input "
            "in the static-shape redesign (LoD parent chains are not "
            "representable); wire the beam_search op's parent_idx output "
            "through a write_to_array")
    par_ta = scope.fetch(op.input("ParentIdx"))
    t_cap = ids_ta.buffer.shape[0]
    bk = int(np.prod(ids_ta.buffer.shape[1:]))
    bsz = bk // k
    ids = ids_ta.buffer.reshape(t_cap, bk)
    par = par_ta.buffer.reshape(t_cap, bk).long()
    length = ids_ta.length
    beam = torch.arange(bk, device=ids.device)
    toks = [None] * t_cap
    for t in reversed(range(t_cap)):
        if t < length:
            toks[t] = ids[t][beam]
            beam = par[t][beam]
        else:
            toks[t] = torch.full((bk,), end_id, dtype=ids.dtype,
                                 device=ids.device)
    sent = torch.stack(toks, 1).reshape(bsz, k, t_cap)
    last = min(max(length - 1, 0), t_cap - 1)
    final_scores = scores_ta.buffer.reshape(t_cap, bk)[last].reshape(bsz, k)
    scope[op.output("SentenceIds")] = sent
    scope[op.output("SentenceScores")] = final_scores


# ---------------------------------------------------------------------------
# LoD dynamic-RNN interchange family: lod_rank_table / lod_tensor_to_array
# / array_to_lod_tensor / shrink_rnn_memory / max_sequence_len /
# reorder_lod_tensor_by_rank / split_lod_tensor / merge_lod_tensor /
# lod_reset, on the padded+lengths representation (the `<name>@LOD`
# sidecar); the batch stays full-width and masked, as in the JAX package.
# ---------------------------------------------------------------------------
class RankTableVal:
    """LoDRankTable stand-in: sequence order sorted by decreasing length
    (stable) + the lengths, with the source's max time kept for
    while-loop TensorArray capacities."""

    def __init__(self, idx, lengths, t_max: int):
        self.idx = idx            # [B] int32, sorted by length desc
        self.lengths = lengths    # [B] int32, ORIGINAL order
        self.t_max = int(t_max)


def _lod_lengths(scope, name):
    key = name + "@LOD"
    if key not in scope:
        raise NotImplementedError(
            f"op needs sequence lengths for {name!r}: feed them via the "
            "Predictor input handle's set_lod() (padded+lengths LoD "
            "redesign) — the `<name>@LOD` sidecar is missing")
    return _tensor(scope[key]).reshape(-1).to(torch.int32)


@register("lod_rank_table")
def _lod_rank_table(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    lengths = _lod_lengths(scope, name)
    order = torch.sort(lengths, descending=True, stable=True)[1].to(
        torch.int32)
    t_max = int(x.shape[1]) if x.ndim >= 2 else int(lengths.shape[0])
    scope[op.output("Out")] = RankTableVal(order, lengths, t_max)


@register("max_sequence_len")
def _max_sequence_len(op, scope, feeds, fetches):
    rt = scope.fetch(op.input("RankTable"))
    out = op.output("Out")
    scope[out] = torch.amax(rt.lengths).reshape(1).to(torch.int64)
    _consts_bounds()[out] = rt.t_max


@register("lod_tensor_to_array")
def _lod_tensor_to_array(op, scope, feeds, fetches):
    """x [B, T, ...] -> TensorArray of T steps, each [B, ...] with rows
    reordered by the rank table (longest first, full-width)."""
    x = _tensor(scope.fetch(op.input("X")))
    rt = scope.fetch(op.input("RankTable"))
    buf = x[rt.idx.long()].movedim(1, 0)
    scope[op.output("Out")] = TensorArrayVal(buf, buf.shape[0])


@register("array_to_lod_tensor")
def _array_to_lod_tensor(op, scope, feeds, fetches):
    """TensorArray of per-step [B, ...] rows (rank order) -> padded
    [B, T, ...] in ORIGINAL order, zero past each sequence's length."""
    arr = scope.fetch(op.input("X"))
    rt = scope.fetch(op.input("RankTable"))
    stacked = arr.buffer.movedim(0, 1)
    idx = rt.idx.long()
    inv = torch.zeros_like(idx)
    inv[idx] = torch.arange(idx.shape[0], device=idx.device)
    out = stacked[inv]
    t = out.shape[1]
    mask = torch.arange(t, device=out.device)[None, :] < \
        rt.lengths[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (out.ndim - 2))
    name = op.output("Out")
    scope[name] = torch.where(mask, out, torch.zeros_like(out))
    scope[name + "@LOD"] = rt.lengths


@register("shrink_rnn_memory")
def _shrink_rnn_memory(op, scope, feeds, fetches):
    scope[op.output("Out")] = scope.fetch(op.input("X"))


@register("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(op, scope, feeds, fetches):
    x = _tensor(scope.fetch(op.input("X")))
    rt = scope.fetch(op.input("RankTable"))
    scope[op.output("Out")] = x[rt.idx.long()]


@register("split_lod_tensor")
def _split_lod_tensor(op, scope, feeds, fetches):
    x = _tensor(scope.fetch(op.input("X")))
    mask = scope.fetch(op.input("Mask")).reshape(-1)
    m = mask.bool().reshape((-1,) + (1,) * (x.ndim - 1))
    zero = torch.zeros_like(x)
    scope[op.output("OutTrue")] = torch.where(m, x, zero)
    scope[op.output("OutFalse")] = torch.where(m, zero, x)
    xkey = op.input("X") + "@LOD"
    if xkey in scope:
        scope[op.output("OutTrue") + "@LOD"] = scope[xkey]
        scope[op.output("OutFalse") + "@LOD"] = scope[xkey]


@register("merge_lod_tensor", "merge_lod_tensor_infer")
def _merge_lod_tensor(op, scope, feeds, fetches):
    t = _tensor(scope.fetch(op.input("InTrue")))
    f = _tensor(scope.fetch(op.input("InFalse")))
    mask = scope.fetch(op.input("Mask")).reshape(-1)
    m = mask.bool().reshape((-1,) + (1,) * (t.ndim - 1))
    scope[op.output("Out")] = torch.where(m, t, f)
    for side in ("InTrue", "InFalse"):
        key = op.input(side) + "@LOD"
        if key in scope:
            scope[op.output("Out") + "@LOD"] = scope[key]
            break


@register("lod_reset")
def _lod_reset(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    name = op.output("Out")
    scope[name] = x
    if op.input("Y"):
        ykey = op.input("Y") + "@LOD"
        if ykey in scope:
            scope[name + "@LOD"] = scope[ykey]
        else:
            # a plain int Y supplies the target OFFSETS as data
            yv = scope.fetch(op.input("Y")).reshape(-1)
            scope[name + "@LOD"] = torch.diff(yv).to(torch.int32)
    else:
        target = op.attr("target_lod", [])
        if target:
            off = np.asarray(target, np.int64)
            scope[name + "@LOD"] = _tensor(np.diff(off).astype(np.int32))


# ---------------------------------------------------------------------------
# Sequence-family translators (reference `operators/sequence_ops/`) on the
# padded+lengths representation: the time dim is X.shape[1], valid steps
# come from the `@LOD` sidecar (full length when absent).
# ---------------------------------------------------------------------------
def _seq_lengths_or_full(scope, name, x):
    key = name + "@LOD"
    if key in scope:
        return _tensor(scope[key]).reshape(-1).to(torch.int32)
    t = x.shape[1] if x.ndim >= 2 else 1
    return torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)


@register("sequence_pool")
def _sequence_pool_op(op, scope, feeds, fetches):
    from ..ops.sequence import sequence_pool

    name = op.input("X")
    x = scope.fetch(name)
    scope[op.output("Out")] = sequence_pool(
        x, _seq_lengths_or_full(scope, name, x),
        pool_type=str(op.attr("pooltype", "SUM")).lower())


@register("sequence_softmax")
def _sequence_softmax_op(op, scope, feeds, fetches):
    from ..ops.sequence import sequence_softmax

    name = op.input("X")
    x = scope.fetch(name)
    scope[op.output("Out")] = sequence_softmax(
        x, _seq_lengths_or_full(scope, name, x))


@register("sequence_reverse")
def _sequence_reverse_op(op, scope, feeds, fetches):
    from ..ops.sequence import sequence_reverse

    name = op.input("X")
    x = scope.fetch(name)
    scope[op.output("Y")] = sequence_reverse(
        x, _seq_lengths_or_full(scope, name, x))
    if name + "@LOD" in scope:
        scope[op.output("Y") + "@LOD"] = scope[name + "@LOD"]


@register("sequence_mask")
def _sequence_mask_op(op, scope, feeds, fetches):
    x = _tensor(scope.fetch(op.input("X")))
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or maxlen <= 0:
        c = _consts().get(op.input("X"))
        if c is None:
            raise NotImplementedError(
                "sequence_mask without a static maxlen attr needs "
                "statically-known lengths (as in the JAX package); set "
                "the maxlen attribute")
        maxlen = int(np.max(np.asarray(c)))
    mask = (torch.arange(int(maxlen), device=x.device)[None, :] <
            x.reshape(-1, 1)).to(_dt(op.attr("out_dtype", 3)))
    scope[op.output("Y")] = mask.reshape(tuple(x.shape) + (int(maxlen),))


@register("sequence_pad")
def _sequence_pad_op(op, scope, feeds, fetches):
    """X already arrives padded [B, T, ...]; the op re-pads to the attr
    maxlen (crop/extend) and emits Length."""
    name = op.input("X")
    x = _tensor(scope.fetch(name))
    lengths = _seq_lengths_or_full(scope, name, x)
    pad_value = 0.0
    if op.input("PadValue"):
        pad_value = scope.fetch(op.input("PadValue"))
    maxlen = op.attr("padded_length", -1)
    t = x.shape[1]
    if maxlen and maxlen > 0 and maxlen != t:
        if maxlen < t:
            x = x[:, :maxlen]
        else:
            x = np_pad(x, [(0, 0), (0, int(maxlen) - t)]
                       + [(0, 0)] * (x.ndim - 2))
        t = int(maxlen)
    lengths = torch.clamp_max(lengths, t)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))
    pv = _tensor(pad_value).to(x.dtype) if isinstance(
        pad_value, torch.Tensor) else torch.tensor(
        pad_value, dtype=x.dtype, device=x.device)
    scope[op.output("Out")] = torch.where(mask, x, pv)
    if op.output("Length"):
        scope[op.output("Length")] = lengths.to(torch.int64)


@register("one_hot", "one_hot_v2")
def _one_hot_op(op, scope, feeds, fetches):
    from ..ops.creation import one_hot

    x = _tensor(scope.fetch(op.input("X"))).to(torch.int32)
    if x.ndim and x.shape[-1] == 1 and op.type == "one_hot":
        x = x[..., 0]
    scope[op.output("Out")] = one_hot(x, int(op.attr("depth", 1)))


@register("gather_nd")
def _gather_nd_op(op, scope, feeds, fetches):
    from ..ops.manipulation import gather_nd

    scope[op.output("Out")] = gather_nd(scope.fetch(op.input("X")),
                                        scope.fetch(op.input("Index")))


@register("scatter")
def _scatter_op(op, scope, feeds, fetches):
    from ..ops.manipulation import scatter

    scope[op.output("Out")] = scatter(
        scope.fetch(op.input("X")), scope.fetch(op.input("Ids")),
        scope.fetch(op.input("Updates")),
        overwrite=bool(op.attr("overwrite", True)))


@register("argsort")
def _argsort_op(op, scope, feeds, fetches):
    x = _tensor(scope.fetch(op.input("X")))
    vals, idx = torch.sort(x, dim=op.attr("axis", -1), stable=True,
                           descending=bool(op.attr("descending", False)))
    scope[op.output("Indices")] = idx.to(torch.int64)
    scope[op.output("Out")] = vals


@register("rnn")
def _rnn_unified_op(op, scope, feeds, fetches):
    """The unified cudnn-style RNN op (`operators/rnn_op.cc`) that
    paddle-2.x `nn.LSTM/GRU/SimpleRNN` serialize to: Input [T, B, I]
    (time-major), WeightList flattened as [w_ih, w_hh per (layer, dir)
    ... then b_ih, b_hh per (layer, dir)], PreState = (h0[, c0]) each
    [L*D, B, H], optional SequenceLength [B].  Gate orders follow the
    python cells: LSTM i,f,g,o; GRU r,z,c with the reset gate applied
    AFTER the hidden matmul and h = (h_prev - c) * z + c.  With
    SequenceLength, states freeze and outputs zero past each row's
    length; the backward direction reverses within the valid region."""
    mode = op.attr("mode", "LSTM")
    nl = int(op.attr("num_layers", 1))
    bidirec = bool(op.attr("is_bidirec", False))
    nd = 2 if bidirec else 1
    if not op.attr("is_test", True) and op.attr("dropout_prob", 0.0):
        raise NotImplementedError(
            "rnn op: train-mode inter-layer dropout is not translated "
            "(inference interpreter); run with is_test=True or train "
            "through the eager nn.LSTM/GRU layers")

    x = _tensor(scope.fetch(op.input("Input")))  # [T, B, I]
    t_len, bsz = x.shape[0], x.shape[1]
    weights = [_tensor(scope.fetch(n)) for n in op.inputs("WeightList")]
    npairs = nl * nd
    w_ih = weights[0:2 * npairs:2]
    w_hh = weights[1:2 * npairs:2]
    has_bias = len(weights) >= 4 * npairs
    b_ih = weights[2 * npairs:4 * npairs:2] if has_bias else \
        [0.0] * npairs
    b_hh = weights[2 * npairs + 1:4 * npairs:2] if has_bias else \
        [0.0] * npairs
    pre = [_tensor(scope.fetch(n)) for n in op.inputs("PreState")]
    seq_len = None
    if op.input("SequenceLength"):
        seq_len = _tensor(scope.fetch(op.input("SequenceLength"))).reshape(
            -1).to(torch.int32)

    def cell_step(wi, wh, bi, bh, xt, h, c):
        gates_x = xt @ wi.T + bi
        gates_h = h @ wh.T + bh
        if mode == "LSTM":
            i_, f_, g_, o_ = torch.chunk(gates_x + gates_h, 4, dim=-1)
            c_new = torch.sigmoid(f_) * c + \
                torch.sigmoid(i_) * torch.tanh(g_)
            return torch.sigmoid(o_) * torch.tanh(c_new), c_new
        if mode == "GRU":
            x_r, x_z, x_c = torch.chunk(gates_x, 3, dim=-1)
            h_r, h_z, h_c = torch.chunk(gates_h, 3, dim=-1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            cand = torch.tanh(x_c + r * h_c)
            return (h - cand) * z + cand, c
        pre_act = gates_x + gates_h
        return (torch.tanh(pre_act) if mode == "RNN_TANH"
                else torch.clamp_min(pre_act, 0)), c

    rev_src = None
    if seq_len is not None and bidirec:
        tpos = torch.arange(t_len, device=x.device)[:, None]
        rev_src = torch.where(tpos < seq_len[None, :],
                              seq_len[None, :] - 1 - tpos, tpos).long()

    def rev(a):
        # reverse WITHIN each row's valid region (padding stays)
        if seq_len is None:
            return torch.flip(a, [0])
        return torch.gather(a, 0, rev_src[:, :, None].expand(
            t_len, bsz, a.shape[-1]))

    def run_dir(xs, pair, h, c, reverse):
        wi, wh, bi, bh = w_ih[pair], w_hh[pair], b_ih[pair], b_hh[pair]
        if reverse:
            xs = rev(xs)
        ys = []
        for t in range(t_len):
            h_new, c_new = cell_step(wi, wh, bi, bh, xs[t], h, c)
            if seq_len is not None:
                live = (t < seq_len)[:, None]
                h_new = torch.where(live, h_new, h)
                c_new = torch.where(live, c_new, c)
            h, c = h_new, c_new
            ys.append(h_new)
        ys = torch.stack(ys)
        if reverse:
            ys = rev(ys)
        return ys, h, c

    h0s = pre[0]
    c0s = pre[1] if mode == "LSTM" and len(pre) > 1 else \
        torch.zeros_like(pre[0])
    out = x
    fin_h, fin_c = [], []
    for layer in range(nl):
        ys_dirs = []
        for d in range(nd):
            pair = layer * nd + d
            ys, hT, cT = run_dir(out, pair, h0s[pair], c0s[pair],
                                 reverse=(d == 1))
            ys_dirs.append(ys)
            fin_h.append(hT)
            fin_c.append(cT)
        out = ys_dirs[0] if nd == 1 else torch.cat(ys_dirs, dim=-1)
    if seq_len is not None:
        live = torch.arange(t_len, device=x.device)[:, None] < \
            seq_len[None, :]
        out = torch.where(live[..., None], out, torch.zeros_like(out))
    scope[op.output("Out")] = out
    states = op._out.get("State", [])
    if states:
        scope[states[0]] = torch.stack(fin_h)
        if mode == "LSTM" and len(states) > 1:
            scope[states[1]] = torch.stack(fin_c)
    for aux in ("Reserve", "DropoutState"):
        if op.output(aux):
            scope[op.output(aux)] = torch.zeros((1,), dtype=torch.uint8,
                                                device=_dev())


# ---------------------------------------------------------------------------
# declarative OpDesc->eager bridge: registers translators for every
# remaining implemented eager op
# ---------------------------------------------------------------------------
from . import op_bridge  # noqa: E402,F401  (registers into OP_TRANSLATORS)
