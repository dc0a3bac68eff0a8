"""Declarative OpDesc -> eager bridge (counterpart:
paddle_tpu/static/op_bridge.py).

The reference executor runs ANY registered op out of a ProgramDesc
(`paddle/fluid/framework/executor.cc:166`).  As in the JAX package, each
entry here names the eager function (under paddle_tpu_torch/*) plus the
OpDesc input / attr / output parameter-name map, with the names taken
from the reference op makers; the generic runner fetches inputs from the
interp scope, converts attrs, calls the function and stores outputs.

Spec DSL
--------
``b("flip reverse", "P:flip", ins="X", attrs="axis")``

* names: space-separated op types sharing one spec
* target: "<mod>:<attr>" resolved lazily (P=paddle_tpu_torch,
  F=nn.functional, ops, seq=ops.sequence, vops=vision.ops,
  vdet=vision.detection, quant=quantization, metric) or a callable
  ``fn(*tensors, **attrs)``
* ins: tokens ``Name`` (required), ``?Name`` (optional -> None),
  ``*Name`` (variadic -> list of tensors)
* attrs: tokens ``name``, ``name->kw`` (rename), with optional ``@conv``
  converter (``dtype`` = VarType code -> torch dtype, ``ints`` = list of
  int).  An attr absent from the OpDesc is not passed, so the eager
  default applies.
* outs: tokens ``Name`` (required), ``?Name`` (skipped when the op desc
  doesn't declare it or the fn returned None), ``*Name`` (fn returns a
  sequence distributed over the output slot's argument list)

Random ops draw from a `torch.Generator` seeded from the op's seed attr
folded with a crc of its first output's name (so two random ops of one
program draw differently, as the JAX package's keys do); the numbers are
torch's, not JAX's.  Collective ops map ring ids onto
`torch.distributed` process groups inside `collective_axes(...)`; outside
it a program is world-size 1 (identity semantics), as in the JAX
package.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import threading
import zlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as TF

from .interp import (DYNAMIC_SHAPE_OPS, OP_TRANSLATORS, _dev, _dt, _fl,
                     _full, _host_read, _tensor, jax_resize, np_pad)

_MODS = {
    "P": "paddle_tpu_torch",
    "F": "paddle_tpu_torch.nn.functional",
    "ops": "paddle_tpu_torch.ops",
    "seq": "paddle_tpu_torch.ops.sequence",
    "vops": "paddle_tpu_torch.vision.ops",
    "vdet": "paddle_tpu_torch.vision.detection",
    "quant": "paddle_tpu_torch.quantization",
    "metric": "paddle_tpu_torch.metric",
    "nnu": "paddle_tpu_torch.nn.utils",
}


def _resolve(target: str) -> Callable:
    mod, _, attr = target.partition(":")
    fn = importlib.import_module(_MODS[mod])
    for part in attr.split("."):
        fn = getattr(fn, part)
    return fn


def _mod(key):
    return importlib.import_module(_MODS[key])


def _P():
    return _mod("P")


def _F():
    return _mod("F")


def _ops():
    return _mod("ops")


def _vops():
    return _mod("vops")


def _vdet():
    return _mod("vdet")


def _quant():
    return _mod("quant")


def _metric():
    return _mod("metric")


def _conv_dtype(v):
    return _dt(int(v))


_CONVS = {
    "dtype": _conv_dtype,
    "ints": lambda v: [int(x) for x in v],
    "int": int,
    "float": float,
    "bool": bool,
}


class _Spec:
    __slots__ = ("target", "ins", "attrs", "outs", "_fn")

    def __init__(self, target, ins, attrs, outs):
        self.target = target
        self.ins = [(t.lstrip("?*"), t[0] if t[0] in "?*" else "")
                    for t in ins.split()] if ins else []
        self.attrs = []
        for tok in (attrs.split() if attrs else []):
            name, _, conv = tok.partition("@")
            src, _, kw = name.partition("->")
            self.attrs.append((src, kw or src,
                               _CONVS[conv] if conv else None))
        self.outs = [(t.lstrip("?*"), t[0] if t[0] in "?*" else "")
                     for t in outs.split()] if outs else []
        self._fn = None

    def fn(self):
        if self._fn is None:
            self._fn = (self.target if callable(self.target)
                        else _resolve(self.target))
        return self._fn


def _run_spec(spec: _Spec, op, scope, feeds, fetches):
    args = []
    for name, mode in spec.ins:
        if mode == "*":
            args.append([scope.fetch(a) for a in op.inputs(name)])
        else:
            arg = op.input(name)
            if not arg:
                if mode == "?":
                    args.append(None)  # keep positional alignment
                    continue
                raise KeyError(
                    f"{op.type}: required input {name!r} missing")
            args.append(scope.fetch(arg))
    kw = {}
    for src, dst, conv in spec.attrs:
        if src in op._attrs:
            v = op._attrs[src]
            kw[dst] = conv(v) if conv else v
    out = spec.fn()(*args, **kw)
    _store_outs(spec, op, scope, out)


def _store_outs(spec, op, scope, out):
    if isinstance(out, (tuple, list)) and not (
            len(spec.outs) == 1 and spec.outs[0][1] != "*"):
        vals = list(out)
    else:
        if isinstance(out, (tuple, list)):
            if len(out) != 1:
                raise ValueError(
                    f"{op.type}: eager fn returned {len(out)} values "
                    f"but the spec declares one output slot "
                    f"{spec.outs[0][0]!r}; fix the spec's outs or "
                    "index the adapter's return")
            out = out[0]
        vals = [out]
    vi = 0
    for name, mode in spec.outs:
        slots = op.outputs(name)
        if mode == "*":
            seq = vals[vi] if len(spec.outs) > 1 else vals
            if len(seq) == 1 and isinstance(seq[0], (tuple, list)):
                seq = seq[0]
            for slot, v in zip(slots, seq):
                scope[slot] = v
            vi += 1
            continue
        if not slots:
            if mode == "?":
                vi += 1
                continue
            raise KeyError(f"{op.type}: output slot {name!r} undeclared")
        v = vals[vi] if vi < len(vals) else None
        vi += 1
        if v is None:
            if mode == "?":
                continue
            raise ValueError(f"{op.type}: no value for output {name!r}")
        scope[slots[0]] = v


BRIDGED: Dict[str, object] = {}


def b(names: str, target, ins="X", attrs="", outs="Out"):
    spec = _Spec(target, ins, attrs, outs)
    for n in names.split():
        if n in OP_TRANSLATORS:  # hand-written translators win
            continue
        BRIDGED[n] = spec

        def _t(op, scope, feeds, fetches, _s=spec):
            _run_spec(_s, op, scope, feeds, fetches)

        OP_TRANSLATORS[n] = _t


def braw(*names):
    """Register a raw translator (full op access) under the bridge's
    'hand over only if unclaimed' rule, and record it as bridged."""
    def deco(fn):
        for n in names:
            if n not in OP_TRANSLATORS:
                OP_TRANSLATORS[n] = fn
                BRIDGED[n] = fn
        return fn
    return deco


def _scalar(t, what="a scalar input"):
    return _host_read(t, what).reshape(()).item()


# ---------------------------------------------------------------------------
# tensor math / manipulation
# ---------------------------------------------------------------------------
def _py_slice_index(n, s, e, st):
    """Indices of python ``range(n)[s:e:st]`` (torch slicing takes no
    negative step)."""
    return list(range(*slice(s, e, st).indices(n)))


def _strided_slice(x, axes, starts, ends, strides, decrease_axis):
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = int(ax) % x.ndim
        n = x.shape[ax]
        s, e, st = int(s), int(e), int(st)
        # reference clamps INT_MAX/negative bounds (strided_slice_op.h)
        if s < 0:
            s += n
        if e < 0:
            e += n
        if st > 0:
            e = min(e, n)
        elif e < 0:
            e = None
        idx = _py_slice_index(n, s, e, st)
        out = out.index_select(ax, torch.tensor(idx, dtype=torch.long,
                                                device=x.device))
    if decrease_axis:
        drop = {int(a) for a in decrease_axis}
        out = out.reshape([d for i, d in enumerate(out.shape)
                           if i not in drop])
    return out


def _dynamic_slice(x, starts, sizes):
    """lax.dynamic_slice: starts clamped so the window fits."""
    idx = []
    for n, s, z in zip(x.shape, starts, sizes):
        s = min(max(int(s), 0), int(n) - int(z))
        idx.append(slice(s, s + int(z)))
    return x[tuple(idx)]


def _multiplex(inputs, ids):
    stacked = torch.stack(inputs)
    shape = (1, -1) + (1,) * (inputs[0].ndim - 1)
    idx = ids.reshape(shape).long().expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


b("flip", "P:flip", ins="X", attrs="axis")
b("reverse", "P:flip", ins="X", attrs="axis")  # reverse_op.cc: axis ints
b("roll", "P:roll", ins="X", attrs="shifts axis")
b("strided_slice", lambda x, axes=(), starts=(), ends=(), strides=(),
    decrease_axis=(), infer_flags=():
    _strided_slice(x, axes, starts, ends, strides, decrease_axis),
  ins="Input", attrs="axes starts ends strides decrease_axis infer_flags")
b("index_select", "P:index_select", ins="X Index", attrs="dim->axis")
b("index_sample", "P:index_sample", ins="X Index")
b("tril_triu", lambda x, diagonal=0, lower=True:
    (torch.tril if lower else torch.triu)(x, int(diagonal)),
  ins="X", attrs="diagonal lower")
b("unbind", "P:unbind", ins="X", attrs="axis", outs="*Out")
b("unstack", "P:unstack", ins="X", attrs="axis num", outs="*Y")
b("meshgrid", "P:meshgrid", ins="*X", outs="*Out")
b("expand", lambda x, expand_times=():
    x.tile(tuple(int(t) for t in expand_times)),
  ins="X", attrs="expand_times")
b("expand_as", lambda x, y: x.tile(
    tuple(t // s for t, s in zip(y.shape, x.shape))),
  ins="X target_tensor")  # fluid v1 expand_as tiles by integer multiples
b("expand_as_v2", lambda x, target_shape=():
    torch.broadcast_to(x, tuple(int(s) for s in target_shape)),
  ins="X", attrs="target_shape")
b("bmm", "P:bmm", ins="X Y")
b("mv", lambda x, vec: torch.matmul(x, vec), ins="X Vec")
b("dot", "P:dot", ins="X Y")
b("cross", "P:cross", ins="X Y", attrs="dim->axis")
b("kron", "P:kron", ins="X Y")
b("addmm", "P:addmm", ins="Input X Y", attrs="Alpha->alpha Beta->beta")
b("diag_v2", "P:diag", ins="X", attrs="offset padding_value")
b("diag_embed", "P:diag_embed", ins="Input",
  attrs="offset dim1 dim2")
b("diagonal", "P:diagonal", ins="Input", attrs="offset axis1 axis2")
b("trace", "P:trace", ins="Input", attrs="offset axis1 axis2")
b("inverse", "P:inverse", ins="Input", outs="Output")
b("cholesky", "P:cholesky", ins="X", attrs="upper")
b("histogram", "P:histogram", ins="X", attrs="bins min max")
b("masked_select", "P:masked_select", ins="X Mask", outs="Y")
b("multiplex", _multiplex, ins="*X Ids")
b("broadcast_tensors", "P:broadcast_tensors", ins="*X", outs="*Out")
b("allclose", "P:allclose", ins="Input Other",
  attrs="rtol@float atol@float equal_nan")
b("atan2", "P:atan2", ins="X1 X2")
b("digamma", "P:digamma")
b("lgamma", "P:lgamma")
b("expm1", lambda x: torch.expm1(_fl(x)))
b("trunc", "P:trunc", ins="X")
b("logsumexp", "P:logsumexp", ins="X", attrs="axis keepdim")
b("conj", "P:conj")
b("real", "P:real")
b("imag", "P:imag")


def _arg_min(x, axis=0, keepdims=False, dtype=3, flatten=False):
    if flatten:
        out = torch.argmin(x.reshape(-1))
    else:
        out = torch.argmin(x, dim=int(axis), keepdim=bool(keepdims))
    return out.to(_conv_dtype(dtype))


def _eye(num_rows=0, num_columns=-1, dtype=5):
    m = int(num_columns) if int(num_columns) >= 0 else int(num_rows)
    return torch.eye(int(num_rows), m, dtype=_conv_dtype(dtype),
                     device=_dev())


def _linspace(start, stop, num, dtype=5):
    n = int(_scalar(num, "linspace's count"))
    out = torch.linspace(float(_scalar(start)), float(_scalar(stop)), n,
                         dtype=torch.float64, device=_dev())
    return out.to(_conv_dtype(dtype))


b("arg_min", _arg_min, ins="X", attrs="axis keepdims dtype flatten")
b("dist", "P:dist", ins="X Y", attrs="p")
b("eye", _eye, ins="", attrs="num_rows num_columns dtype")
b("size", lambda x: torch.tensor(x.numel(), dtype=torch.int64,
                                 device=_dev()), ins="Input")
b("linspace", _linspace, ins="Start Stop Num", attrs="dtype")
b("crop", lambda x, offsets=(), shape=():
    _dynamic_slice(x, [int(o) for o in offsets], [int(s) for s in shape]),
  ins="X", attrs="offsets shape")
b("crop_tensor", lambda x, offsets=(), shape=(): _dynamic_slice(
    x, [int(o) for o in (offsets or [0] * x.ndim)],
    [x.shape[i] if int(s) == -1 else int(s)
     for i, s in enumerate(shape or x.shape)]),
  ins="X", attrs="offsets shape")
b("scatter_nd_add", "P:scatter_nd_add", ins="X Index Updates")
b("gather_tree", "ops:gather_tree", ins="Ids Parents")


def _seg_pool(x, seg, pooltype):
    return _ops().segment_pool(x, seg, pool_type=pooltype.lower())


b("segment_pool", lambda x, seg, pooltype="SUM":
    _seg_pool(x, seg, pooltype),
  ins="X SegmentIds", attrs="pooltype", outs="Out ?SummedIds")
b("where_index", lambda x: torch.nonzero(x).to(torch.int64),
  ins="Condition")
b("minus", lambda x, y: x - y, ins="X Y")
b("grad_add", lambda x, y: x + y, ins="X Y")
b("squared_l2_norm", lambda x: torch.sum(torch.square(x)).reshape(1))
b("l1_norm", lambda x: torch.sum(torch.abs(x)).reshape(1))
b("frobenius_norm", lambda x, dim=(), keep_dim=False, reduce_all=False:
    torch.sqrt(torch.sum(torch.square(x),
                         dim=tuple(range(x.ndim)) if reduce_all or not dim
                         else tuple(int(d) for d in dim),
                         keepdim=keep_dim)),
  ins="X", attrs="dim keep_dim reduce_all")
b("shard_index", "ops:shard_index", ins="X",
  attrs="index_num nshards shard_id ignore_value")


def _first_index(inverse, n_unique, along):
    """Index of each unique value's first occurrence (jnp.unique's
    return_index)."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n_unique,), along, dtype=torch.long,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1).long(), pos,
                                reduce="amin")


def _unique(x, dtype, return_index, return_inverse, return_counts, axis):
    axis = int(axis[0]) if axis else None
    if axis is None:
        out, inverse, counts = torch.unique(
            x.reshape(-1), sorted=True, return_inverse=True,
            return_counts=True)
        along = x.numel()
    else:
        out, inverse, counts = torch.unique(
            x, sorted=True, return_inverse=True, return_counts=True,
            dim=axis)
        along = x.shape[axis]
    idt = _conv_dtype(dtype)
    index = _first_index(inverse, out.shape[0] if axis is None
                         else out.shape[axis], along)
    return (out, index.to(idt) if return_index else None,
            inverse.reshape(-1).to(idt) if return_inverse else None,
            counts.to(idt) if return_counts else None)


def _unique_with_counts(x, dtype):
    out, inverse, counts = torch.unique(x.reshape(-1), sorted=True,
                                        return_inverse=True,
                                        return_counts=True)
    idt = _conv_dtype(dtype)
    return out, inverse.reshape(-1).to(idt), counts.to(idt)


def _bsl_shape(x, shape, in_idx, out_idx):
    shape = [int(s) for s in shape]
    shape[int(out_idx)] = x.shape[int(in_idx)]
    return shape


b("unique", lambda x, dtype=3, return_index=False, return_inverse=False,
    return_counts=False, axis=(), is_sorted=True:
    _unique(x, dtype, return_index, return_inverse, return_counts, axis),
  ins="X", attrs="dtype return_index return_inverse return_counts "
                 "axis is_sorted",
  outs="Out ?Indices ?Index ?Counts")
b("unique_with_counts", lambda x, dtype=2:
    _unique_with_counts(x, dtype),
  ins="X", attrs="dtype", outs="Out Index Count")
b("fill", lambda shape=(), value=0.0, dtype=5:
    _full(shape, value, _conv_dtype(dtype)),
  ins="", attrs="shape value dtype")
b("fill_constant_batch_size_like",
  lambda x, shape=(), value=0.0, dtype=5, input_dim_idx=0,
  output_dim_idx=0: _full(_bsl_shape(x, shape, input_dim_idx,
                                     output_dim_idx), value,
                          _conv_dtype(dtype)),
  ins="Input", attrs="shape value dtype input_dim_idx output_dim_idx")
b("empty", lambda shape=(), dtype=5:
    torch.zeros([int(s) for s in shape], dtype=_conv_dtype(dtype),
                device=_dev()),
  ins="", attrs="shape dtype")
b("seed", lambda seed=0: torch.tensor(seed or 0, dtype=torch.int32,
                                      device=_dev()),
  ins="", attrs="seed")


# random family: a generator seeded from the op's seed attr folded with a
# crc of its first output's name, so two random ops of one program draw
# different samples; same program + same seeds -> same draws
def _op_gen(op, seed=0):
    names = [a for args in op._out.values() for a in args]
    tag = names[0] if names else op.type
    g = torch.Generator(device=_dev())
    g.manual_seed((int(seed or 0) * 1000003 + zlib.crc32(tag.encode()))
                  % (2 ** 63))
    return g


@braw("bernoulli")
def _bernoulli(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scope[op.output("Out")] = torch.bernoulli(
        x.float(), generator=_op_gen(op)).to(x.dtype)


@braw("multinomial")
def _multinomial(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    k = int(op.attr("num_samples", 1))
    probs = x.float().reshape(-1, x.shape[-1])
    out = torch.multinomial(probs, k,
                            replacement=bool(op.attr("replacement", False)),
                            generator=_op_gen(op))
    scope[op.output("Out")] = out.reshape(tuple(x.shape[:-1]) + (k,)).to(
        torch.int64)


@braw("sampling_id")
def _sampling_id(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    probs = x.float().reshape(-1, x.shape[-1]) + 1e-30
    out = torch.multinomial(probs, 1, generator=_op_gen(
        op, op.attr("seed", 0)))[:, 0]
    scope[op.output("Out")] = out.reshape(x.shape[:-1]).to(torch.int64)


@braw("randint")
def _randint_op(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.randint(
        int(op.attr("low", 0)), int(op.attr("high", 1)),
        [int(s) for s in op.attr("shape", [])],
        generator=_op_gen(op, op.attr("seed", 0)), device=_dev()).to(
        _conv_dtype(op.attr("dtype", 3)))


@braw("randperm")
def _randperm_op(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.randperm(
        int(op.attr("n", 0)), generator=_op_gen(op, op.attr("seed", 0)),
        device=_dev()).to(_conv_dtype(op.attr("dtype", 3)))


@braw("gaussian_random_batch_size_like")
def _gauss_bsl_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    shape = _bsl_shape(x, op.attr("shape", []),
                       op.attr("input_dim_idx", 0),
                       op.attr("output_dim_idx", 0))
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * torch.randn(
        shape, generator=_op_gen(op, op.attr("seed", 0)), device=_dev())
    scope[op.output("Out")] = out.to(_conv_dtype(op.attr("dtype", 5)))


@braw("uniform_random_batch_size_like")
def _unif_bsl_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    shape = _bsl_shape(x, op.attr("shape", []),
                       op.attr("input_dim_idx", 0),
                       op.attr("output_dim_idx", 0))
    lo, hi = op.attr("min", -1.0), op.attr("max", 1.0)
    u = torch.rand(shape, generator=_op_gen(op, op.attr("seed", 0)),
                   device=_dev())
    scope[op.output("Out")] = (lo + (hi - lo) * u).to(
        _conv_dtype(op.attr("dtype", 5)))


@braw("truncated_gaussian_random")
def _trunc_gauss_op(op, scope, feeds, fetches):
    # N(0, 1) truncated to [-2, 2] by the inverse CDF
    shape = [int(s) for s in op.attr("shape", [])]
    lo = 0.5 * (1 + torch.erf(torch.tensor(-2.0 / 2 ** 0.5)))
    hi = 0.5 * (1 + torch.erf(torch.tensor(2.0 / 2 ** 0.5)))
    u = torch.rand(shape, generator=_op_gen(op, op.attr("seed", 0)),
                   device=_dev(), dtype=torch.float64)
    p = lo.item() + (hi.item() - lo.item()) * u
    z = (2 ** 0.5) * torch.erfinv(2 * p - 1)
    out = op.attr("mean", 0.0) + op.attr("std", 1.0) * z.clamp(-2, 2)
    scope[op.output("Out")] = out.to(_conv_dtype(op.attr("dtype", 5)))


# ---------------------------------------------------------------------------
# activations / nn functional (reference operators/activation_op.cc +
# individual op makers; loss ops are ELEMENTWISE in fluid)
# ---------------------------------------------------------------------------
def _label_smooth(x, prior, epsilon):
    if prior is not None:
        return (1 - epsilon) * x + epsilon * prior
    return (1 - epsilon) * x + epsilon / x.shape[-1]


def _modified_huber(x, y):
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z >= -1.0,
                       torch.square(torch.clamp_min(1.0 - z, 0.0)),
                       -4.0 * z)
    return loss, z


def _bpr_loss(x, label):
    # reference bpr_loss_op.h: -mean_{j != y} log(sigmoid(x_y - x_j))
    n, c = x.shape
    lab = label.reshape(-1).long()
    xy = torch.gather(x, 1, lab.reshape(-1, 1))
    diff = xy - x
    logsig = -torch.log1p(torch.exp(-diff))
    mask = torch.ones((n, c), dtype=x.dtype, device=x.device)
    mask[torch.arange(n, device=x.device), lab] = 0
    return -(logsig * mask).sum(1, keepdim=True) / (c - 1)


def _cos_sim(x, y):
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / (xn * yn)
    return out, xn, yn


def _fluid_smooth_l1(x, y, iw, ow, sigma):
    s2 = float(sigma) * float(sigma)
    diff = (x - y) * (iw if iw is not None else 1.0)
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / s2, 0.5 * s2 * torch.square(diff),
                      ad - 0.5 / s2)
    if ow is not None:
        val = val * ow
    red = tuple(range(1, x.ndim))
    return diff, torch.sum(val, dim=red).reshape(-1, 1)


def _fluid_sigmoid_focal(x, label, fg, gamma, alpha):
    # detection variant (operators/detection/sigmoid_focal_loss_op.cc)
    num_classes = x.shape[1]
    lab = label.reshape(-1).long()
    onehot = (lab[:, None] == torch.arange(1, num_classes + 1,
                                           device=x.device)[None, :])
    onehot = onehot.to(x.dtype)
    p = torch.sigmoid(x)
    ce = -(onehot * torch.log(torch.clamp_min(p, 1e-12))
           + (1 - onehot) * torch.log(torch.clamp_min(1 - p, 1e-12)))
    w = onehot * alpha * torch.pow(1 - p, gamma) + \
        (1 - onehot) * (1 - alpha) * torch.pow(p, gamma)
    out = ce * w
    if fg is not None:
        out = out / torch.clamp_min(fg.reshape(()).to(x.dtype), 1.0)
    return out


def _warpctc(logits, label, llen, lablen, blank, norm_by_times):
    if llen is None:
        llen = torch.full((logits.shape[1],), logits.shape[0],
                          dtype=torch.int64, device=logits.device)
    if lablen is None:
        lablen = torch.full((label.shape[0],), label.shape[1],
                            dtype=torch.int64, device=logits.device)
    loss = _F().ctc_loss(torch.log_softmax(logits, -1), label, llen,
                         lablen, blank=int(blank), reduction="none",
                         norm_by_times=norm_by_times)
    return loss.reshape(-1, 1)


def _edit_distance(hyps, refs, hl, rl, normalized):
    out = _ops().edit_distance(hyps, refs, normalized=normalized,
                               input_length=hl, label_length=rl)
    out = out[0] if isinstance(out, tuple) else out
    return out, torch.tensor([hyps.shape[0]], dtype=torch.int64,
                             device=hyps.device)


def _ctc_align(x, xlen, blank, merge_repeated, padding_value):
    out = _ops().ctc_align(x, blank=int(blank),
                           merge_repeated=merge_repeated,
                           padding_value=int(padding_value),
                           input_length=xlen)
    if isinstance(out, tuple):
        return out
    return out, None


def _multihead_matmul(inp, w, bias, bias_qk, alpha, heads):
    # fused QKV self-attention (operators/fused/multihead_matmul_op.cc)
    bsz, seq, hid = inp.shape
    if w.ndim == 3:
        w = torch.cat([w[0], w[1], w[2]], dim=-1)
    qkv = inp @ w.reshape(hid, -1)
    if bias is not None:
        qkv = qkv + bias.reshape(-1)
    q, k, v = torch.chunk(qkv, 3, dim=-1)

    def split_heads(t):
        return t.reshape(bsz, seq, heads, hid // heads).permute(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = (q @ k.transpose(-1, -2)) * alpha
    if bias_qk is not None:
        scores = scores + bias_qk
    out = torch.softmax(scores, -1) @ v
    return out.permute(0, 2, 1, 3).reshape(bsz, seq, hid)


def _im2sequence(x, kernels, strides, paddings):
    cols = _F().unfold(x, [int(k) for k in kernels],
                       strides=[int(s) for s in strides],
                       paddings=[int(p) for p in paddings[:2]])
    n, ck, L = cols.shape
    return cols.permute(0, 2, 1).reshape(n * L, ck)


def _bilinear_tp(x, y, w, bias):
    out = torch.einsum("ni,kij,nj->nk", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out


b("elu", "F:elu", ins="X", attrs="alpha")
b("selu", "F:selu", ins="X", attrs="scale alpha")
b("maxout", "F:maxout", ins="X", attrs="groups axis")
b("label_smooth", lambda x, prior=None, epsilon=0.1: _label_smooth(
    x, prior, epsilon), ins="X ?PriorDist", attrs="epsilon")
b("log_loss", lambda p, y, epsilon=1e-4:
    -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon),
  ins="Predicted Labels", attrs="epsilon", outs="Loss")
b("bce_loss", lambda x, y: -(y * torch.log(torch.clamp_min(x, 1e-12))
                             + (1 - y) * torch.log(
                                 torch.clamp_min(1 - x, 1e-12))),
  ins="X Label")
b("huber_loss", lambda x, y, delta=1.0: (
    y - x,
    torch.where(torch.abs(y - x) <= delta, 0.5 * torch.square(y - x),
                delta * (torch.abs(y - x) - 0.5 * delta))),
  ins="X Y", attrs="delta", outs="?Residual Out")
b("margin_rank_loss", lambda x1, x2, label, margin=0.0: (
    (margin - label * (x1 - x2)) > 0,
    torch.clamp_min(margin - label * (x1 - x2), 0.0)),
  ins="X1 X2 Label", attrs="margin", outs="?Activated Out")
b("rank_loss", lambda label, left, right:
    torch.log(1 + torch.exp(left - right)) - label * (left - right),
  ins="Label Left Right")
b("hinge_loss", lambda logits, labels:
    torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits, 0.0),
  ins="Logits Labels", outs="Loss")
b("modified_huber_loss", lambda x, y: _modified_huber(x, y)[::-1],
  ins="X Y", outs="?IntermediateVal Out")
b("teacher_student_sigmoid_loss",
  lambda x, z, soft_max_up_bound=15.0, soft_max_lower_bound=-15.0:
    _ops().teacher_student_sigmoid_loss(x, z),
  ins="X Label", attrs="soft_max_up_bound soft_max_lower_bound",
  outs="Y")
b("bpr_loss", lambda x, label: _bpr_loss(x, label), ins="X Label",
  outs="Y")
b("squared_l2_distance", lambda x, y: (
    x - y, torch.sum(torch.square(x - y), dim=tuple(range(1, x.ndim)))
    .reshape(-1, 1)),
  ins="X Y", outs="?sub_result Out")
b("cos_sim", lambda x, y: _cos_sim(x, y), ins="X Y",
  outs="Out ?XNorm ?YNorm")
b("kldiv_loss", lambda x, target, reduction="mean":
    _F().kl_div(x, target, reduction=reduction),
  ins="X Target", attrs="reduction", outs="Loss")
b("nll_loss", lambda x, label, weight=None, ignore_index=-100,
    reduction="mean": _F().nll_loss(
        x, label, weight=weight, ignore_index=int(ignore_index),
        reduction=reduction),
  ins="X Label ?Weight", attrs="ignore_index reduction",
  outs="Out ?Total_weight")
b("smooth_l1_loss", lambda x, y, iw=None, ow=None, sigma=1.0:
    _fluid_smooth_l1(x, y, iw, ow, sigma),
  ins="X Y ?InsideWeight ?OutsideWeight", attrs="sigma",
  outs="?Diff Out")
b("sigmoid_focal_loss", lambda x, label, fg=None, gamma=2.0, alpha=0.25:
    _fluid_sigmoid_focal(x, label, fg, gamma, alpha),
  ins="X Label ?FgNum", attrs="gamma alpha")
b("warpctc", lambda logits, label, llen=None, lablen=None, blank=0,
    norm_by_times=False: _warpctc(logits, label, llen, lablen, blank,
                                  norm_by_times),
  ins="Logits Label ?LogitsLength ?LabelLength",
  attrs="blank norm_by_times", outs="Loss ?WarpCTCGrad")
b("lrn", lambda x, n=5, k=2.0, alpha=1e-4, beta=0.75,
    data_format="NCHW": _F().local_response_norm(
        x, int(n), alpha=alpha, beta=beta, k=k, data_format=data_format),
  ins="X", attrs="n k alpha beta data_format", outs="Out ?MidOut")
b("unpool", lambda x, indices, ksize=(2, 2), strides=(2, 2),
    paddings=(0, 0): _F().max_unpool2d(
        x, indices.to(torch.int32), [int(v) for v in ksize],
        stride=[int(v) for v in strides],
        padding=[int(v) for v in paddings]),
  ins="X Indices", attrs="ksize strides paddings")
b("spp", lambda x, pyramid_height=1, pooling_type="max":
    _F().spatial_pyramid_pool(x, int(pyramid_height),
                              pool_type=pooling_type.lower()),
  ins="X", attrs="pyramid_height pooling_type")
b("unfold", lambda x, kernel_sizes, strides=(1, 1), paddings=(0, 0),
    dilations=(1, 1): _F().unfold(
        x, [int(v) for v in kernel_sizes],
        strides=[int(v) for v in strides],
        paddings=[int(v) for v in paddings],
        dilations=[int(v) for v in dilations]),
  ins="X", attrs="kernel_sizes strides paddings dilations", outs="Y")
b("affine_channel", lambda x, scale, bias, data_layout="NCHW":
    _P().affine_channel(x, scale, bias, data_layout=data_layout),
  ins="X Scale Bias", attrs="data_layout")
b("shuffle_channel", lambda x, group=1: _F().channel_shuffle(
    x, int(group)), ins="X", attrs="group")
b("space_to_depth", lambda x, blocksize=1: _ops().space_to_depth(
    x, int(blocksize)), ins="X", attrs="blocksize")
b("row_conv", lambda x, w: _P().row_conv(x, w), ins="X Filter")
b("pad", lambda x, paddings=(), pad_value=0.0: np_pad(
    x, [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
        for i in range(x.ndim)], "constant", pad_value),
  ins="X", attrs="paddings pad_value")
b("pad_constant_like", lambda x, y, pad_value=0.0: np_pad(
    y, [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)], "constant",
    pad_value),
  ins="X Y", attrs="pad_value")
b("temporal_shift", lambda x, seg_num, shift_ratio=0.25,
    data_format="NCHW": _F().temporal_shift(
        x, int(seg_num), shift_ratio, data_format=data_format),
  ins="X", attrs="seg_num shift_ratio data_format")
b("fsp", lambda x, y: _ops().fsp_matrix(x, y), ins="X Y")
b("add_position_encoding", lambda x, alpha=1.0, beta=1.0:
    _ops().add_position_encoding(x, alpha, beta),
  ins="X", attrs="alpha beta")
b("cvm", lambda x, cvm_in, use_cvm=True: _ops().cvm(
    x, cvm_in, use_cvm=use_cvm), ins="X CVM", attrs="use_cvm", outs="Y")
b("conv_shift", lambda x, y: _ops().conv_shift(x, y), ins="X Y")
b("hash", lambda x, num_hash=1, mod_by=100000000: _ops().hash_op(
    x, num_hash=int(num_hash), mod_by=int(mod_by)),
  ins="X", attrs="num_hash mod_by")
b("similarity_focus", lambda x, axis=1, indexes=():
    _ops().similarity_focus(x, int(axis), [int(i) for i in indexes]),
  ins="X", attrs="axis indexes")
b("batch_fc", lambda x, w, bias=None: _ops().batch_fc(x, w, bias),
  ins="Input W ?Bias")
b("rank_attention", lambda x, off, par, MaxRank=3, MaxSize=0:
    _ops().rank_attention(x, off, par, max_rank=int(MaxRank),
                          max_size=int(MaxSize)),
  ins="X RankOffset RankParam", attrs="MaxRank MaxSize",
  outs="Out ?InputHelp ?InsRank")
b("lookup_table_dequant", lambda w, ids, padding_idx=-1:
    _ops().lookup_table_dequant(w, ids), ins="W Ids",
  attrs="padding_idx")
b("edit_distance", lambda hyps, refs, hl=None, rl=None,
    normalized=True: _edit_distance(hyps, refs, hl, rl, normalized),
  ins="Hyps Refs ?HypsLength ?RefsLength", attrs="normalized",
  outs="Out ?SequenceNum")
b("ctc_align", lambda x, xlen=None, blank=0, merge_repeated=True,
    padding_value=0: _ctc_align(x, xlen, blank, merge_repeated,
                                padding_value),
  ins="Input ?InputLength", attrs="blank merge_repeated padding_value",
  outs="Output ?OutputLength")
b("multihead_matmul", lambda inp, w, bias=None, bias_qk=None,
    alpha=1.0, head_number=1, **_: _multihead_matmul(
        inp, w, bias, bias_qk, alpha, int(head_number)),
  ins="Input W ?Bias ?BiasQK", attrs="alpha head_number")
b("im2sequence", lambda x, kernels=(1, 1), strides=(1, 1),
    paddings=(0, 0, 0, 0), out_stride=(1, 1): _im2sequence(
        x, kernels, strides, paddings),
  ins="X", attrs="kernels strides paddings out_stride")
b("bilinear_tensor_product", lambda x, y, w, bias=None:
    _bilinear_tp(x, y, w, bias), ins="X Y Weight ?Bias")
b("mean_iou", lambda pred, label, num_classes=2:
    _metric().mean_iou(pred, label, int(num_classes)),
  ins="Predictions Labels", attrs="num_classes",
  outs="OutMeanIou ?OutWrong ?OutCorrect")


# ---------------------------------------------------------------------------
# conv3d / pool3d family (shared Conv/PoolOpMaker schemas)
# ---------------------------------------------------------------------------
@braw("conv3d")
def _conv3d_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("Filter"))
    pad = op.attr("paddings", [0, 0, 0])
    algo = op.attr("padding_algorithm", "EXPLICIT")
    if algo in ("SAME", "VALID"):
        pad = algo
    scope[op.output("Output")] = _F().conv3d(
        x, w, None, stride=op.attr("strides", [1, 1, 1]), padding=pad,
        dilation=op.attr("dilations", [1, 1, 1]),
        groups=max(op.attr("groups", 1), 1),
        data_format=op.attr("data_format", "NCDHW"))


@braw("conv3d_transpose")
def _conv3d_transpose_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("Filter"))
    scope[op.output("Output")] = _F().conv3d_transpose(
        x, w, None, stride=op.attr("strides", [1, 1, 1]),
        padding=op.attr("paddings", [0, 0, 0]),
        dilation=op.attr("dilations", [1, 1, 1]),
        groups=max(op.attr("groups", 1), 1))


@braw("depthwise_conv2d_transpose")
def _dw_conv2d_t(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("Filter"))
    g = int(op.attr("groups", 0)) or int(x.shape[1])
    scope[op.output("Output")] = _F().conv2d_transpose(
        x, w, None, stride=op.attr("strides", [1, 1]),
        padding=op.attr("paddings", [0, 0]), groups=g)


@braw("pool3d")
def _pool3d_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    ptype = op.attr("pooling_type", "max")
    if op.attr("global_pooling", False):
        red = (2, 3, 4)
        scope[op.output("Out")] = torch.mean(x, red, keepdim=True) \
            if ptype == "avg" else torch.amax(x, red, keepdim=True)
        return
    kwargs = dict(kernel_size=op.attr("ksize", [1, 1, 1]),
                  stride=op.attr("strides", [1, 1, 1]),
                  padding=op.attr("paddings", [0, 0, 0]),
                  ceil_mode=op.attr("ceil_mode", False))
    if ptype == "avg":
        out = _F().avg_pool3d(x, exclusive=op.attr("exclusive", True),
                              **kwargs)
    else:
        out = _F().max_pool3d(x, **kwargs)
    scope[op.output("Out")] = out


@braw("max_pool2d_with_index", "max_pool3d_with_index")
def _pool_with_index(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    nd = 2 if op.type == "max_pool2d_with_index" else 3
    ksize = op.attr("ksize", [1] * nd)
    if op.attr("global_pooling", False):
        ksize = list(x.shape[2:])
    fn = _F().max_pool2d if nd == 2 else _F().max_pool3d
    out, mask = fn(x, ksize, stride=op.attr("strides", [1] * nd),
                   padding=op.attr("paddings", [0] * nd), return_mask=True)
    scope[op.output("Out")] = out
    if op.output("Mask"):
        scope[op.output("Mask")] = mask


@braw("data_norm")
def _data_norm_op(op, scope, feeds, fetches):
    # reference operators/data_norm_op.cc: means = BatchSum/BatchSize,
    # scales = sqrt(BatchSize/BatchSquareSum)
    x = scope.fetch(op.input("X"))
    bsize = scope.fetch(op.input("BatchSize"))
    bsum = scope.fetch(op.input("BatchSum"))
    bsq = scope.fetch(op.input("BatchSquareSum"))
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    y = (x - means) * scales
    if op.attr("enable_scale_and_shift", False):
        y = y * scope.fetch(op.input("scale_w")) + \
            scope.fetch(op.input("bias"))
    scope[op.output("Y")] = y
    if op.output("Means"):
        scope[op.output("Means")] = means
    if op.output("Scales"):
        scope[op.output("Scales")] = scales


@braw("inplace_abn")
def _inplace_abn_op(op, scope, feeds, fetches):
    # activation-fused batch_norm (inplace_abn_op.cc); inference form
    OP_TRANSLATORS["batch_norm"](op, scope, feeds, fetches)
    act = op.attr("activation", "")
    y = scope[op.output("Y")]
    if act == "relu":
        y = torch.clamp_min(y, 0)
    elif act == "leaky_relu":
        y = torch.where(y > 0, y, y * op.attr("alpha", 0.01))
    elif act == "elu":
        a = op.attr("alpha", 1.0)
        y = torch.where(y > 0, y, a * (torch.exp(y) - 1))
    scope[op.output("Y")] = y


@braw("spectral_norm")
def _spectral_norm_op(op, scope, feeds, fetches):
    # operators/spectral_norm_op.cc: power iteration on W reshaped with
    # `dim` leading
    w = scope.fetch(op.input("Weight"))
    u = scope.fetch(op.input("U")).reshape(-1)
    v = scope.fetch(op.input("V")).reshape(-1)
    dim = op.attr("dim", 0)
    eps = op.attr("eps", 1e-12)
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1)
    for _ in range(max(op.attr("power_iters", 1), 0)):
        v = wm.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ wm @ v
    out = (wm / sigma).reshape([w.shape[dim]] +
                               [w.shape[i] for i in perm[1:]])
    scope[op.output("Out")] = out.permute(np.argsort(perm).tolist())


@braw("shuffle_batch")
def _shuffle_batch_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    seed_in = op.input("Seed")
    seed = int(_scalar(scope.fetch(seed_in), "shuffle_batch's seed")) \
        if seed_in else int(op.attr("startup_seed", 0))
    idx = torch.randperm(x.shape[0], generator=_op_gen(op, seed),
                         device=_dev())
    scope[op.output("Out")] = x[idx]
    if op.output("ShuffleIdx"):
        scope[op.output("ShuffleIdx")] = idx.to(torch.int64)
    if op.output("SeedOut"):
        scope[op.output("SeedOut")] = torch.tensor(
            [seed + 1], dtype=torch.int64, device=_dev())


@braw("filter_by_instag")
def _filter_by_instag_op(op, scope, feeds, fetches):
    out = _ops().filter_by_instag(
        scope.fetch(op.input("Ins")), scope.fetch(op.input("Ins_tag")),
        scope.fetch(op.input("Filter_tag")),
        is_lod=op.attr("is_lod", True),
        out_val_if_empty=op.attr("out_val_if_empty", 0))
    outs = out if isinstance(out, tuple) else (out,)
    for n, v in zip(["Out", "LossWeight", "IndexMap"], outs):
        if op.output(n):
            scope[op.output(n)] = v


@braw("set_value")
def _set_value_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("Input"))
    axes = [int(a) for a in op.attr("axes", [])]
    starts = [int(s) for s in op.attr("starts", [])]
    ends = [int(e) for e in op.attr("ends", [])]
    steps = [int(s) for s in op.attr("steps", [])] or [1] * len(axes)
    vt = op.input("ValueTensor")
    if vt:
        value = scope.fetch(vt)
    else:
        shape = [int(s) for s in op.attr("shape", [])]
        value = None
        for key in ("fp32_values", "int32_values", "int64_values",
                    "bool_values", "fp64_values"):
            vals = op.attr(key)
            if vals:
                value = _tensor(np.asarray(vals).reshape(shape))
                break
        if value is None:
            value = torch.zeros(shape, dtype=_dt(op.attr("dtype", 5)),
                                device=_dev())
    idx = [slice(None)] * x.ndim
    for ax, s, e, st in zip(axes, starts, ends, steps):
        n = x.shape[ax]
        s += n if s < 0 else 0
        e += n if e < 0 else 0
        idx[ax] = torch.tensor(_py_slice_index(n, s, min(e, n), st),
                               dtype=torch.long, device=x.device)
    out = x.clone()
    # one advanced index a sliced axis, broadcast against each other
    nidx = sum(isinstance(i, torch.Tensor) for i in idx)
    k = 0
    full = []
    for i in idx:
        if isinstance(i, torch.Tensor):
            shape = [1] * nidx
            shape[k] = -1
            full.append(i.reshape(shape))
            k += 1
        else:
            full.append(i)
    if nidx:
        sel_shape = list(out[tuple(full)].shape)
        out[tuple(full)] = torch.broadcast_to(value.to(x.dtype),
                                              sel_shape)
    else:
        out[...] = value.to(x.dtype)
    scope[op.output("Out")] = out


# ---------------------------------------------------------------------------
# sequence family on the padded+lengths LoD representation (reference
# operators/sequence_ops/*.cc) — each translator reads the `<name>@LOD`
# sidecar (full length when absent) and writes the output's sidecar
# ---------------------------------------------------------------------------
def _seq_len(scope, name, x):
    from .interp import _seq_lengths_or_full

    return _seq_lengths_or_full(scope, name, x)


def _seq():
    return _mod("seq")


@braw("sequence_concat")
def _sequence_concat_op(op, scope, feeds, fetches):
    names = op.inputs("X")
    xs = [scope.fetch(n) for n in names]
    lens = [_seq_len(scope, n, x) for n, x in zip(names, xs)]
    out = _seq().sequence_concat(xs, lens)
    out, out_len = out if isinstance(out, tuple) else (out, sum(lens))
    scope[op.output("Out")] = out
    scope[op.output("Out") + "@LOD"] = out_len


@braw("sequence_conv")
def _sequence_conv_op(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    w = scope.fetch(op.input("Filter"))
    lens = _seq_len(scope, name, x)
    pad_name = op.input("PaddingData")
    scope[op.output("Out")] = _seq().sequence_conv(
        x, lens, w, context_length=int(op.attr("contextLength", 3)),
        context_start=op.attr("contextStart", None),
        padding_data=scope.fetch(pad_name) if pad_name and
        op.attr("paddingTrainable", False) else None)
    scope[op.output("Out") + "@LOD"] = lens


@braw("sequence_enumerate")
def _sequence_enumerate_op(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    lens = _seq_len(scope, name, x)
    scope[op.output("Out")] = _seq().sequence_enumerate(
        x, lens, int(op.attr("win_size", 1)),
        pad_value=op.attr("pad_value", 0))
    scope[op.output("Out") + "@LOD"] = lens


@braw("sequence_erase")
def _sequence_erase_op(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    lens = _seq_len(scope, name, x)
    out = _seq().sequence_erase(x, lens, list(op.attr("tokens", [])))
    out, new_len = out if isinstance(out, tuple) else (out, lens)
    scope[op.output("Out")] = out
    scope[op.output("Out") + "@LOD"] = new_len


@braw("sequence_expand")
def _sequence_expand_op(op, scope, feeds, fetches):
    # Y's @LOD provides the repeat counts (read on the host)
    xname, yname = op.input("X"), op.input("Y")
    x = scope.fetch(xname)
    y = scope.fetch(yname)
    reps = _host_read(_seq_len(scope, yname, y), "sequence_expand's "
                      "repeat counts")
    scope[op.output("Out")] = _P().sequence_expand(x, reps.tolist())


@braw("sequence_expand_as")
def _sequence_expand_as_op(op, scope, feeds, fetches):
    xname, yname = op.input("X"), op.input("Y")
    x = scope.fetch(xname)
    ylen = _seq_len(scope, yname, scope.fetch(yname))
    scope[op.output("Out")] = _seq().sequence_expand_as(x, ylen)
    scope[op.output("Out") + "@LOD"] = ylen


@braw("sequence_reshape")
def _sequence_reshape_op(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    lens = _seq_len(scope, name, x)
    out = _seq().sequence_reshape(x, lens,
                                  int(op.attr("new_dim", x.shape[-1])))
    out, new_len = out if isinstance(out, tuple) else (out, lens)
    scope[op.output("Out")] = out
    scope[op.output("Out") + "@LOD"] = new_len


@braw("sequence_scatter")
def _sequence_scatter_op(op, scope, feeds, fetches):
    ids_name = op.input("Ids")
    ids = scope.fetch(ids_name)
    scope[op.output("Out")] = _seq().sequence_scatter(
        scope.fetch(op.input("X")), ids, scope.fetch(op.input("Updates")),
        _seq_len(scope, ids_name, ids))


@braw("sequence_slice")
def _sequence_slice_op(op, scope, feeds, fetches):
    name = op.input("X")
    x = scope.fetch(name)
    lens = _seq_len(scope, name, x)
    off = scope.fetch(op.input("Offset")).reshape(-1)
    ln = scope.fetch(op.input("Length")).reshape(-1)
    out = _seq().sequence_slice(x, lens, off, ln)
    if isinstance(out, tuple):  # (padded, new_lengths)
        out, ln = out
    scope[op.output("Out")] = out
    scope[op.output("Out") + "@LOD"] = ln.to(torch.int32)


@braw("sequence_unpad")
def _sequence_unpad_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    ln = scope.fetch(op.input("Length")).reshape(-1)
    scope[op.output("Out")] = _P().sequence_unpad(x, ln)
    scope[op.output("Out") + "@LOD"] = ln.to(torch.int32)


@braw("sequence_topk_avg_pooling")
def _sequence_topk_avg_pooling_op(op, scope, feeds, fetches):
    xname = op.input("X")
    x = scope.fetch(xname)
    row_name, col_name = op.input("ROW"), op.input("COLUMN")
    rlen = _seq_len(scope, row_name, scope.fetch(row_name)) \
        if row_name else _seq_len(scope, xname, x)
    clen = _seq_len(scope, col_name, scope.fetch(col_name)) \
        if col_name else torch.full((x.shape[0],), x.shape[-1],
                                    dtype=torch.int32, device=x.device)
    scope[op.output("Out")] = _seq().sequence_topk_avg_pooling(
        x, rlen, clen, [int(k) for k in op.attr("topks", [1])],
        channel_num=int(op.attr("channel_num", 1)))
    if op.output("pos"):
        scope[op.output("pos")] = torch.zeros((1,), dtype=torch.int32,
                                              device=_dev())


# ---------------------------------------------------------------------------
# vision / detection family (reference operators/detection/*.cc).  RoI
# batching: RoisNum when present, else the `@LOD` sidecar, else all rois
# in image 0.
# ---------------------------------------------------------------------------
def _rois_num(op, scope, rois, param="RoisNum"):
    name = op.input(param)
    if name:
        return scope.fetch(name).reshape(-1).to(torch.int32)
    key = op.input("ROIs") + "@LOD"
    if key in scope:
        return _tensor(scope[key]).reshape(-1).to(torch.int32)
    return torch.tensor([rois.shape[0]], dtype=torch.int32, device=_dev())


def _one_image(rois):
    return torch.tensor([rois.shape[0]], dtype=torch.int32,
                        device=rois.device)


@braw("roi_pool")
def _roi_pool_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    rois = scope.fetch(op.input("ROIs"))
    out = _vops().roi_pool(x, rois, _rois_num(op, scope, rois),
                           (int(op.attr("pooled_height", 1)),
                            int(op.attr("pooled_width", 1))),
                           spatial_scale=op.attr("spatial_scale", 1.0))
    scope[op.output("Out")] = out
    if op.output("Argmax"):
        scope[op.output("Argmax")] = torch.zeros(
            out.shape, dtype=torch.int64, device=out.device)


def _deform_conv(x, offset, w, mask=None, strides=(1, 1),
                 paddings=(0, 0), dilations=(1, 1), groups=1,
                 deformable_groups=1, im2col_step=1):
    return _vops().deform_conv2d(
        x, offset, w, stride=[int(s) for s in strides],
        padding=[int(p) for p in paddings],
        dilation=[int(d) for d in dilations],
        deformable_groups=int(deformable_groups), groups=int(groups),
        mask=mask)


def _gen_proposals(scores, deltas, im, anchors, var, pre_nms_topN=6000,
                   post_nms_topN=1000, nms_thresh=0.5, min_size=0.1,
                   eta=1.0, pixel_offset=True):
    return _vops().generate_proposals(
        scores, deltas, im, anchors, var, pre_nms_top_n=int(pre_nms_topN),
        post_nms_top_n=int(post_nms_topN), nms_thresh=nms_thresh,
        min_size=min_size, eta=eta, pixel_offset=pixel_offset)


def _distribute_fpn(rois, rois_num, min_level, max_level, refer_level,
                    refer_scale, pixel_offset):
    out = _vops().distribute_fpn_proposals(
        rois, int(min_level), int(max_level), int(refer_level),
        int(refer_scale), pixel_offset=pixel_offset, rois_num=rois_num)
    multi, restore = out[0], out[1]
    nums = out[2] if len(out) > 2 else [_one_image(r) for r in multi]
    return list(multi), restore, list(nums or [])


b("psroi_pool", lambda x, rois, output_channels=1, spatial_scale=1.0,
    pooled_height=1, pooled_width=1: _vops().psroi_pool(
        x, rois, _one_image(rois), int(output_channels), spatial_scale,
        int(pooled_height), int(pooled_width)),
  ins="X ROIs", attrs="output_channels spatial_scale pooled_height "
                      "pooled_width")
b("prroi_pool", lambda x, rois, rois_num=None, spatial_scale=1.0,
    pooled_height=1, pooled_width=1: _vops().prroi_pool(
        x, rois, rois_num if rois_num is not None else _one_image(rois),
        int(pooled_height), int(pooled_width), spatial_scale),
  ins="X ROIs ?BatchRoINums",
  attrs="spatial_scale pooled_height pooled_width")
b("deformable_conv", _deform_conv, ins="Input Offset Filter ?Mask",
  attrs="strides paddings dilations groups deformable_groups "
        "im2col_step", outs="Output")
b("deformable_conv_v1", _deform_conv, ins="Input Offset Filter",
  attrs="strides paddings dilations groups deformable_groups "
        "im2col_step", outs="Output")
b("deformable_psroi_pooling",
  lambda x, rois, trans, no_trans=False, spatial_scale=1.0,
  output_dim=None, group_size=(1,), pooled_height=1, pooled_width=1,
  part_size=(), sample_per_part=4, trans_std=0.1:
    _vops().deformable_psroi_pooling(
        x, rois, trans, no_trans=no_trans,
        spatial_scale=spatial_scale, output_channels=output_dim,
        group_size=int(group_size[0]) if group_size else 1,
        pooled_height=int(pooled_height),
        pooled_width=int(pooled_width),
        part_size=[int(p) for p in part_size] or None,
        sample_per_part=int(sample_per_part), trans_std=trans_std),
  ins="Input ROIs ?Trans",
  attrs="no_trans spatial_scale output_dim group_size pooled_height "
        "pooled_width part_size sample_per_part trans_std",
  outs="Output ?TopCount")
b("box_clip", lambda x, im_info: _vops().box_clip(x, im_info),
  ins="Input ImInfo", outs="Output")
b("iou_similarity", lambda x, y, box_normalized=True:
    _vops().iou_similarity(x, y, box_normalized=box_normalized),
  ins="X Y", attrs="box_normalized")
b("correlation", lambda x1, x2, pad_size, kernel_size,
    max_displacement, stride1, stride2, corr_type_multiply=1:
    _vops().correlation(
        x1, x2, int(pad_size), int(kernel_size), int(max_displacement),
        int(stride1), int(stride2), int(corr_type_multiply)),
  ins="Input1 Input2",
  attrs="pad_size kernel_size max_displacement stride1 stride2 "
        "corr_type_multiply", outs="Output")
b("bilateral_slice", lambda x, grid, guide, has_offset=False:
    _vops().bilateral_slice(x, grid, guide, has_offset=has_offset),
  ins="X Grid Guide", attrs="has_offset")
b("polygon_box_transform", lambda x: _vdet().polygon_box_transform(x),
  ins="Input", outs="Output")
b("bipartite_match", lambda dist, match_type="bipartite",
    dist_threshold=0.5: _P().bipartite_match(
        dist, match_type=match_type, dist_threshold=dist_threshold),
  ins="DistMat", attrs="match_type dist_threshold",
  outs="ColToRowMatchIndices ?ColToRowMatchDist")
b("anchor_generator", lambda x, anchor_sizes, aspect_ratios, variances,
    stride, offset=0.5: _P().anchor_generator(
        x, [float(a) for a in anchor_sizes],
        [float(a) for a in aspect_ratios], [float(v) for v in variances],
        [float(s) for s in stride], offset),
  ins="Input",
  attrs="anchor_sizes aspect_ratios variances stride offset",
  outs="Anchors Variances")
b("target_assign", lambda x, mi, ni=None, mismatch_value=0:
    _vdet().target_assign(x, mi, negative_indices=ni,
                          mismatch_value=mismatch_value),
  ins="X MatchIndices ?NegIndices", attrs="mismatch_value",
  outs="Out ?OutWeight")
b("mine_hard_examples", lambda cls_loss, loc_loss, mi, md,
    neg_pos_ratio=3.0, neg_dist_threshold=0.5, sample_size=0,
    mining_type="max_negative": _vdet().mine_hard_examples(
        cls_loss, mi, md, loc_loss=loc_loss, neg_pos_ratio=neg_pos_ratio,
        neg_dist_threshold=neg_dist_threshold,
        sample_size=int(sample_size), mining_type=mining_type),
  ins="ClsLoss ?LocLoss MatchIndices MatchDist",
  attrs="neg_pos_ratio neg_dist_threshold sample_size mining_type",
  outs="NegIndices ?UpdatedMatchIndices")
b("retinanet_detection_output", lambda bb, sc, an, im,
    score_threshold=0.05, nms_top_k=1000, keep_top_k=100,
    nms_threshold=0.3, nms_eta=1.0: _vops().retinanet_detection_output(
        bb, sc, an, im, score_threshold=score_threshold,
        nms_top_k=int(nms_top_k), keep_top_k=int(keep_top_k),
        nms_threshold=nms_threshold, nms_eta=nms_eta),
  ins="*BBoxes *Scores *Anchors ImInfo",
  attrs="score_threshold nms_top_k keep_top_k nms_threshold nms_eta")
b("locality_aware_nms", lambda bb, sc, score_threshold=0.05,
    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3, normalized=True,
    nms_eta=1.0, background_label=-1: _vops().locality_aware_nms(
        bb, sc, score_threshold, int(nms_top_k), int(keep_top_k),
        nms_threshold=nms_threshold, normalized=normalized,
        nms_eta=nms_eta, background_label=int(background_label))[0],
  ins="BBoxes Scores",
  attrs="score_threshold nms_top_k keep_top_k nms_threshold "
        "normalized nms_eta background_label")
b("density_prior_box", lambda x, img, densities=(), fixed_sizes=(),
    fixed_ratios=(), variances=(0.1, 0.1, 0.2, 0.2), clip=False,
    step_w=0.0, step_h=0.0, offset=0.5, flatten_to_2d=False:
    _vops().density_prior_box(
        x, img, [int(d) for d in densities],
        [float(s) for s in fixed_sizes], [float(r) for r in fixed_ratios],
        variance=[float(v) for v in variances], clip=clip,
        step_w=float(step_w[0]) if isinstance(step_w, (list, tuple))
        and step_w else float(step_w or 0.0),
        step_h=float(step_h[0]) if isinstance(step_h, (list, tuple))
        and step_h else float(step_h or 0.0),
        offset=offset, flatten_to_2d=flatten_to_2d),
  ins="Input Image",
  attrs="densities fixed_sizes fixed_ratios variances clip step_w "
        "step_h offset flatten_to_2d", outs="Boxes Variances")
b("yolov3_loss", lambda x, gtbox, gtlabel, gtscore=None, class_num=1,
    anchors=(), anchor_mask=(), downsample_ratio=32,
    ignore_thresh=0.7, use_label_smooth=True, scale_x_y=1.0:
    _vops().yolov3_loss(
        x, gtbox, gtlabel, [int(a) for a in anchors],
        [int(m) for m in anchor_mask], int(class_num), ignore_thresh,
        int(downsample_ratio), gt_score=gtscore,
        use_label_smooth=use_label_smooth, scale_x_y=scale_x_y),
  ins="X GTBox GTLabel ?GTScore",
  attrs="class_num anchors anchor_mask downsample_ratio ignore_thresh "
        "use_label_smooth scale_x_y",
  outs="Loss ?ObjectnessMask ?GTMatchMask")
b("matrix_nms", lambda bb, sc, score_threshold=0.05,
    post_threshold=0.0, nms_top_k=1000, keep_top_k=100,
    use_gaussian=False, gaussian_sigma=2.0, background_label=-1,
    normalized=True: _vops().matrix_nms(
        bb, sc, score_threshold, post_threshold, int(nms_top_k),
        int(keep_top_k), use_gaussian=use_gaussian,
        gaussian_sigma=gaussian_sigma,
        background_label=int(background_label), normalized=normalized,
        return_index=True),
  ins="BBoxes Scores",
  attrs="score_threshold post_threshold nms_top_k keep_top_k "
        "use_gaussian gaussian_sigma background_label normalized",
  outs="Out ?Index ?RoisNum")
b("box_decoder_and_assign", lambda pb, pbv, tb, bs, box_clip=4.135:
    _vops().box_decoder_and_assign(pb, pbv, tb, bs,
                                   box_clip=float(box_clip)),
  ins="PriorBox PriorBoxVar TargetBox BoxScore", attrs="box_clip",
  outs="DecodeBox OutputAssignBox")
b("generate_proposals", _gen_proposals,
  ins="Scores BboxDeltas ImInfo Anchors Variances",
  attrs="pre_nms_topN post_nms_topN nms_thresh min_size eta",
  outs="RpnRois RpnRoiProbs ?RpnRoisNum")
b("generate_proposals_v2", _gen_proposals,
  ins="Scores BboxDeltas ImShape Anchors Variances",
  attrs="pre_nms_topN post_nms_topN nms_thresh min_size eta "
        "pixel_offset",
  outs="RpnRois RpnRoiProbs ?RpnRoisNum")
b("distribute_fpn_proposals", lambda rois, rois_num=None, min_level=2,
    max_level=5, refer_level=4, refer_scale=224, pixel_offset=True:
    _distribute_fpn(rois, rois_num, min_level, max_level, refer_level,
                    refer_scale, pixel_offset),
  ins="FpnRois ?RoisNum",
  attrs="min_level max_level refer_level refer_scale pixel_offset",
  outs="*MultiFpnRois RestoreIndex *MultiLevelRoIsNum")
b("collect_fpn_proposals", lambda rois, scores, rois_num=None,
    post_nms_topN=100: _vops().collect_fpn_proposals(
        rois, scores, 2, 2 + len(rois) - 1, int(post_nms_topN),
        rois_num_per_level=rois_num or None),
  ins="*MultiLevelRois *MultiLevelScores *MultiLevelRoIsNum",
  attrs="post_nms_topN", outs="FpnRois ?RoisNum")
b("roi_perspective_transform", lambda x, rois, transformed_height=1,
    transformed_width=1, spatial_scale=1.0:
    _vdet().roi_perspective_transform(
        x, rois, int(transformed_height), int(transformed_width),
        spatial_scale),
  ins="X ROIs",
  attrs="transformed_height transformed_width spatial_scale",
  outs="Out ?Mask ?TransformMatrix ?Out2InIdx ?Out2InWeights")
b("rpn_target_assign", lambda anchor, gt, is_crowd, im_info,
    rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
    rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
    rpn_negative_overlap=0.3, use_random=False:
    _vdet().rpn_target_assign(
        None, None, anchor, None, gt, is_crowd, im_info,
        rpn_batch_size_per_im=int(rpn_batch_size_per_im),
        rpn_straddle_thresh=rpn_straddle_thresh,
        rpn_fg_fraction=rpn_fg_fraction,
        rpn_positive_overlap=rpn_positive_overlap,
        rpn_negative_overlap=rpn_negative_overlap,
        use_random=use_random),
  ins="Anchor GtBoxes IsCrowd ImInfo",
  attrs="rpn_batch_size_per_im rpn_straddle_thresh rpn_fg_fraction "
        "rpn_positive_overlap rpn_negative_overlap use_random",
  outs="LocationIndex ScoreIndex TargetBBox TargetLabel "
       "?BBoxInsideWeight")
b("retinanet_target_assign", lambda anchor, gt, gtl, is_crowd, im_info,
    positive_overlap=0.5, negative_overlap=0.4:
    _vdet().retinanet_target_assign(
        None, None, anchor, None, gt, gtl, is_crowd, im_info,
        positive_overlap=positive_overlap,
        negative_overlap=negative_overlap),
  ins="Anchor GtBoxes GtLabels IsCrowd ImInfo",
  attrs="positive_overlap negative_overlap",
  outs="LocationIndex ScoreIndex TargetBBox TargetLabel "
       "?BBoxInsideWeight ?ForegroundNumber")
b("generate_proposal_labels", lambda rois, gtc, crowd, gtb, im,
    batch_size_per_im=256, fg_fraction=0.25, fg_thresh=0.5,
    bg_thresh_hi=0.5, bg_thresh_lo=0.0,
    bbox_reg_weights=(0.1, 0.1, 0.2, 0.2), class_nums=81,
    use_random=False, is_cls_agnostic=False:
    _vdet().generate_proposal_labels(
        rois, gtc, crowd, gtb, im,
        batch_size_per_im=int(batch_size_per_im),
        fg_fraction=fg_fraction, fg_thresh=fg_thresh,
        bg_thresh_hi=bg_thresh_hi, bg_thresh_lo=bg_thresh_lo,
        bbox_reg_weights=[float(w) for w in bbox_reg_weights],
        class_nums=int(class_nums), use_random=use_random,
        is_cls_agnostic=is_cls_agnostic),
  ins="RpnRois GtClasses IsCrowd GtBoxes ImInfo",
  attrs="batch_size_per_im fg_fraction fg_thresh bg_thresh_hi "
        "bg_thresh_lo bbox_reg_weights class_nums use_random "
        "is_cls_agnostic",
  outs="Rois LabelsInt32 BboxTargets BboxInsideWeights "
       "BboxOutsideWeights ?MaxOverlapWithGT")
b("generate_mask_labels", lambda im, gtc, crowd, segms, rois, lab,
    num_classes=81, resolution=14: _vdet().generate_mask_labels(
        im, gtc, crowd, segms, rois, lab, int(num_classes),
        int(resolution)),
  ins="ImInfo GtClasses IsCrowd GtSegms Rois LabelsInt32",
  attrs="num_classes resolution",
  outs="MaskRois RoiHasMaskInt32 MaskInt32")


# ---------------------------------------------------------------------------
# industrial / CRF / quant-runtime ops
# ---------------------------------------------------------------------------
def _linear_chain_crf(em, tr, label, length):
    out = _P().linear_chain_crf(em, tr, label, length)
    return out if isinstance(out, tuple) else (out,)


def _center_loss(x, label, centers, rate, need_update):
    lab = label.reshape(-1).long()
    diff = x - centers[lab]
    loss = 0.5 * torch.sum(torch.square(diff), -1, keepdim=True)
    if need_update:
        # reference center_loss_op.h: centers -= rate * mean-per-center
        counts = torch.zeros((centers.shape[0],), dtype=x.dtype,
                             device=x.device).index_add(
            0, lab, torch.ones_like(lab, dtype=x.dtype))
        upd = torch.zeros_like(centers).index_add(0, lab, diff)
        centers = centers + rate.reshape(()) * upd / torch.clamp_min(
            counts[:, None], 1.0)
    return centers, diff, loss


def _moving_avg_scale(x, accum, state, rate):
    out = _quant().moving_average_abs_max_scale(
        x, state=state, accum=accum, moving_rate=rate)
    # eager returns (x, scale, new_state, new_accum)
    _, scale, new_state, new_accum = out
    return x, scale, new_state, new_accum


b("crf_decoding", lambda em, tr, label=None, length=None:
    _P().crf_decoding(em, tr, label=label, length=length),
  ins="Emission Transition ?Label ?Length", outs="ViterbiPath")
b("linear_chain_crf", lambda em, tr, label, length=None:
    _linear_chain_crf(em, tr, label, length),
  ins="Emission Transition Label ?Length",
  outs="LogLikelihood ?Alpha ?EmissionExps ?TransitionExps")
b("tdm_child", lambda x, tree, child_nums=1, dtype=3: _ops().tdm_child(
    x, tree, int(child_nums), dtype=_conv_dtype(dtype)),
  ins="X TreeInfo", attrs="child_nums dtype", outs="Child ?LeafMask")
b("tdm_sampler", lambda x, travel, layer, output_positive=True,
    neg_samples_num_list=(), layer_offset_lod=(), seed=0, dtype=3:
    _ops().tdm_sampler(x, travel, layer,
                       [int(n) for n in neg_samples_num_list],
                       [int(o) for o in layer_offset_lod],
                       output_positive=output_positive, seed=int(seed)),
  ins="X Travel Layer",
  attrs="output_positive neg_samples_num_list layer_offset_lod seed "
        "dtype",
  outs="Out ?Labels ?Mask")
b("pyramid_hash", lambda x, w, wl=None, bl=None, num_emb=8,
    space_len=1000, pyramid_layer=2, rand_len=4, drop_out_percent=0.0,
    is_training=False, seed=0, **_: _ops().pyramid_hash(
        x, w, num_emb=int(num_emb), space_len=int(space_len),
        pyramid_layer=int(pyramid_layer), rand_len=int(rand_len),
        drop_out_percent=drop_out_percent,
        is_training=bool(is_training), seed=int(seed)),
  ins="X W ?WhiteList ?BlackList",
  attrs="num_emb space_len pyramid_layer rand_len drop_out_percent "
        "is_training seed",
  outs="Out ?DropPos ?X_Temp_Out")
b("tree_conv", lambda nodes, edges, filt, max_depth=2: _ops().tree_conv(
    nodes, edges, filt, int(max_depth)),
  ins="NodesVector EdgeSet Filter", attrs="max_depth")
b("nce", lambda x, label, w, bias=None, sw=None, num_total_classes=2,
    num_neg_samples=10, sampler=0, seed=0, **_: _F().nce(
        x, label, w, bias=bias, num_total_classes=int(num_total_classes),
        num_neg_samples=int(num_neg_samples),
        sampler=["uniform", "log_uniform", "custom_dist"][int(sampler)]
        if not isinstance(sampler, str) else sampler,
        sample_weight=sw, seed=int(seed)),
  ins="Input Label Weight ?Bias ?SampleWeight",
  attrs="num_total_classes num_neg_samples sampler seed",
  outs="Cost ?SampleLogits ?SampleLabels")
b("hierarchical_sigmoid", lambda x, w, label, pt=None, pc=None,
    bias=None, num_classes=2, **_: _F().hsigmoid_loss(
        x, label, int(num_classes), w, bias=bias, path_table=pt,
        path_code=pc),
  ins="X W Label ?PathTable ?PathCode ?Bias", attrs="num_classes",
  outs="Out ?PreOut ?W_Out")
b("center_loss", lambda x, label, centers, rate, cluster_num=2,
    need_update=True: _center_loss(x, label, centers, rate, need_update),
  ins="X Label Centers CenterUpdateRate",
  attrs="cluster_num need_update",
  outs="CentersOut ?SampleCenterDiff Loss")
b("sample_logits", lambda logits, labels, cs=None, cp=None,
    num_samples=1, uniq=True, remove_accidental_hits=True,
    use_customized_samples=False, seed=0: _ops().sample_logits(
        logits, labels, int(num_samples), uniq=uniq,
        remove_accidental_hits=remove_accidental_hits,
        use_customized_samples=use_customized_samples,
        customized_samples=cs, customized_probabilities=cp,
        seed=int(seed)),
  ins="Logits Labels ?CustomizedSamples ?CustomizedProbabilities",
  attrs="num_samples uniq remove_accidental_hits "
        "use_customized_samples seed",
  outs="SampledLogits SampledLabels ?Samples ?Probabilities")
b("match_matrix_tensor", lambda x, y, w, dim_t=1:
    _ops().match_matrix_tensor(x, y, w, dim_t=int(dim_t)),
  ins="X Y W", attrs="dim_t", outs="Out ?Tmp")
b("var_conv_2d", lambda x, w, row, col, InputChannel=1,
    OutputChannel=1, KernelH=1, KernelW=1, StrideH=1, StrideW=1:
    _ops().var_conv_2d(x, w, row, col, int(InputChannel),
                       int(OutputChannel), int(KernelH), int(KernelW),
                       int(StrideH), int(StrideW)),
  ins="X W ?ROW ?COLUMN",
  attrs="InputChannel OutputChannel KernelH KernelW StrideH StrideW",
  outs="Out ?Col")
b("lstmp", lambda x, h0, c0, w, pw, bias=None, use_peepholes=True,
    is_reverse=False, gate_activation="sigmoid",
    cell_activation="tanh", candidate_activation="tanh",
    proj_activation="tanh", **_: _ops().lstmp(
        x, w, pw, bias=bias, h0=h0, c0=c0, use_peepholes=use_peepholes,
        is_reverse=is_reverse, gate_activation=gate_activation,
        cell_activation=cell_activation,
        candidate_activation=candidate_activation,
        proj_activation=proj_activation),
  ins="Input ?H0 ?C0 Weight ProjWeight ?Bias",
  attrs="use_peepholes is_reverse gate_activation cell_activation "
        "candidate_activation proj_activation",
  outs="Projection ?Cell ?BatchGate ?BatchCellPreAct ?BatchHidden")
b("dequantize_abs_max", lambda x, scale, max_range=127.0:
    _quant().dequantize_abs_max(x, scale, float(max_range)),
  ins="X Scale", attrs="max_range")
b("dequantize_log", lambda x, table: _quant().dequantize_log(x, table),
  ins="X Dict")
b("moving_average_abs_max_scale", lambda x, accum=None, state=None,
    moving_rate=0.9, is_test=False: _moving_avg_scale(
        x, accum, state, moving_rate),
  ins="X ?InAccum ?InState", attrs="moving_rate is_test",
  outs="?Out OutScale ?OutState ?OutAccum")


# ---------------------------------------------------------------------------
# in-program optimizer ops (reference operators/optimizers/*).  Slot vars
# default sensibly when the program hasn't initialized them.
# ---------------------------------------------------------------------------
def _opt_common(op, scope):
    p = scope.fetch(op.input("Param"))
    g = scope.fetch(op.input("Grad"))
    lr_in = op.input("LearningRate")
    lr = scope.fetch(lr_in).reshape(()) if lr_in else None
    return p, g, lr


def _slot(op, scope, name, like, fill=0.0):
    vname = op.input(name)
    if vname and vname in scope:
        return scope[vname]
    return torch.full_like(like, fill)


def _scalar_slot(op, scope, name, default):
    vname = op.input(name)
    if vname and vname in scope:
        return scope[vname].reshape(()).float()
    return torch.tensor(default, dtype=torch.float32, device=_dev())


@braw("adam", "adamw")
def _adam_op(op, scope, feeds, fetches):
    # reference adam_op.h AdamFunctor; adamw adds decoupled decay
    p, g, lr = _opt_common(op, scope)
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m = _slot(op, scope, "Moment1", p)
    v = _slot(op, scope, "Moment2", p)
    b1p = _scalar_slot(op, scope, "Beta1Pow", b1)
    b2p = _scalar_slot(op, scope, "Beta2Pow", b2)
    if op.type == "adamw" and op.attr("with_decay", True):
        p = p - lr * op.attr("coeff", 0.01) * p
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    new_p = p - lr_t * m / (torch.sqrt(v) + eps * torch.sqrt(1 - b2p))
    scope[op.output("ParamOut")] = new_p.to(p.dtype)
    scope[op.output("Moment1Out")] = m
    scope[op.output("Moment2Out")] = v
    if op.output("Beta1PowOut") and not op.attr("use_global_beta_pow",
                                                False):
        scope[op.output("Beta1PowOut")] = (b1p * b1).reshape(1)
        scope[op.output("Beta2PowOut")] = (b2p * b2).reshape(1)
    if op.input("MasterParam") and op.output("MasterParamOut"):
        scope[op.output("MasterParamOut")] = new_p.float()


@braw("adamax")
def _adamax_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m = _slot(op, scope, "Moment", p)
    inf = _slot(op, scope, "InfNorm", p)
    b1p = _scalar_slot(op, scope, "Beta1Pow", b1)
    m = b1 * m + (1 - b1) * g
    inf = torch.maximum(b2 * inf, torch.abs(g) + eps)
    scope[op.output("ParamOut")] = p - (lr / (1 - b1p)) * m / inf
    scope[op.output("MomentOut")] = m
    scope[op.output("InfNormOut")] = inf
    if op.output("Beta1PowOut"):
        scope[op.output("Beta1PowOut")] = (b1p * b1).reshape(1)


@braw("adagrad", "decayed_adagrad", "proximal_adagrad")
def _adagrad_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    eps = op.attr("epsilon", 1e-6)
    mom = _slot(op, scope, "Moment", p)
    if op.type == "decayed_adagrad":
        decay = op.attr("decay", 0.95)
        mom = decay * mom + (1 - decay) * g * g
    else:
        mom = mom + g * g
    step = lr * g / (torch.sqrt(mom) + eps)
    if op.type == "proximal_adagrad":
        l1 = op.attr("l1", 0.0)
        l2 = op.attr("l2", 0.0)
        prox = p - step
        lr_eff = lr / (torch.sqrt(mom) + eps)
        new_p = torch.sign(prox) * torch.clamp_min(
            torch.abs(prox) - lr_eff * l1, 0.0) / (1.0 + lr_eff * l2)
    else:
        new_p = p - step
    scope[op.output("ParamOut")] = new_p
    scope[op.output("MomentOut")] = mom


@braw("adadelta")
def _adadelta_op(op, scope, feeds, fetches):
    p = scope.fetch(op.input("Param"))
    g = scope.fetch(op.input("Grad"))
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    asg = _slot(op, scope, "AvgSquaredGrad", p)
    asu = _slot(op, scope, "AvgSquaredUpdate", p)
    asg = rho * asg + (1 - rho) * g * g
    upd = -torch.sqrt((asu + eps) / (asg + eps)) * g
    asu = rho * asu + (1 - rho) * upd * upd
    scope[op.output("ParamOut")] = p + upd
    scope[op.output("AvgSquaredGradOut")] = asg
    scope[op.output("AvgSquaredUpdateOut")] = asu


@braw("rmsprop")
def _rmsprop_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    rho = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    mu = op.attr("momentum", 0.0)
    ms = _slot(op, scope, "MeanSquare", p)
    mom = _slot(op, scope, "Moment", p)
    ms = rho * ms + (1 - rho) * g * g
    if op.attr("centered", False):
        mg = _slot(op, scope, "MeanGrad", p)
        mg = rho * mg + (1 - rho) * g
        denom = ms - mg * mg
        if op.output("MeanGradOut"):
            scope[op.output("MeanGradOut")] = mg
    else:
        denom = ms
    mom = mu * mom + lr * g / torch.sqrt(denom + eps)
    scope[op.output("ParamOut")] = p - mom
    scope[op.output("MeanSquareOut")] = ms
    scope[op.output("MomentOut")] = mom


@braw("lamb")
def _lamb_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    wd = op.attr("weight_decay", 0.01)
    m = _slot(op, scope, "Moment1", p)
    v = _slot(op, scope, "Moment2", p)
    b1p = _scalar_slot(op, scope, "Beta1Pow", b1)
    b2p = _scalar_slot(op, scope, "Beta2Pow", b2)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    scope[op.output("ParamOut")] = p - lr * trust * r
    scope[op.output("Moment1Out")] = m
    scope[op.output("Moment2Out")] = v
    if op.output("Beta1PowOut"):
        scope[op.output("Beta1PowOut")] = (b1p * b1).reshape(1)
    if op.output("Beta2PowOut"):
        scope[op.output("Beta2PowOut")] = (b2p * b2).reshape(1)


@braw("lars_momentum")
def _lars_momentum_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    mu = op.attr("mu", 0.9)
    coeff = op.attr("lars_coeff", 0.001)
    wd_list = op.attr("lars_weight_decay", [0.0005])
    wd = float(wd_list[0]) if isinstance(wd_list, (list, tuple)) else \
        float(wd_list)
    v = _slot(op, scope, "Velocity", p)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = lr * coeff * p_norm / (
        g_norm + wd * p_norm + op.attr("epsilon", 0.0) + 1e-30)
    v = mu * v + local_lr * (g + wd * p)
    scope[op.output("ParamOut")] = p - v
    scope[op.output("VelocityOut")] = v


@braw("ftrl")
def _ftrl_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    lr_power = op.attr("lr_power", -0.5)
    sq = _slot(op, scope, "SquaredAccumulator", p)
    lin = _slot(op, scope, "LinearAccumulator", p)
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    lin = lin + g - sigma * p
    quad = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    pre = torch.clamp(lin, -l1, l1) - lin
    scope[op.output("ParamOut")] = pre / quad
    scope[op.output("SquaredAccumOut")] = new_sq
    scope[op.output("LinearAccumOut")] = lin


@braw("dpsgd")
def _dpsgd_op(op, scope, feeds, fetches):
    # dpsgd_op.h: clip grad to clip-norm, add gaussian noise, then sgd
    p, g, lr = _opt_common(op, scope)
    clip = op.attr("clip", 10.0)
    sigma = op.attr("sigma", 1.0)
    gn = torch.sqrt(torch.sum(torch.square(g)))
    g = g * torch.clamp_max(clip / (gn + 1e-30), 1.0)
    noise = sigma * clip * torch.randn(g.shape, generator=_op_gen(op),
                                       device=g.device)
    bsz = op.attr("batch_size", 1.0) or 1.0
    scope[op.output("ParamOut")] = p - lr * (g + noise / bsz)


@braw("proximal_gd")
def _proximal_gd_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    prox = p - lr * g
    scope[op.output("ParamOut")] = torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)


@braw("average_accumulates")
def _average_accumulates_op(op, scope, feeds, fetches):
    # reference operators/average_accumulates_op.h window accounting
    p = scope.fetch(op.input("param"))
    s1 = _slot(op, scope, "in_sum_1", p)
    s2 = _slot(op, scope, "in_sum_2", p)
    s3 = _slot(op, scope, "in_sum_3", p)
    num_acc = _scalar_slot(op, scope, "in_num_accumulates", 0)
    old_num = _scalar_slot(op, scope, "in_old_num_accumulates", 0)
    num_upd = _scalar_slot(op, scope, "in_num_updates", 0)
    avg_window = op.attr("average_window", 0.0)
    max_avg = op.attr("max_average_window", 10000)
    min_avg = op.attr("min_average_window", 10000)
    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    window = torch.clamp_min(torch.clamp_max(avg_window * num_upd,
                                             float(max_avg)), min_avg)
    roll = num_acc >= window
    s3 = torch.where(roll, s1 + s2, s3)
    old_num = torch.where(roll, num_acc, old_num)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    scope[op.output("out_sum_1")] = s1
    scope[op.output("out_sum_2")] = s2
    scope[op.output("out_sum_3")] = s3
    scope[op.output("out_num_accumulates")] = num_acc.reshape(1).to(
        torch.int64)
    scope[op.output("out_old_num_accumulates")] = old_num.reshape(1).to(
        torch.int64)
    scope[op.output("out_num_updates")] = num_upd.reshape(1).to(
        torch.int64)


# ---------------------------------------------------------------------------
# AMP ops (reference operators/amp/*.cc)
# ---------------------------------------------------------------------------
@braw("check_finite_and_unscale")
def _check_finite_and_unscale_op(op, scope, feeds, fetches):
    inv = 1.0 / scope.fetch(op.input("Scale")).reshape(())
    found = torch.zeros((), dtype=torch.bool, device=_dev())
    for name, oname in zip(op.inputs("X"), op.outputs("Out")):
        x = scope.fetch(name)
        found = found | ~torch.all(torch.isfinite(x))
        scope[oname] = x.float() * inv
    scope[op.output("FoundInfinite")] = found.reshape(1)


@braw("update_loss_scaling")
def _update_loss_scaling_op(op, scope, feeds, fetches):
    found = scope.fetch(op.input("FoundInfinite")).reshape(()).bool()
    scale = scope.fetch(op.input("PrevLossScaling")).reshape(())
    good = _scalar_slot(op, scope, "InGoodSteps", 0)
    bad = _scalar_slot(op, scope, "InBadSteps", 0)
    incr_n = op.attr("incr_every_n_steps", 1000)
    decr_n = op.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = op.attr("incr_ratio", 2.0)
    decr_ratio = op.attr("decr_ratio", 0.5)
    zero = torch.zeros_like(bad)
    new_bad = torch.where(found, bad + 1, zero)
    new_good = torch.where(found, zero, good + 1)
    decr = new_bad >= decr_n
    incr = new_good >= incr_n
    new_scale = torch.where(decr, scale * decr_ratio,
                            torch.where(incr, scale * incr_ratio, scale))
    new_scale = torch.clamp_min(new_scale, 1e-9)
    new_bad = torch.where(decr, zero, new_bad)
    new_good = torch.where(incr, zero, new_good)
    if op.attr("stop_update", False):
        new_scale, new_good, new_bad = scale, good, bad
    scope[op.output("LossScaling")] = new_scale.reshape(1)
    scope[op.output("OutGoodSteps")] = new_good.reshape(1).to(torch.int32)
    scope[op.output("OutBadSteps")] = new_bad.reshape(1).to(torch.int32)
    # grads zeroed on overflow so the optimizer step is a no-op
    for name, oname in zip(op.inputs("X"), op.outputs("Out")):
        x = scope.fetch(name)
        scope[oname] = torch.where(found, torch.zeros_like(x), x)


# ---------------------------------------------------------------------------
# collective ops (reference operators/collective/*.cc) over
# torch.distributed groups.  ring_id -> group comes from
# `collective_axes(...)`; outside that context the program is treated as
# world-size-1 (identity semantics), as in the JAX package.
# ---------------------------------------------------------------------------
_COLL_TLS = threading.local()


@contextlib.contextmanager
def collective_axes(mapping=None, default=None):
    """Map ring_id -> a `torch.distributed` process group (None: the
    default group) for c_* ops interpreted inside; ``default`` applies
    to any unmapped ring.  The counterpart of the JAX package's mapping
    onto mesh axis names."""
    prev = getattr(_COLL_TLS, "cfg", None)
    _COLL_TLS.cfg = (dict(mapping or {}), default)
    try:
        yield
    finally:
        _COLL_TLS.cfg = prev


_NO_RING = object()


def _ring_group(op):
    cfg = getattr(_COLL_TLS, "cfg", None)
    if cfg is None:
        return _NO_RING
    mapping, default = cfg
    ring = op.attr("ring_id", 0)
    if ring not in mapping and default is None:
        return _NO_RING
    return mapping.get(ring, default)


def _group_arg(g):
    return None if g == "world" else g


def _coll(op, scope, fn_with_group, in_name="X", out_name="Out"):
    x = scope.fetch(op.input(in_name))
    g = _ring_group(op)
    scope[op.output(out_name)] = x if g is _NO_RING \
        else fn_with_group(x, _group_arg(g))


def _reduced(x, group, rop):
    import torch.distributed as dist

    y = x.clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, rop), group=group)
    return y


def _grank(group):
    import torch.distributed as dist

    return dist.get_rank(group=group)


def _gsize(group):
    import torch.distributed as dist

    return dist.get_world_size(group=group)


def _all_gather(x, group, axis):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(_gsize(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


@braw("c_allreduce_sum", "allreduce", "mp_allreduce_sum")
def _c_allreduce_sum_op(op, scope, feeds, fetches):
    _coll(op, scope, lambda x, g: _reduced(x, g, "SUM"))


@braw("c_allreduce_max")
def _c_allreduce_max_op(op, scope, feeds, fetches):
    _coll(op, scope, lambda x, g: _reduced(x, g, "MAX"))


@braw("c_allreduce_min")
def _c_allreduce_min_op(op, scope, feeds, fetches):
    _coll(op, scope, lambda x, g: _reduced(x, g, "MIN"))


@braw("c_allreduce_prod")
def _c_allreduce_prod_op(op, scope, feeds, fetches):
    _coll(op, scope, lambda x, g: _reduced(x, g, "PRODUCT"))


@braw("c_reduce_sum", "c_reduce_max", "c_reduce_min", "c_reduce_prod")
def _c_reduce_op(op, scope, feeds, fetches):
    # SPMD stance: reduce == allreduce (every rank holds the root value)
    kind = {"sum": "SUM", "max": "MAX", "min": "MIN",
            "prod": "PRODUCT"}[op.type.rsplit("_", 1)[1]]
    _coll(op, scope, lambda x, g: _reduced(x, g, kind))


@braw("c_broadcast", "broadcast")
def _c_broadcast_op(op, scope, feeds, fetches):
    root = op.attr("root", op.attr("root_id", 0))

    def bcast(x, g):
        keep = x if _grank(g) == root else torch.zeros_like(x)
        return _reduced(keep, g, "SUM")

    _coll(op, scope, bcast)


@braw("c_identity")
def _c_identity_op(op, scope, feeds, fetches):
    scope[op.output("Out")] = scope.fetch(op.input("X"))


@braw("c_allgather")
def _c_allgather_op(op, scope, feeds, fetches):
    _coll(op, scope, lambda x, g: _all_gather(x, g, 0))


@braw("c_reducescatter")
def _c_reducescatter_op(op, scope, feeds, fetches):
    def rs(x, g):
        full = _reduced(x, g, "SUM")
        rows = x.shape[0] // _gsize(g)
        return full[_grank(g) * rows:(_grank(g) + 1) * rows]

    _coll(op, scope, rs)


@braw("c_concat")
def _c_concat_op(op, scope, feeds, fetches):
    # mp gather along the LAST axis (c_concat_op.cc)
    _coll(op, scope, lambda x, g: _all_gather(x, g, x.ndim - 1))


@braw("c_split")
def _c_split_op(op, scope, feeds, fetches):
    nranks = op.attr("nranks", 1)

    def split(x, g):
        w = x.shape[-1] // nranks
        return x[..., _grank(g) * w:(_grank(g) + 1) * w]

    _coll(op, scope, split)


@braw("c_scatter")
def _c_scatter_op(op, scope, feeds, fetches):
    nranks = op.attr("nranks", 1)

    def scatter(x, g):
        rows = x.shape[0] // nranks
        return x[_grank(g) * rows:(_grank(g) + 1) * rows]

    _coll(op, scope, scatter)


@braw("c_embedding")
def _c_embedding_op(op, scope, feeds, fetches):
    # vocab-parallel embedding (c_embedding_op.cc): rows outside this
    # shard contribute zeros; a sum over the group combines shards
    w = scope.fetch(op.input("W"))
    ids = scope.fetch(op.input("Ids")).long()
    local = ids - op.attr("start_index", 0)
    in_range = (local >= 0) & (local < w.shape[0])
    emb = w[torch.clamp(local, 0, w.shape[0] - 1)]
    emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
    g = _ring_group(op)
    if g is not _NO_RING:
        emb = _reduced(emb, _group_arg(g), "SUM")
    scope[op.output("Out")] = emb


@braw("c_softmax_with_cross_entropy")
def _c_softmax_ce_op(op, scope, feeds, fetches):
    # vocab-parallel CE (c_softmax_with_cross_entropy_op.cc)
    logits = scope.fetch(op.input("Logits"))
    label = scope.fetch(op.input("Label")).long()
    g = _ring_group(op)
    if g is _NO_RING:
        lse = torch.logsumexp(logits, -1, keepdim=True)
        soft = torch.exp(logits - lse)
        picked = torch.gather(logits, -1, label.reshape(label.shape[0], 1))
        loss = lse.reshape(label.shape[0], 1) - picked
    else:
        g = _group_arg(g)
        vocab_local = logits.shape[-1]
        start = _grank(g) * vocab_local
        gmax = _reduced(torch.amax(logits, -1, keepdim=True), g, "MAX")
        ex = torch.exp(logits - gmax)
        denom = _reduced(torch.sum(ex, -1, keepdim=True), g, "SUM")
        soft = ex / denom
        local = label.reshape(-1, 1) - start
        owned = (local >= 0) & (local < vocab_local)
        picked = torch.gather(logits, -1,
                              torch.clamp(local, 0, vocab_local - 1))
        picked = _reduced(torch.where(owned, picked,
                                      torch.zeros_like(picked)), g, "SUM")
        loss = torch.log(denom) + gmax - picked
    scope[op.output("Softmax")] = soft
    scope[op.output("Loss")] = loss


@braw("alltoall")
def _alltoall_op(op, scope, feeds, fetches):
    def a2a(x, g):
        import torch.distributed as dist

        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=g)
        return out

    _coll(op, scope, a2a)


@braw("barrier")
def _barrier_op(op, scope, feeds, fetches):
    # the identity on its token input
    if op.input("X") and op.output("Out"):
        scope[op.output("Out")] = scope.fetch(op.input("X"))


# ---------------------------------------------------------------------------
# fleet-inserted bootstrap/sync ops: consumed in program form so a real
# fleet output loads — no-op / identity-alias semantics
# ---------------------------------------------------------------------------
@braw("c_gen_nccl_id", "c_gen_bkcl_id", "c_gen_hccl_id")
def _c_gen_comm_id_op(op, scope, feeds, fetches):
    # the process group's store is the rendezvous; the id is a token
    scope[op.output("Out")] = torch.zeros((1,), dtype=torch.int32,
                                          device=_dev())


@braw("gen_nccl_id", "gen_bkcl_id", "gen_hccl_id")
def _gen_comm_id_op(op, scope, feeds, fetches):
    for slot in ("NCCLID", "Out"):
        if op.output(slot):
            scope[op.output(slot)] = torch.zeros((1,), dtype=torch.int32,
                                                 device=_dev())


@braw("c_comm_init", "c_comm_init_all", "c_comm_init_hccl",
      "c_comm_init_multitrainer", "comm_init")
def _c_comm_init_op(op, scope, feeds, fetches):
    # groups are bound by `collective_axes(...)` instead
    return


@braw("c_sync_comm_stream", "c_sync_calc_stream", "c_wait_comm",
      "c_wait_compute")
def _c_stream_sync_op(op, scope, feeds, fetches):
    # stream fences: alias every X -> Out pair, copying the RAW scope
    # entry so a coalesced component stays a live FusedSlice view
    for x_name, out_name in zip(op.inputs("X"), op.outputs("Out")):
        if out_name != x_name and x_name in scope:
            scope[out_name] = dict.__getitem__(scope, x_name)


@braw("marker")
def _marker_op(op, scope, feeds, fetches):
    return


def _partial_cols(op, scope):
    # partial_concat/partial_sum (operators/partial_concat_op.h)
    xs = [scope.fetch(n) for n in op.inputs("X")]
    start = int(op.attr("start_index", 0))
    length = int(op.attr("length", -1))
    size = xs[0].shape[1]
    if start < 0:
        start += size
    stop = size if length < 0 else start + length
    return [x[:, start:stop] for x in xs]


@braw("partial_concat")
def _partial_concat_op(op, scope, feeds, fetches):
    scope[op.output("Out")] = torch.cat(_partial_cols(op, scope), dim=1)


@braw("partial_sum")
def _partial_sum_op(op, scope, feeds, fetches):
    cols = _partial_cols(op, scope)
    out = cols[0]
    for c in cols[1:]:
        out = out + c
    scope[op.output("Out")] = out


@braw("coalesce_tensor")
def _coalesce_tensor_op(op, scope, feeds, fetches):
    """reference `operators/coalesce_tensor_op.cc`: pack Input tensors
    into one contiguous FusedOutput whose sub-ranges ALIAS the Output
    vars (`FusedSlice` views resolve against the CURRENT fused
    buffer)."""
    from .interp import FusedSlice, _current_blocks

    in_names = op.inputs("Input")
    out_names = op.outputs("Output")
    fused_name = op.output("FusedOutput")
    dtype = _dt(op.attr("dtype", 5))
    copy_data = op.attr("copy_data", True) and \
        not op.attr("set_constant", False)

    def shape_of(name):
        if name in scope:
            return tuple(scope[name].shape)
        for blk in _current_blocks():
            for v in blk.get("vars", []):
                if v.get("name") == name:
                    dims = (v.get("type", {}).get("lod_tensor", {})
                            .get("tensor", {}).get("dims", []))
                    if dims and all(int(d) >= 0 for d in dims):
                        return tuple(int(d) for d in dims)
        raise KeyError(
            f"coalesce_tensor: component {name!r} has neither a scope "
            "value nor a statically-shaped var desc to size the fused "
            "buffer from")

    shapes = [shape_of(n) for n in in_names]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    if copy_data:
        flat = torch.cat([scope.fetch(n).reshape(-1).to(dtype)
                          for n in in_names]) if in_names else \
            torch.zeros((0,), dtype=dtype, device=_dev())
    else:
        const = float(op.attr("constant", 0.0)) \
            if op.attr("set_constant", False) else 0.0
        flat = torch.full((sum(sizes),), const, dtype=dtype, device=_dev())
    scope[fused_name] = flat
    offset = 0
    for out_name, shp, n in zip(out_names, shapes, sizes):
        dict.__setitem__(scope, out_name,
                         FusedSlice(fused_name, offset, shp))
        offset += n


# ---------------------------------------------------------------------------
# fake-quant family (reference operators/fake_quantize_op.cc /
# fake_dequantize_op.cc)
# ---------------------------------------------------------------------------
def _qmax(bit_length):
    return float((1 << (int(bit_length) - 1)) - 1)


@braw("fake_quantize_abs_max")
def _fake_q_abs_max(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    qm = _qmax(op.attr("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    scope[op.output("Out")] = torch.round(x / scale * qm)
    scope[op.output("OutScale")] = scale.reshape(1)


@braw("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    qm = _qmax(op.attr("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    scope[op.output("Out")] = torch.round(x / scale * qm) * scale / qm
    scope[op.output("OutScale")] = scale.reshape(1)


@braw("fake_channel_wise_quantize_abs_max",
      "fake_channel_wise_quantize_dequantize_abs_max")
def _fake_cw_q(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    qm = _qmax(op.attr("bit_length", 8))
    axis = op.attr("quant_axis", 0)
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True)
    q = torch.round(x / scale * qm)
    if "dequantize" in op.type:
        q = q * scale / qm
    scope[op.output("Out")] = q
    scope[op.output("OutScale")] = scale.reshape(-1)


@braw("fake_quantize_range_abs_max")
def _fake_q_range(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    qm = _qmax(op.attr("bit_length", 8))
    in_scale = scope.fetch(op.input("InScale")).reshape(())
    cur = torch.amax(torch.abs(x))
    scale = in_scale if op.attr("is_test", False) else \
        torch.maximum(cur, in_scale)
    scope[op.output("Out")] = torch.round(
        torch.clamp(x, -scale, scale) / scale * qm)
    scope[op.output("OutScale")] = scale.reshape(1)
    if op.output("OutScales"):
        scope[op.output("OutScales")] = scale.reshape(1)


@braw("fake_quantize_moving_average_abs_max",
      "fake_quantize_dequantize_moving_average_abs_max")
def _fake_q_moving(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    qm = _qmax(op.attr("bit_length", 8))
    rate = op.attr("moving_rate", 0.9)
    state = _scalar_slot(op, scope, "InState", 1.0)
    accum = _scalar_slot(op, scope, "InAccum", 0.0)
    if op.attr("is_test", False):
        scale = scope.fetch(op.input("InScale")).reshape(())
    else:
        state = rate * state + 1.0
        accum = rate * accum + torch.amax(torch.abs(x))
        scale = accum / state
        if op.output("OutState"):
            scope[op.output("OutState")] = state.reshape(1)
        if op.output("OutAccum"):
            scope[op.output("OutAccum")] = accum.reshape(1)
    q = torch.round(torch.clamp(x, -scale, scale) / scale * qm)
    if "dequantize" in op.type:
        q = q * scale / qm
    scope[op.output("Out")] = q
    if op.output("OutScale"):
        scope[op.output("OutScale")] = scale.reshape(1)


@braw("fake_dequantize_max_abs")
def _fake_dq_max_abs(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    scale = scope.fetch(op.input("Scale")).reshape(())
    scope[op.output("Out")] = x.float() * scale / op.attr("max_range",
                                                          127.0)


@braw("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dq(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X")).float()
    scales = [scope.fetch(n) for n in op.inputs("Scales")]
    qsteps = op.attr("quant_bits", [8, 8])
    axis = op.attr("quant_axis", 0)
    s0 = scales[0].reshape([-1 if i == axis else 1 for i in range(x.ndim)])
    out = x * s0 / _qmax(qsteps[0])
    if len(scales) > 1:
        out = out * scales[1].reshape(()) / _qmax(
            qsteps[1] if len(qsteps) > 1 else 8)
    scope[op.output("Out")] = out


@braw("fake_init")
def _fake_init_op(op, scope, feeds, fetches):
    shape = [int(s) for s in op.attr("shape", [])]
    scope[op.output("Out")] = torch.zeros(
        shape, dtype=_dt(op.attr("dtype", 5)), device=_dev())


# ---------------------------------------------------------------------------
# metric / misc / host ops
# ---------------------------------------------------------------------------
def _slot_vec(op, scope, name, n):
    vname = op.input(name)
    if vname and vname in scope:
        return scope[vname].reshape(-1).float()[:n]
    return torch.zeros((n,), dtype=torch.float32, device=_dev())


@braw("auc")
def _auc_op(op, scope, feeds, fetches):
    # reference operators/metrics/auc_op.h: histogram accumulation over
    # num_thresholds buckets + trapezoid area
    pred = scope.fetch(op.input("Predict"))
    label = scope.fetch(op.input("Label")).reshape(-1).long()
    n_th = op.attr("num_thresholds", 4095)
    pos_in = _slot_vec(op, scope, "StatPos", n_th + 1)
    neg_in = _slot_vec(op, scope, "StatNeg", n_th + 1)
    p1 = pred[:, -1] if pred.ndim == 2 else pred.reshape(-1)
    idx = torch.clamp((p1 * n_th).to(torch.int32), 0, n_th).long()
    one = torch.ones_like(p1, dtype=torch.float32)
    pos = pos_in.index_add(0, idx, torch.where(label > 0, one, 0 * one))
    neg = neg_in.index_add(0, idx, torch.where(label > 0, 0 * one, one))
    tp = torch.cumsum(torch.flip(pos, [0]), 0)
    fp = torch.cumsum(torch.flip(neg, [0]), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    z = torch.zeros((1,), dtype=tp.dtype, device=tp.device)
    tp0 = torch.cat([z, tp[:-1]])
    fp0 = torch.cat([z, fp[:-1]])
    area = torch.sum((fp - fp0) * (tp + tp0) / 2.0)
    auc = torch.where((tot_pos > 0) & (tot_neg > 0),
                      area / torch.clamp_min(tot_pos * tot_neg, 1.0),
                      torch.zeros_like(area))
    scope[op.output("AUC")] = auc.reshape(())
    if op.output("StatPosOut"):
        scope[op.output("StatPosOut")] = pos.to(torch.int64)
    if op.output("StatNegOut"):
        scope[op.output("StatNegOut")] = neg.to(torch.int64)


@braw("precision_recall")
def _precision_recall_op(op, scope, feeds, fetches):
    # reference operators/metrics/precision_recall_op.h
    idx = scope.fetch(op.input("Indices")).reshape(-1).long()
    label = scope.fetch(op.input("Labels")).reshape(-1).long()
    c = op.attr("class_number", 2)
    states_in = op.input("StatesInfo")
    st = scope[states_in].float() if states_in and \
        states_in in scope else torch.zeros((c, 4), device=_dev())
    onehot_p = TF.one_hot(idx, c).float()
    onehot_l = TF.one_hot(label, c).float()
    tp = torch.sum(onehot_p * onehot_l, 0)
    fp = torch.sum(onehot_p * (1 - onehot_l), 0)
    fn = torch.sum((1 - onehot_p) * onehot_l, 0)
    tn = idx.shape[0] - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], 1)
    acc = st + batch

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp_min(den, 1),
                           torch.zeros_like(num))

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r /
                           torch.clamp_min(p + r, 1e-12),
                           torch.zeros_like(p))

    def metrics(m):
        tp_, fp_, fn_ = m[:, 0], m[:, 1], m[:, 3]
        prec = ratio(tp_, tp_ + fp_)
        rec = ratio(tp_, tp_ + fn_)
        macro = torch.stack([prec.mean(), rec.mean(), f1(prec, rec).mean()])
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mprec = ratio(stp, stp + sfp)
        mrec = ratio(stp, stp + sfn)
        return torch.cat([macro, torch.stack([mprec, mrec,
                                              f1(mprec, mrec)])])

    scope[op.output("BatchMetrics")] = metrics(batch)
    scope[op.output("AccumMetrics")] = metrics(acc)
    scope[op.output("AccumStatesInfo")] = acc


@braw("print")
def _print_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("In"))
    print(op.attr("message", "") + " " + str(_host_read(x, "a print op's "
                                                         "input")))
    if op.output("Out"):
        scope[op.output("Out")] = x


@braw("assert")
def _assert_op(op, scope, feeds, fetches):
    cond = _host_read(scope.fetch(op.input("Cond")), "an assert condition")
    if not bool(torch.all(cond)):
        raise AssertionError("Assert op failed")


@braw("bicubic_interp", "bicubic_interp_v2", "linear_interp",
      "linear_interp_v2", "trilinear_interp", "trilinear_interp_v2")
def _interp_extra_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    kind = op.type.split("_")[0]
    if kind == "linear":  # [N, C, W]
        out_w = op.attr("out_w", -1)
        if out_w <= 0:
            sc = op.attr("scale", [])
            sc = sc[0] if isinstance(sc, (list, tuple)) and sc else sc
            out_w = int(x.shape[2] * float(sc))
        shape = tuple(x.shape[:2]) + (out_w,)
        method = "linear"
    elif kind == "bicubic":
        out_h, out_w = op.attr("out_h", -1), op.attr("out_w", -1)
        if out_h <= 0 or out_w <= 0:
            sc = op.attr("scale", [])
            if isinstance(sc, (int, float)):
                sc = [sc, sc]
            out_h = int(x.shape[2] * sc[0])
            out_w = int(x.shape[3] * sc[1])
        shape = tuple(x.shape[:2]) + (out_h, out_w)
        method = "cubic"
    else:  # trilinear [N, C, D, H, W]
        out_d = op.attr("out_d", -1)
        out_h = op.attr("out_h", -1)
        out_w = op.attr("out_w", -1)
        if out_d <= 0:
            sc = op.attr("scale", [])
            if isinstance(sc, (int, float)):
                sc = [sc] * 3
            out_d = int(x.shape[2] * sc[0])
            out_h = int(x.shape[3] * sc[1])
            out_w = int(x.shape[4] * sc[2])
        shape = tuple(x.shape[:2]) + (out_d, out_h, out_w)
        method = "linear"
    scope[op.output("Out")] = jax_resize(x, shape, method).to(x.dtype)


@braw("affine_grid")
def _affine_grid_op(op, scope, feeds, fetches):
    theta = scope.fetch(op.input("Theta"))
    shape_in = op.input("OutputShape")
    if shape_in:
        out_shape = [int(v) for v in _host_read(
            scope.fetch(shape_in), "affine_grid's output shape").tolist()]
    else:
        out_shape = [int(v) for v in op.attr("output_shape", [])]
    scope[op.output("Output")] = _F().affine_grid(
        theta, out_shape, align_corners=op.attr("align_corners", True))


@braw("diag")
def _diag_v1_op(op, scope, feeds, fetches):
    # fluid v1 diag: vector -> square diagonal matrix (diag_op.cc)
    scope[op.output("Out")] = torch.diag(
        scope.fetch(op.input("Diagonal")).reshape(-1))


@braw("gru_unit")
def _gru_unit_op(op, scope, feeds, fetches):
    # single GRU step (operators/gru_unit_op.h)
    x = scope.fetch(op.input("Input"))
    hp = scope.fetch(op.input("HiddenPrev"))
    w = scope.fetch(op.input("Weight"))
    d = hp.shape[-1]
    if op.input("Bias"):
        x = x + scope.fetch(op.input("Bias")).reshape(1, -1)
    gates = x[:, :2 * d] + hp @ w[:, :2 * d]
    u = torch.sigmoid(gates[:, :d])
    rst = torch.sigmoid(gates[:, d:])
    c = torch.tanh(x[:, 2 * d:] + (rst * hp) @ w[:, 2 * d:])
    if op.attr("origin_mode", False):
        h = u * hp + (1 - u) * c
    else:
        h = (1 - u) * hp + u * c
    scope[op.output("Hidden")] = h
    if op.output("Gate"):
        scope[op.output("Gate")] = torch.cat([u, rst, c], -1)
    if op.output("ResetHiddenPrev"):
        scope[op.output("ResetHiddenPrev")] = rst * hp


@braw("lstm_unit")
def _lstm_unit_op(op, scope, feeds, fetches):
    # single LSTM step (operators/lstm_unit_op.h): X [B, 4D] {i,g,f,o}
    x = scope.fetch(op.input("X"))
    c_prev = scope.fetch(op.input("C_prev"))
    d = c_prev.shape[-1]
    fb = op.attr("forget_bias", 0.0)
    i = torch.sigmoid(x[:, :d])
    g = torch.tanh(x[:, d:2 * d])
    f = torch.sigmoid(x[:, 2 * d:3 * d] + fb)
    o = torch.sigmoid(x[:, 3 * d:])
    c = f * c_prev + i * g
    scope[op.output("C")] = c
    scope[op.output("H")] = o * torch.tanh(c)


@braw("random_crop")
def _random_crop_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    shape = [int(s) for s in op.attr("shape", [])]
    gen = _op_gen(op, op.attr("startup_seed", 0))
    full = list(x.shape)
    tgt = full[:len(full) - len(shape)] + shape
    starts = [int(torch.randint(0, fs - ts + 1, (), generator=gen,
                                device=_dev())) if fs > ts else 0
              for fs, ts in zip(full, tgt)]
    scope[op.output("Out")] = _dynamic_slice(x, starts, tgt)
    if op.output("SeedOut"):
        scope[op.output("SeedOut")] = torch.tensor(
            [op.attr("startup_seed", 0)], dtype=torch.int64, device=_dev())


# ---------------------------------------------------------------------------
# ops with NO program-form translation, each with the reason and the
# API that delivers the capability instead (the JAX package's table)
# ---------------------------------------------------------------------------
PROGRAM_FORM_NA = {
    "listen_and_serv": "distributed.ps.PSServer",
    "heter_listen_and_serv": "distributed.ps.HeterServer",
    "send": "distributed.ps.Communicator",
    "send_and_recv": "distributed.ps.Communicator",
    "send_barrier": "distributed.ps.PSClient.barrier",
    "fetch_barrier": "distributed.ps.PSClient.barrier",
    "distributed_lookup_table": "distributed.ps.PSClient.pull_sparse",
    "pull_sparse": "distributed.ps.PSClient.pull_sparse",
    "pull_sparse_v2": "distributed.ps.PSClient.pull_sparse",
    "push_sparse": "distributed.ps.PSClient.push_sparse_grad",
    "push_sparse_v2": "distributed.ps.PSClient.push_sparse_grad",
    "pull_box_sparse": "distributed.ps.PSClient.pull_sparse",
    "pull_box_extended_sparse": "distributed.ps.PSClient.pull_sparse",
    "push_box_sparse": "distributed.ps.PSClient.push_sparse_grad",
    "push_box_extended_sparse":
        "distributed.ps.PSClient.push_sparse_grad",
    "push_dense": "distributed.ps.PSClient.push_dense_grad",
    "py_layer": "autograd.PyLayer (eager)",
    "run_program": "jit.StaticFunction",
}


# ---------------------------------------------------------------------------
# persistence ops — REAL file IO in the reference LoDTensor wire format
# (operators/save_op.cc, load_op.cc, save_combine_op.cc, load_combine_op.cc)
# ---------------------------------------------------------------------------
def _np_of(t):
    return _host_read(t, "a tensor to save").detach().cpu().numpy()


@braw("save")
def _save_op(op, scope, feeds, fetches):
    from .proto import write_lod_tensor

    path = op.attr("file_path", "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(write_lod_tensor(_np_of(scope.fetch(op.input("X")))))


@braw("load")
def _load_op(op, scope, feeds, fetches):
    from .proto import read_lod_tensor

    with open(op.attr("file_path", ""), "rb") as f:
        data = f.read()
    arr, _lod, _pos = read_lod_tensor(data, 0)
    scope[op.output("Out")] = _tensor(arr)


@braw("save_combine")
def _save_combine_op(op, scope, feeds, fetches):
    from .proto import write_lod_tensor

    path = op.attr("file_path", "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        for name in op.inputs("X"):
            f.write(write_lod_tensor(_np_of(scope.fetch(name))))


@braw("load_combine")
def _load_combine_op(op, scope, feeds, fetches):
    from .proto import read_lod_tensor

    with open(op.attr("file_path", ""), "rb") as f:
        data = f.read()
    pos = 0
    for name in op.outputs("Out"):
        arr, _lod, pos = read_lod_tensor(data, pos)
        scope[name] = _tensor(arr)


# ---------------------------------------------------------------------------
# DGC family (operators/dgc_op.h, dgc_momentum_op.h,
# dgc_clip_by_norm_op.h): the numerics of gradient top-k compression
# ---------------------------------------------------------------------------
@braw("dgc_clip_by_norm")
def _dgc_clip_by_norm_op(op, scope, feeds, fetches):
    x = scope.fetch(op.input("X"))
    step = scope.fetch(op.input("current_step")).reshape(())
    max_norm = op.attr("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    clipped = torch.where(norm > max_norm, x * (max_norm / norm), x)
    scope[op.output("Out")] = torch.where(
        step < op.attr("rampup_begin_step", 0.0), x, clipped)


@braw("dgc_momentum")
def _dgc_momentum_op(op, scope, feeds, fetches):
    p, g, lr = _opt_common(op, scope)
    step = scope.fetch(op.input("current_step")).reshape(())
    mu = op.attr("mu", 0.9)
    v = _slot(op, scope, "Velocity", p)
    v_new = mu * v + g
    p_mom = p - lr * (g + mu * v_new) if op.attr("use_nesterov", False) \
        else p - lr * v_new
    use_mom = step >= op.attr("rampup_begin_step", 0.0)
    scope[op.output("ParamOut")] = torch.where(use_mom, p_mom, p - lr * g)
    scope[op.output("VelocityOut")] = torch.where(use_mom, v_new, v)


@braw("dgc")
def _dgc_op(op, scope, feeds, fetches):
    # top-k sparsification with momentum correction (dgc_op.h); k uses
    # the FINAL sparsity ratio, as in the JAX package
    g = scope.fetch(op.input("Grad"))
    u = _slot(op, scope, "U", g)
    v = _slot(op, scope, "V", g)
    m = op.attr("m", 0.9)
    ratios = op.attr("sparsity", [0.999])
    ratio = float(ratios[-1]) if ratios else 0.999
    k = max(1, int(round(g.numel() * (1.0 - ratio))))
    u = m * u + g
    v = v + u
    thresh = torch.topk(torch.abs(v.reshape(-1)), k).values[-1]
    mask = torch.abs(v) >= thresh
    zero = torch.zeros_like(v)
    encode = torch.where(mask, v, zero)
    scope[op.output("U_out")] = torch.where(mask, zero, u)
    scope[op.output("V_out")] = torch.where(mask, zero, v)
    scope[op.output("EncodeGrad")] = encode
    for slot in ("Grad_out", "GatherBuff"):
        if op.output(slot):
            scope[op.output(slot)] = encode


@braw("positive_negative_pair")
def _positive_negative_pair_op(op, scope, feeds, fetches):
    # metrics/positive_negative_pair_op.h: per-query ordered-pair counts
    score = scope.fetch(op.input("Score")).reshape(-1)
    label = scope.fetch(op.input("Label")).reshape(-1)
    qid = scope.fetch(op.input("QueryID")).reshape(-1)
    same_q = qid[:, None] == qid[None, :]
    upper = torch.triu(torch.ones_like(same_q, dtype=torch.int32), 1)
    pair = same_q & (upper > 0) & (label[:, None] != label[None, :])
    hi_label = label[:, None] > label[None, :]
    hi_score = score[:, None] > score[None, :]
    eq_score = score[:, None] == score[None, :]
    pos = torch.sum(pair & (hi_label == hi_score) & ~eq_score)
    neu = torch.sum(pair & eq_score)
    neg = torch.sum(pair) - pos - neu

    def acc(name, val):
        prev_in = op.input("Acc" + name)
        prev = scope[prev_in].reshape(()) if prev_in and \
            prev_in in scope else 0.0
        scope[op.output(name)] = (prev + val).reshape(1).float()

    acc("PositivePair", pos)
    acc("NegativePair", neg)
    acc("NeutralPair", neu)


DYNAMIC_SHAPE_OPS.update(("save", "load", "save_combine", "load_combine",
                          "dgc"))


# ---------------------------------------------------------------------------
# chunk_eval / detection_map: host counting (the reference kernels are
# CPU-side too); read on the host, so the program runs op by op
# ---------------------------------------------------------------------------
def _chunk_counts(inf, lab, lengths, scheme, num_chunk_types, excluded):
    from ..metric import extract_chunk_spans

    if inf.ndim == 1:
        inf, lab = inf[None], lab[None]
    n_inf = n_lab = n_cor = 0
    for row in range(inf.shape[0]):
        ln = int(lengths[row]) if lengths is not None else inf.shape[1]
        ci = extract_chunk_spans(inf[row, :ln], scheme, num_chunk_types,
                                 excluded)
        cl = extract_chunk_spans(lab[row, :ln], scheme, num_chunk_types,
                                 excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(set(ci) & set(cl))
    return n_inf, n_lab, n_cor


@braw("chunk_eval")
def _chunk_eval_op(op, scope, feeds, fetches):
    inf = _host_read(scope.fetch(op.input("Inference")), "chunk_eval's "
                     "inputs").cpu().numpy()
    lab = scope.fetch(op.input("Label")).cpu().numpy()
    seq_in = op.input("SeqLength")
    lengths = scope.fetch(seq_in).reshape(-1).cpu().numpy() \
        if seq_in else None
    counts = _chunk_counts(
        inf, lab, lengths, op.attr("chunk_scheme", "IOB"),
        int(op.attr("num_chunk_types", 1)),
        set(int(e) for e in op.attr("excluded_chunk_types", [])))
    n_inf, n_lab, n_cor = (torch.tensor([c], dtype=torch.int32,
                                        device=_dev()) for c in counts)
    fi, fl, fc = n_inf.float(), n_lab.float(), n_cor.float()
    zero = torch.zeros_like(fi)
    p = torch.where(fi > 0, fc / torch.clamp_min(fi, 1), zero)
    r = torch.where(fl > 0, fc / torch.clamp_min(fl, 1), zero)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp_min(p + r, 1e-12),
                     zero)
    scope[op.output("Precision")] = p
    scope[op.output("Recall")] = r
    scope[op.output("F1-Score")] = f1
    for slot, v in (("NumInferChunks", n_inf), ("NumLabelChunks", n_lab),
                    ("NumCorrectChunks", n_cor)):
        if op.output(slot):
            scope[op.output(slot)] = v.to(torch.int64)


@braw("detection_map")
def _detection_map_op(op, scope, feeds, fetches):
    """operators/detection/detection_map_op.cc on the padded+lengths
    representation, with the JAX package's fixed-capacity state buffers;
    matching and AP on the host."""
    from .interp import _seq_lengths_or_full
    from ..metric import detection_map_update

    dname, lname = op.input("DetectRes"), op.input("Label")
    det = _host_read(scope.fetch(dname), "detection_map's inputs")
    gt = scope.fetch(lname)
    det_lens = _seq_lengths_or_full(scope, dname, det)
    gt_lens = _seq_lengths_or_full(scope, lname, gt)
    C = int(op.attr("class_num", 1))
    cap = int(op.attr("state_capacity", 1024))

    def state(name, shape, dtype):
        vname = op.input(name)
        if vname and vname in scope:
            return scope[vname].cpu().numpy().astype(dtype).reshape(shape)
        return np.zeros(shape, dtype)

    out = detection_map_update(
        det.cpu().numpy(), det_lens.cpu().numpy(), gt.cpu().numpy(),
        gt_lens.cpu().numpy(), state("PosCount", (C,), np.int32),
        state("TruePos", (C, cap, 2), np.float32),
        state("TruePosCount", (C,), np.int32),
        state("FalsePos", (C, cap, 2), np.float32),
        state("FalsePosCount", (C,), np.int32), C,
        overlap_threshold=op.attr("overlap_threshold", 0.5),
        ap_type=op.attr("ap_type", "11point"),
        evaluate_difficult=op.attr("evaluate_difficult", True))
    pc, tpb, tcn, fpb, fcn, m_ap = (
        _tensor(np.asarray(v).astype(d)) for v, d in zip(
            out, (np.int32, np.float32, np.int32, np.float32, np.int32,
                  np.float32)))
    scope[op.output("MAP")] = m_ap.reshape(1)
    if op.output("AccumPosCount"):
        scope[op.output("AccumPosCount")] = pc
    if op.output("AccumTruePos"):
        scope[op.output("AccumTruePos")] = tpb
        if op.output("AccumTruePosCount"):
            scope[op.output("AccumTruePosCount")] = tcn
    if op.output("AccumFalsePos"):
        scope[op.output("AccumFalsePos")] = fpb
        if op.output("AccumFalsePosCount"):
            scope[op.output("AccumFalsePosCount")] = fcn


# ---------------------------------------------------------------------------
# host IO ops (operators/read_file_op.cc, decode_jpeg_op.cc)
# ---------------------------------------------------------------------------
@braw("read_file")
def _read_file_op(op, scope, feeds, fetches):
    from ..vision.transforms import read_file

    scope[op.output("Out")] = read_file(op.attr("filename", ""))


@braw("decode_jpeg")
def _decode_jpeg_op(op, scope, feeds, fetches):
    from ..vision.transforms import decode_jpeg

    scope[op.output("Out")] = decode_jpeg(
        scope.fetch(op.input("X")), mode=op.attr("mode", "unchanged"))


# ---------------------------------------------------------------------------
# py_func (operators/py_func_op.cc): a PROCESS-LOCAL registry index in
# `forward_callable_id`, as in the reference
# ---------------------------------------------------------------------------
PY_FUNC_REGISTRY: list = []


def register_py_func(fn) -> int:
    """Register a python callable for `py_func` ops; returns the id the
    op's `forward_callable_id` attr must carry."""
    PY_FUNC_REGISTRY.append(fn)
    return len(PY_FUNC_REGISTRY) - 1


@braw("py_func")
def _py_func_op(op, scope, feeds, fetches):
    cid = op.attr("forward_callable_id", -1)
    if not 0 <= cid < len(PY_FUNC_REGISTRY):
        raise NotImplementedError(
            f"py_func: forward_callable_id={cid} is not registered in "
            "this process (the registry is process-local, as in the "
            "reference py_func_op.cc); rebuild the program with "
            "op_bridge.register_py_func in this interpreter")
    fn = PY_FUNC_REGISTRY[cid]
    ins = [_np_of(scope.fetch(n)) for n in op.inputs("X")]
    outs = op.outputs("Out")
    res = fn(*ins)
    res = res if isinstance(res, (tuple, list)) else (res,)
    if len(res) != len(outs):
        raise ValueError(
            f"py_func callable returned {len(res)} values but the op "
            f"declares {len(outs)} outputs {outs}")
    for name, v in zip(outs, res):
        scope[name] = _tensor(np.asarray(v))


DYNAMIC_SHAPE_OPS.update(("read_file", "decode_jpeg", "py_func"))


# paddle-2.x scalar ops the exporter can emit
b("log1p", lambda x: torch.log1p(_fl(x)))
b("isfinite isfinite_v2", lambda x: torch.isfinite(x))


# ---------------------------------------------------------------------------
# cudnn_lstm (operators/cudnn_lstm_op.cc): the flat packed weight W in
# cuDNN's canonical order, unpacked into the unified rnn op's WeightList
# and delegated to the `rnn` translator
# ---------------------------------------------------------------------------
@braw("cudnn_lstm")
def _cudnn_lstm_op(op, scope, feeds, fetches):
    from .interp import OpView
    from .proto import AttrType as _AT

    x = scope.fetch(op.input("Input"))
    w = scope.fetch(op.input("W")).reshape(-1)
    hidden = int(op.attr("hidden_size", 0))
    layers = int(op.attr("num_layers", 1))
    ndir = 2 if bool(op.attr("is_bidirec", False)) else 1
    t_len, bsz, in_sz = x.shape

    expected = 0
    for layer in range(layers):
        isz = in_sz if layer == 0 else hidden * ndir
        expected += (isz * hidden + hidden * hidden) * 4 * ndir
        expected += hidden * 8 * ndir
    if int(w.shape[0]) != expected:
        raise ValueError(
            f"cudnn_lstm: flat weight has {w.shape[0]} elements, the "
            f"layout for hidden={hidden} layers={layers} ndir={ndir} "
            f"input={in_sz} needs {expected}")

    uid = f"__cudnn_lstm_{op.output('Out')}"
    wnames, bnames = [], []
    off = 0
    for layer in range(layers):
        isz = in_sz if layer == 0 else hidden * ndir
        for d in range(ndir):
            n_ih = f"{uid}_wih_{layer}_{d}"
            scope[n_ih] = w[off: off + 4 * hidden * isz].reshape(
                4 * hidden, isz)
            off += 4 * hidden * isz
            n_hh = f"{uid}_whh_{layer}_{d}"
            scope[n_hh] = w[off: off + 4 * hidden * hidden].reshape(
                4 * hidden, hidden)
            off += 4 * hidden * hidden
            wnames += [n_ih, n_hh]
    for layer in range(layers):
        for d in range(ndir):
            n_bi = f"{uid}_bih_{layer}_{d}"
            scope[n_bi] = w[off: off + 4 * hidden]
            off += 4 * hidden
            n_bh = f"{uid}_bhh_{layer}_{d}"
            scope[n_bh] = w[off: off + 4 * hidden]
            off += 4 * hidden
            bnames += [n_bi, n_bh]

    h0_in, c0_in = op.input("InitH"), op.input("InitC")
    h0_name, c0_name = f"{uid}_h0", f"{uid}_c0"
    zeros = (layers * ndir, bsz, hidden)
    scope[h0_name] = scope.fetch(h0_in) if h0_in else torch.zeros(
        zeros, dtype=x.dtype, device=x.device)
    scope[c0_name] = scope.fetch(c0_in) if c0_in else torch.zeros(
        zeros, dtype=x.dtype, device=x.device)

    lh = op.output("LastH") or f"{uid}_lh"
    lc = op.output("LastC") or f"{uid}_lc"
    inputs = [
        {"parameter": "Input", "arguments": [op.input("Input")]},
        {"parameter": "WeightList", "arguments": wnames + bnames},
        {"parameter": "PreState", "arguments": [h0_name, c0_name]},
    ]
    if op.input("SequenceLength"):
        inputs.append({"parameter": "SequenceLength",
                       "arguments": [op.input("SequenceLength")]})
    desc = {
        "type": "rnn", "inputs": inputs,
        "outputs": [
            {"parameter": "Out", "arguments": [op.output("Out")]},
            {"parameter": "State", "arguments": [lh, lc]},
        ],
        "attrs": [
            {"name": "mode", "type": _AT.STRING, "s": "LSTM"},
            {"name": "hidden_size", "type": _AT.INT, "i": hidden},
            {"name": "num_layers", "type": _AT.INT, "i": layers},
            {"name": "is_bidirec", "type": _AT.BOOLEAN, "b": ndir == 2},
            {"name": "is_test", "type": _AT.BOOLEAN,
             "b": bool(op.attr("is_test", True))},
            {"name": "dropout_prob", "type": _AT.FLOAT,
             "f": float(op.attr("dropout_prob", 0.0))},
        ],
    }
    OP_TRANSLATORS["rnn"](OpView(desc), scope, feeds, fetches)
    for aux in ("Reserve", "StateOut"):
        if op.output(aux):
            scope[op.output(aux)] = torch.zeros((1,), dtype=torch.uint8,
                                                device=_dev())
