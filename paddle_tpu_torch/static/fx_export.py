"""torch.export graph -> ProgramDesc exporter (counterpart:
paddle_tpu/static/jaxpr_export.py, `program_from_traced` and the
`_Emitter` handler table).

The JAX package traces a model to a jaxpr and maps each primitive onto
the reference op set; here the model is traced with `torch.export` (in
`export_marker`'s program mode: attention and LayerNorm take their
plain routes, `nn.LSTM`/`GRU`/`SimpleRNN` bind the `rnn` marker), the
graph is decomposed to core ATen (`run_decompositions()`, so the table
below is bounded), and each node maps onto reference Paddle op types
with the JAX handlers' op and attr conventions: elementwise ops with
``axis=-1``, matmuls as ``matmul_v2``, convolutions as ``conv2d`` (+ an
``elementwise_add`` at ``axis=1`` for the bias), pooling as ``pool2d``,
embeddings as ``lookup_table_v2``, sorts as ``argsort``/``top_k_v2``,
shape changes as ``reshape2``/``transpose2``/``expand_v2``, constants as
``fill_constant``/``assign_value`` (folded on the host where every
input is a small constant), the RNN marker as one ``rnn`` op.

Parameters and buffers become persistable vars (their state-dict names)
with their values collected into ``scope``; feeds are the positional
inputs (``input_<i>`` or the given names), fetches ``output_<i>``.  An
unmapped op raises and names the op.  Higher-order ops (``cond``,
``while_loop``, ``scan``: the JAX package's `_while_prim`/`_scan_prim`/
`_cond_prim` sub-blocks) come with slice 4b and raise naming it.
"""
from __future__ import annotations

import operator
from typing import Dict, List

import numpy as np
import torch

from . import proto
from .export_marker import export_trace_context

_FOLD_LIMIT = 4096  # largest constant folded on the host (as the JAX one)


def _np_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _vt(dtype: torch.dtype) -> int:
    return proto.np_dtype_to_vartype(_np_name(dtype))


class _Emitter:
    def __init__(self, program, scope: Dict[str, np.ndarray]):
        self.program = program
        self.block = program.global_block()
        self.scope = scope
        self.names: Dict[object, str] = {}     # fx node -> program var
        self.known: Dict[object, torch.Tensor] = {}  # folded constants
        self.multi: Dict[object, List] = {}    # tuple outputs
        self.counter = 0

    # -- naming --------------------------------------------------------------
    def fresh(self, tag="tmp"):
        self.counter += 1
        return f"fx_{tag}_{self.counter}"

    def declare(self, name, shape, dtype, persistable=False):
        self.block.create_var(name, [int(s) for s in shape],
                              _np_name(dtype), persistable=persistable)

    def emit(self, optype, ins, outs, attrs):
        self.block.append_op(optype, ins, outs, attrs or {})

    def new_var(self, tag, shape, dtype):
        name = self.fresh(tag)
        self.declare(name, shape, dtype)
        return name

    # -- values --------------------------------------------------------------
    def emit_constant(self, val: torch.Tensor, tag="lit") -> str:
        """A constant as fill_constant (uniform) or assign_value."""
        val = val.detach().cpu()
        if val.dtype not in (torch.float32, torch.int32, torch.int64,
                             torch.bool):
            f32 = self.emit_constant(val.float() if val.is_floating_point()
                                     else val.long(), tag)
            out = self.new_var(tag, val.shape, val.dtype)
            self.emit("cast", {"X": f32}, {"Out": out},
                      {"in_dtype": _vt(torch.float32 if
                                       val.is_floating_point()
                                       else torch.int64),
                       "out_dtype": _vt(val.dtype)})
            return out
        name = self.new_var(tag, val.shape, val.dtype)
        flat = val.reshape(-1)
        if flat.numel() and bool((flat == flat[0]).all()):
            self.emit("fill_constant", {}, {"Out": name},
                      {"shape": [int(s) for s in val.shape],
                       "dtype": _vt(val.dtype),
                       "value": float(flat[0])})
            return name
        key = {torch.float32: "fp32_values", torch.int32: "int32_values",
               torch.int64: "int64_values",
               torch.bool: "bool_values"}[val.dtype]
        vals = flat.tolist()
        if val.dtype == torch.bool:
            vals = [bool(v) for v in vals]
        self.emit("assign_value", {}, {"Out": name},
                  {"shape": [int(s) for s in val.shape],
                   "dtype": _vt(val.dtype), key: vals})
        return name

    def var(self, a, like_dtype=None) -> str:
        """The program var holding argument ``a`` (a node, a folded
        constant, or a Python scalar of ``like_dtype``)."""
        if isinstance(a, torch.fx.Node):
            if a in self.names:
                return self.names[a]
            if a in self.known:
                self.names[a] = self.emit_constant(self.known[a])
                return self.names[a]
            raise KeyError(f"fx export: unbound node {a.name}")
        dt = like_dtype or (torch.bool if isinstance(a, bool) else
                            torch.int64 if isinstance(a, int) else
                            torch.float32)
        return self.emit_constant(torch.tensor(a, dtype=dt))

    def bind(self, node, name):
        self.names[node] = name

    def out_var(self, node, tag):
        """Declare the var of ``node``'s (single) output and bind it."""
        val = node.meta["val"]
        name = self.new_var(tag, val.shape, val.dtype)
        self.bind(node, name)
        return name


def _val(a):
    return a.meta["val"] if isinstance(a, torch.fx.Node) else None


def _dtype_of(a):
    v = _val(a)
    return v.dtype if v is not None else None


def _cast_to(em, a, dtype):
    """``a``'s var, cast to ``dtype`` when its dtype differs."""
    name = em.var(a, dtype)
    src = _dtype_of(a)
    if src is None or src == dtype:
        return name
    out = em.new_var("cast", _val(a).shape, dtype)
    em.emit("cast", {"X": name}, {"Out": out},
            {"in_dtype": _vt(src), "out_dtype": _vt(dtype)})
    return out


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------
def _binary(optype, compare=False):
    def h(em, node):
        x, y = node.args[:2]
        if compare:
            tensors = [a for a in (x, y) if isinstance(a, torch.fx.Node)]
            dt = tensors[0].meta["val"].dtype
            for t in tensors[1:]:
                dt = torch.promote_types(dt, t.meta["val"].dtype)
        else:
            dt = node.meta["val"].dtype
        xn, yn = _cast_to(em, x, dt), _cast_to(em, y, dt)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            s = em.new_var("alpha", _val(y).shape if _val(y) is not None
                           else [], dt)
            em.emit("scale", {"X": yn}, {"Out": s},
                    {"scale": float(alpha), "bias": 0.0,
                     "bias_after_scale": True})
            yn = s
        em.emit(optype, {"X": xn, "Y": yn},
                {"Out": em.out_var(node, "ew")}, {"axis": -1})
    return h


def _div(em, node):
    mode = node.kwargs.get("rounding_mode")
    if mode is None:
        return _binary("elementwise_div")(em, node)
    if mode == "floor":
        return _binary("elementwise_floordiv")(em, node)
    raise NotImplementedError(
        "fx export: div with rounding_mode='trunc' has no reference op")


def _unary(optype, attrs=None):
    def h(em, node):
        x = node.args[0]
        dt = node.meta["val"].dtype
        xn = _cast_to(em, x, dt) if dt.is_floating_point else em.var(x)
        em.emit(optype, {"X": xn}, {"Out": em.out_var(node, optype)},
                attrs(node) if callable(attrs) else (attrs or {}))
    return h


def _neg(em, node):
    em.emit("scale", {"X": em.var(node.args[0])},
            {"Out": em.out_var(node, "neg")},
            {"scale": -1.0, "bias": 0.0, "bias_after_scale": True})


def _pow(em, node):
    x, y = node.args[:2]
    if not isinstance(y, torch.fx.Node):
        em.emit("pow", {"X": em.var(x)}, {"Out": em.out_var(node, "pow")},
                {"factor": float(y)})
        return
    _binary("elementwise_pow")(em, node)


def _clip(em, node):
    x = node.args[0]
    if node.target in (torch.ops.aten.clamp_min.default,):
        lo, hi = node.args[1], None
    elif node.target in (torch.ops.aten.clamp_max.default,):
        lo, hi = None, node.args[1]
    else:
        lo = node.args[1] if len(node.args) > 1 else node.kwargs.get("min")
        hi = node.args[2] if len(node.args) > 2 else node.kwargs.get("max")
    if isinstance(lo, torch.fx.Node) or isinstance(hi, torch.fx.Node):
        raise NotImplementedError(
            "fx export: clamp with runtime tensor bounds (clip takes "
            "scalar attrs)")
    em.emit("clip", {"X": em.var(x)}, {"Out": em.out_var(node, "clip")},
            {"min": float("-inf") if lo is None else float(lo),
             "max": float("inf") if hi is None else float(hi)})


def _where(em, node):
    c, x, y = node.args
    dt = node.meta["val"].dtype
    em.emit("where", {"Condition": em.var(c), "X": _cast_to(em, x, dt),
                      "Y": _cast_to(em, y, dt)},
            {"Out": em.out_var(node, "where")}, {})


def _matmul(em, node):
    x, y = node.args[:2]
    em.emit("matmul_v2", {"X": em.var(x), "Y": em.var(y)},
            {"Out": em.out_var(node, "mm")},
            {"trans_x": False, "trans_y": False})


def _addmm(em, node):
    bias, a, b = node.args[:3]
    beta = node.kwargs.get("beta", 1)
    alpha = node.kwargs.get("alpha", 1)
    val = node.meta["val"]
    mm = em.new_var("mm", val.shape, val.dtype)
    em.emit("matmul_v2", {"X": em.var(a), "Y": em.var(b)}, {"Out": mm},
            {"trans_x": False, "trans_y": False})
    if alpha != 1:
        s = em.new_var("alpha", val.shape, val.dtype)
        em.emit("scale", {"X": mm}, {"Out": s},
                {"scale": float(alpha), "bias": 0.0,
                 "bias_after_scale": True})
        mm = s
    bn = em.var(bias)
    if beta != 1:
        s = em.new_var("beta", _val(bias).shape, val.dtype)
        em.emit("scale", {"X": bn}, {"Out": s},
                {"scale": float(beta), "bias": 0.0,
                 "bias_after_scale": True})
        bn = s
    em.emit("elementwise_add", {"X": mm, "Y": bn},
            {"Out": em.out_var(node, "addmm")}, {"axis": -1})


def _conv(em, node):
    (x, w, bias, stride, padding, dilation, transposed, output_padding,
     groups) = node.args
    nd = len(stride)
    if nd not in (2, 3):
        raise NotImplementedError(f"fx export: {nd}-D convolution")
    val = node.meta["val"]
    out = em.new_var("conv", val.shape, val.dtype)
    if transposed:
        if any(int(p) for p in output_padding):
            raise NotImplementedError(
                "fx export: transposed convolution with output_padding")
        optype = "conv2d_transpose" if nd == 2 else "conv3d_transpose"
    else:
        optype = "conv2d" if nd == 2 else "conv3d"
    em.emit(optype, {"Input": em.var(x), "Filter": em.var(w)},
            {"Output": out},
            {"strides": [int(s) for s in stride],
             "paddings": [int(p) for p in padding],
             "dilations": [int(d) for d in dilation],
             "groups": int(groups), "padding_algorithm": "EXPLICIT",
             "data_format": "NCHW" if nd == 2 else "NCDHW"})
    if bias is None:
        em.bind(node, out)
        return
    em.emit("elementwise_add", {"X": out, "Y": em.var(bias)},
            {"Out": em.out_var(node, "conv_bias")}, {"axis": 1})


def _check_pool_dilation(dilation):
    if dilation and any(int(d) != 1 for d in dilation):
        raise NotImplementedError(
            "fx export: dilated pooling has no pool2d form")


def _max_pool(em, node):
    args = list(node.args) + [None] * 6
    x, k, stride, padding, dilation, ceil = args[:6]
    _check_pool_dilation(dilation)
    stride = stride or k
    padding = padding or [0, 0]
    if len(padding) == 1:
        padding = list(padding) * 2
    val = node.meta["val"][0]
    out = em.new_var("pool", val.shape, val.dtype)
    em.emit("pool2d", {"X": em.var(x)}, {"Out": out},
            {"pooling_type": "max", "ksize": [int(s) for s in k],
             "strides": [int(s) for s in stride],
             "paddings": [int(p) for p in padding],
             "ceil_mode": bool(ceil), "global_pooling": False,
             "exclusive": True, "adaptive": False})
    em.multi[node] = [out, None]  # indices: never materialized


def _avg_pool(em, node):
    args = list(node.args) + [None] * 7
    x, k, stride, padding, ceil, count_pad, divisor = args[:7]
    if divisor is not None:
        raise NotImplementedError("fx export: avg_pool divisor_override")
    stride = stride or k
    padding = padding or [0, 0]
    if len(padding) == 1:
        padding = list(padding) * 2
    em.emit("pool2d", {"X": em.var(x)}, {"Out": em.out_var(node, "pool")},
            {"pooling_type": "avg", "ksize": [int(s) for s in k],
             "strides": [int(s) for s in stride],
             "paddings": [int(p) for p in padding],
             "ceil_mode": bool(ceil), "global_pooling": False,
             "exclusive": not (True if count_pad is None else count_pad),
             "adaptive": False})


def _adaptive_avg_pool(em, node):
    x, size = node.args[:2]
    size = [int(s) for s in size]
    em.emit("pool2d", {"X": em.var(x)}, {"Out": em.out_var(node, "gap")},
            {"pooling_type": "avg", "ksize": size, "strides": [1, 1],
             "paddings": [0, 0], "global_pooling": size == [1, 1],
             "adaptive": True, "ceil_mode": False, "exclusive": True})


def _reduce(optype):
    def h(em, node):
        x = node.args[0]
        nd = _val(x).ndim
        dims = node.args[1] if len(node.args) > 1 else \
            node.kwargs.get("dim")
        if dims is None:
            dims = list(range(nd))
        if isinstance(dims, int):
            dims = [dims]
        dims = [int(d) % max(nd, 1) for d in dims]
        keep = bool(node.args[2] if len(node.args) > 2 else
                    node.kwargs.get("keepdim", False))
        xn = em.var(x)
        dt = node.meta["val"].dtype
        if optype == "reduce_mean" and _dtype_of(x) != dt:
            xn = _cast_to(em, x, dt)
        em.emit(optype, {"X": xn}, {"Out": em.out_var(node, "red")},
                {"dim": dims, "keep_dim": keep,
                 "reduce_all": len(dims) == nd})
    return h


def _var(em, node):
    """var.correction: mean, centred square, mean, scaled by n / (n - c)
    (the reference has no variance op)."""
    x = node.args[0]
    xv = _val(x)
    dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    dims = list(range(xv.ndim)) if dims is None else \
        [int(d) % xv.ndim for d in dims]
    corr = node.kwargs.get("correction", 1)
    corr = 1 if corr is None else corr
    keep = bool(node.kwargs.get("keepdim", False))
    n = int(np.prod([xv.shape[d] for d in dims]))
    kshape = [1 if i in dims else s for i, s in enumerate(xv.shape)]
    mean = em.new_var("var_mean", kshape, xv.dtype)
    em.emit("reduce_mean", {"X": em.var(x)}, {"Out": mean},
            {"dim": dims, "keep_dim": True,
             "reduce_all": len(dims) == xv.ndim})
    cen = em.new_var("var_c", xv.shape, xv.dtype)
    em.emit("elementwise_sub", {"X": em.var(x), "Y": mean}, {"Out": cen},
            {"axis": -1})
    sq = em.new_var("var_sq", xv.shape, xv.dtype)
    em.emit("square", {"X": cen}, {"Out": sq}, {})
    val = node.meta["val"]
    m2 = em.new_var("var_m2", val.shape, val.dtype)
    em.emit("reduce_mean", {"X": sq}, {"Out": m2},
            {"dim": dims, "keep_dim": keep,
             "reduce_all": len(dims) == xv.ndim})
    if corr == 0:
        em.bind(node, m2)
        return
    em.emit("scale", {"X": m2}, {"Out": em.out_var(node, "var")},
            {"scale": float(n) / float(max(n - corr, 1)), "bias": 0.0,
             "bias_after_scale": True})


def _reshape(em, node):
    em.emit("reshape2", {"X": em.var(node.args[0])},
            {"Out": em.out_var(node, "rs")},
            {"shape": [int(s) for s in node.meta["val"].shape]})


def _permute(em, node):
    x = node.args[0]
    if node.target == torch.ops.aten.t.default:
        perm = list(range(_val(x).ndim))[::-1]
    elif node.target == torch.ops.aten.transpose.int:
        nd = _val(x).ndim
        a, b = int(node.args[1]) % nd, int(node.args[2]) % nd
        perm = list(range(nd))
        perm[a], perm[b] = perm[b], perm[a]
    else:
        perm = [int(p) % _val(x).ndim for p in node.args[1]]
    em.emit("transpose2", {"X": em.var(x)},
            {"Out": em.out_var(node, "tr")}, {"axis": perm})


def _expand(em, node):
    x = node.args[0]
    xs = list(_val(x).shape)
    tgt = [int(s) for s in node.meta["val"].shape]
    cur = em.var(x)
    if len(xs) < len(tgt):
        mid = [1] * (len(tgt) - len(xs)) + xs
        r = em.new_var("bcast_r", mid, _val(x).dtype)
        em.emit("reshape2", {"X": cur}, {"Out": r}, {"shape": mid})
        cur = r
    em.emit("expand_v2", {"X": cur}, {"Out": em.out_var(node, "bcast")},
            {"shape": tgt})


def _assign(em, node):
    em.emit("assign", {"X": em.var(node.args[0])},
            {"Out": em.out_var(node, "assign")}, {})


def _to_copy(em, node):
    x = node.args[0]
    dt = node.kwargs.get("dtype")
    if dt is None or dt == _dtype_of(x):
        return _assign(em, node)
    em.emit("cast", {"X": em.var(x)}, {"Out": em.out_var(node, "cast")},
            {"in_dtype": _vt(_dtype_of(x)), "out_dtype": _vt(dt)})


def _slice(em, node):
    args = list(node.args) + [None] * 5
    x, dim, start, end, step = args[:5]
    xv = _val(x)
    dim = int(dim or 0) % xv.ndim
    n = xv.shape[dim]
    start, stop, step = slice(start, end, step or 1).indices(n)
    if step == 1:
        em.emit("slice", {"Input": em.var(x)},
                {"Out": em.out_var(node, "sl")},
                {"axes": [dim], "starts": [start], "ends": [stop],
                 "infer_flags": [1], "decrease_axis": []})
        return
    em.emit("strided_slice", {"Input": em.var(x)},
            {"Out": em.out_var(node, "sl")},
            {"axes": [dim], "starts": [start], "ends": [stop],
             "strides": [step], "infer_flags": [1], "decrease_axis": []})


def _select(em, node):
    x, dim, index = node.args
    xv = _val(x)
    dim = int(dim) % xv.ndim
    index = int(index) % xv.shape[dim]
    em.emit("slice", {"Input": em.var(x)}, {"Out": em.out_var(node, "sel")},
            {"axes": [dim], "starts": [index], "ends": [index + 1],
             "infer_flags": [1], "decrease_axis": [dim]})


def _cat(em, node):
    tensors = node.args[0]
    dim = int(node.args[1]) if len(node.args) > 1 else 0
    dt = node.meta["val"].dtype
    em.emit("concat", {"X": [_cast_to(em, t, dt) for t in tensors]},
            {"Out": em.out_var(node, "cc")},
            {"axis": dim % node.meta["val"].ndim})


def _split(em, node):
    x = node.args[0]
    xv = _val(x)
    dim = int(node.args[2]) if len(node.args) > 2 else 0
    dim %= xv.ndim
    vals = node.meta["val"]
    sizes = [int(v.shape[dim]) for v in vals]
    outs = [em.new_var("split", v.shape, v.dtype) for v in vals]
    attrs = {"axis": dim}
    if len(set(sizes)) == 1:
        attrs.update(num=len(sizes), sections=[])
    else:
        attrs.update(num=0, sections=sizes)
    em.emit("split", {"X": em.var(x)}, {"Out": outs}, attrs)
    em.multi[node] = outs


def _embedding(em, node):
    w, ids = node.args[:2]
    em.emit("lookup_table_v2", {"W": em.var(w), "Ids": em.var(ids)},
            {"Out": em.out_var(node, "emb")}, {"padding_idx": -1})


def _index_select(em, node):
    x, dim, idx = node.args
    em.emit("index_select", {"X": em.var(x), "Index": em.var(idx)},
            {"Out": em.out_var(node, "isel")},
            {"dim": int(dim) % _val(x).ndim})


def _pad(em, node):
    x, pad = node.args[:2]
    value = node.args[2] if len(node.args) > 2 else \
        node.kwargs.get("value", 0.0)
    xv = _val(x)
    nd = xv.ndim
    cfg = [[0, 0] for _ in range(nd)]
    for i in range(len(pad) // 2):
        cfg[nd - 1 - i] = [int(pad[2 * i]), int(pad[2 * i + 1])]
    cur = em.var(x)
    if any(lo < 0 or hi < 0 for lo, hi in cfg):
        # negative pads trim: a slice, then the positive pads
        starts = [max(0, -lo) for lo, _ in cfg]
        ends = [int(xv.shape[d]) + min(0, hi)
                for d, (_, hi) in enumerate(cfg)]
        sl = em.new_var("padtrim", [e - s for s, e in zip(starts, ends)],
                        xv.dtype)
        em.emit("slice", {"Input": cur}, {"Out": sl},
                {"axes": list(range(nd)), "starts": starts, "ends": ends,
                 "infer_flags": [1] * nd, "decrease_axis": []})
        cur = sl
        cfg = [[max(0, lo), max(0, hi)] for lo, hi in cfg]
    paddings = [p for pair in cfg for p in pair]
    em.emit("pad", {"X": cur}, {"Out": em.out_var(node, "pad")},
            {"paddings": paddings, "pad_value": float(value)})


def _softmax(optype):
    def h(em, node):
        x, dim = node.args[:2]
        em.emit(optype, {"X": em.var(x)}, {"Out": em.out_var(node, optype)},
                {"axis": int(dim)})
    return h


def _gelu(em, node):
    approx = node.kwargs.get("approximate", "none")
    em.emit("gelu", {"X": em.var(node.args[0])},
            {"Out": em.out_var(node, "gelu")},
            {"approximate": approx == "tanh"})


def _leaky_relu(em, node):
    slope = node.args[1] if len(node.args) > 1 else 0.01
    em.emit("leaky_relu", {"X": em.var(node.args[0])},
            {"Out": em.out_var(node, "lrelu")}, {"alpha": float(slope)})


def _layer_norm(em, node):
    x, shape, w, b, eps = node.args[:5]
    nd = _val(x).ndim
    ins = {"X": em.var(x)}
    if w is not None:
        ins["Scale"] = em.var(w)
    if b is not None:
        ins["Bias"] = em.var(b)
    val = node.meta["val"][0]
    out = em.new_var("ln", val.shape, val.dtype)
    em.emit("layer_norm", ins, {"Y": out},
            {"epsilon": float(eps), "begin_norm_axis": nd - len(shape)})
    em.multi[node] = [out, None, None]


def _batch_norm(em, node):
    x, w, b, mean, var, _momentum, eps = node.args[:7]
    val = node.meta["val"][0]
    out = em.new_var("bn", val.shape, val.dtype)
    em.emit("batch_norm", {"X": em.var(x), "Scale": em.var(w),
                           "Bias": em.var(b), "Mean": em.var(mean),
                           "Variance": em.var(var)},
            {"Y": out}, {"epsilon": float(eps), "is_test": True,
                         "data_layout": "NCHW"})
    em.multi[node] = [out, None, None]


def _cumsum(em, node):
    x, dim = node.args[:2]
    em.emit("cumsum", {"X": em.var(x)}, {"Out": em.out_var(node, "cumsum")},
            {"axis": int(dim), "flatten": False, "exclusive": False,
             "reverse": False})


def _argmax(em, node):
    x = node.args[0]
    dim = node.args[1] if len(node.args) > 1 else None
    keep = bool(node.args[2]) if len(node.args) > 2 else False
    if dim is None:
        raise NotImplementedError("fx export: argmax over all axes")
    em.emit("arg_max", {"X": em.var(x)}, {"Out": em.out_var(node, "argmax")},
            {"axis": int(dim), "keepdims": keep, "flatten": False,
             "dtype": _vt(torch.int64)})


def _max_dim(reduce_op, arg_op):
    """max.dim / min.dim: the values (``reduce_max``/``reduce_min``) and
    the indices (``arg_max``/``arg_min``)."""
    def h(em, node):
        x, dim = node.args[:2]
        keep = bool(node.args[2]) if len(node.args) > 2 else False
        dim = int(dim) % _val(x).ndim
        vals = node.meta["val"]
        out_v = em.new_var("maxv", vals[0].shape, vals[0].dtype)
        out_i = em.new_var("maxi", vals[1].shape, vals[1].dtype)
        em.emit(reduce_op, {"X": em.var(x)}, {"Out": out_v},
                {"dim": [dim], "keep_dim": keep,
                 "reduce_all": _val(x).ndim == 1})
        em.emit(arg_op, {"X": em.var(x)}, {"Out": out_i},
                {"axis": dim, "keepdims": keep, "flatten": False,
                 "dtype": _vt(torch.int64)})
        em.multi[node] = [out_v, out_i]
    return h


def _topk(em, node):
    x, k = node.args[:2]
    dim = node.args[2] if len(node.args) > 2 else -1
    largest = node.args[3] if len(node.args) > 3 else True
    if int(dim) % _val(x).ndim != _val(x).ndim - 1 or not largest:
        raise NotImplementedError(
            "fx export: topk over the last axis, largest, only "
            "(top_k_v2's form)")
    vals = node.meta["val"]
    out_v = em.new_var("topk_v", vals[0].shape, vals[0].dtype)
    out_i = em.new_var("topk_i", vals[1].shape, vals[1].dtype)
    em.emit("top_k_v2", {"X": em.var(x)}, {"Out": out_v, "Indices": out_i},
            {"k": int(k), "axis": -1, "largest": True, "sorted": True})
    em.multi[node] = [out_v, out_i]


def _sort(em, node):
    x = node.args[0]
    dim = node.args[1] if len(node.args) > 1 else -1
    desc = node.args[2] if len(node.args) > 2 else \
        node.kwargs.get("descending", False)
    vals = node.meta["val"]
    out_v = em.new_var("sort_v", vals[0].shape, vals[0].dtype)
    out_i = em.new_var("sort_i", vals[1].shape, vals[1].dtype)
    em.emit("argsort", {"X": em.var(x)}, {"Out": out_v, "Indices": out_i},
            {"axis": int(dim), "descending": bool(desc)})
    em.multi[node] = [out_v, out_i]


def _fill_like(em, node):
    x = node.args[0]
    value = {torch.ops.aten.zeros_like.default: 0.0,
             torch.ops.aten.ones_like.default: 1.0}.get(node.target)
    if value is None:
        value = float(node.args[1])
    dt = node.kwargs.get("dtype") or _dtype_of(x)
    if dt != _dtype_of(x):
        tmp = em.new_var("fill", _val(x).shape, _dtype_of(x))
        em.emit("fill_any_like", {"X": em.var(x)}, {"Out": tmp},
                {"value": value})
        em.emit("cast", {"X": tmp}, {"Out": em.out_var(node, "fill")},
                {"in_dtype": _vt(_dtype_of(x)), "out_dtype": _vt(dt)})
        return
    em.emit("fill_any_like", {"X": em.var(x)},
            {"Out": em.out_var(node, "fill")}, {"value": value})


def _rnn_marker(em, node):
    """The `rnn` marker (`export_marker.rnn_marker`) -> the unified `rnn`
    op (`operators/rnn_op.cc`), time-major: batch-major models get
    transpose2 brackets, as the reference's python layer puts around its
    fused op (the JAX package's `_paddle_rnn_prim`)."""
    (x, h0, c0, weights, mode, hidden, layers, bidirec, time_major,
     dropout) = node.args
    lstm = mode == "LSTM"
    xv = _val(x)
    xn = em.var(x)
    if not time_major:
        t = em.new_var("rnn_tm", (xv.shape[1], xv.shape[0], xv.shape[2]),
                       xv.dtype)
        em.emit("transpose2", {"X": xn}, {"Out": t}, {"axis": [1, 0, 2]})
        xn = t
    pre = [em.var(h0)] + ([em.var(c0)] if lstm else [])
    tlen, b = (xv.shape[0], xv.shape[1]) if time_major else \
        (xv.shape[1], xv.shape[0])
    nd = 2 if bidirec else 1
    o = em.new_var("rnn_out", (tlen, b, hidden * nd), xv.dtype)
    vals = node.meta["val"]
    states = [em.new_var("rnn_state", vals[1].shape, vals[1].dtype)
              for _ in range(2 if lstm else 1)]
    ds = em.fresh("rnn_dropout_state")
    em.block.create_var(ds, type=proto.VarType.RAW)
    rv = em.new_var("rnn_reserve", (0,), torch.float32)
    em.emit("rnn", {"Input": xn, "WeightList": [em.var(w) for w in weights],
                    "PreState": pre},
            {"Out": o, "State": states, "DropoutState": ds, "Reserve": rv},
            {"mode": mode, "hidden_size": int(hidden),
             "num_layers": int(layers), "is_bidirec": bool(bidirec),
             "is_test": True, "dropout_prob": float(dropout), "seed": 0})
    if not time_major:
        ob = em.new_var("rnn_out_bm", vals[0].shape, vals[0].dtype)
        em.emit("transpose2", {"X": o}, {"Out": ob}, {"axis": [1, 0, 2]})
        o = ob
    em.multi[node] = [o] + states


def _skip(em, node):
    return


aten = torch.ops.aten
_HANDLERS = {
    aten.add.Tensor: _binary("elementwise_add"),
    aten.add.Scalar: _binary("elementwise_add"),
    aten.sub.Tensor: _binary("elementwise_sub"),
    aten.sub.Scalar: _binary("elementwise_sub"),
    aten.mul.Tensor: _binary("elementwise_mul"),
    aten.mul.Scalar: _binary("elementwise_mul"),
    aten.div.Tensor: _div,
    aten.div.Scalar: _div,
    aten.div.Tensor_mode: _div,
    aten.maximum.default: _binary("elementwise_max"),
    aten.minimum.default: _binary("elementwise_min"),
    aten.remainder.Tensor: _binary("elementwise_mod"),
    aten.remainder.Scalar: _binary("elementwise_mod"),
    aten.pow.Tensor_Tensor: _pow,
    aten.pow.Tensor_Scalar: _pow,
    aten.eq.Tensor: _binary("equal", True),
    aten.eq.Scalar: _binary("equal", True),
    aten.ne.Tensor: _binary("not_equal", True),
    aten.ne.Scalar: _binary("not_equal", True),
    aten.lt.Tensor: _binary("less_than", True),
    aten.lt.Scalar: _binary("less_than", True),
    aten.le.Tensor: _binary("less_equal", True),
    aten.le.Scalar: _binary("less_equal", True),
    aten.gt.Tensor: _binary("greater_than", True),
    aten.gt.Scalar: _binary("greater_than", True),
    aten.ge.Tensor: _binary("greater_equal", True),
    aten.ge.Scalar: _binary("greater_equal", True),
    aten.logical_and.default: _binary("logical_and", True),
    aten.logical_or.default: _binary("logical_or", True),
    aten.logical_xor.default: _binary("logical_xor", True),
    aten.bitwise_and.Tensor: _binary("logical_and", True),
    aten.bitwise_or.Tensor: _binary("logical_or", True),
    aten.logical_not.default: _unary("logical_not"),
    aten.bitwise_not.default: _unary("logical_not"),
    aten.where.self: _where,
    aten.relu.default: _unary("relu"),
    aten.sigmoid.default: _unary("sigmoid"),
    aten.tanh.default: _unary("tanh"),
    aten.exp.default: _unary("exp"),
    aten.expm1.default: _unary("expm1"),
    aten.log.default: _unary("log"),
    aten.log1p.default: _unary("log1p"),
    aten.sqrt.default: _unary("sqrt"),
    aten.rsqrt.default: _unary("rsqrt"),
    aten.abs.default: _unary("abs"),
    aten.neg.default: _neg,
    aten.erf.default: _unary("erf"),
    aten.floor.default: _unary("floor"),
    aten.ceil.default: _unary("ceil"),
    aten.round.default: _unary("round"),
    aten.sin.default: _unary("sin"),
    aten.cos.default: _unary("cos"),
    aten.sign.default: _unary("sign"),
    aten.reciprocal.default: _unary("reciprocal"),
    aten.isfinite.default: _unary("isfinite"),
    aten.gelu.default: _gelu,
    aten.leaky_relu.default: _leaky_relu,
    aten.clamp.default: _clip,
    aten.clamp_min.default: _clip,
    aten.clamp_max.default: _clip,
    aten.hardtanh.default: _clip,
    aten._softmax.default: _softmax("softmax"),
    aten._log_softmax.default: _softmax("log_softmax"),
    aten.mm.default: _matmul,
    aten.bmm.default: _matmul,
    aten.addmm.default: _addmm,
    aten.convolution.default: _conv,
    aten.max_pool2d_with_indices.default: _max_pool,
    aten.avg_pool2d.default: _avg_pool,
    aten._adaptive_avg_pool2d.default: _adaptive_avg_pool,
    aten.mean.dim: _reduce("reduce_mean"),
    aten.mean.default: _reduce("reduce_mean"),
    aten.sum.dim_IntList: _reduce("reduce_sum"),
    aten.sum.default: _reduce("reduce_sum"),
    aten.amax.default: _reduce("reduce_max"),
    aten.amin.default: _reduce("reduce_min"),
    aten.any.dim: _reduce("reduce_any"),
    aten.any.dims: _reduce("reduce_any"),
    aten.all.dim: _reduce("reduce_all"),
    aten.var.correction: _var,
    aten.view.default: _reshape,
    aten._unsafe_view.default: _reshape,
    aten.reshape.default: _reshape,
    aten.squeeze.dim: _reshape,
    aten.squeeze.dims: _reshape,
    aten.squeeze.default: _reshape,
    aten.unsqueeze.default: _reshape,
    aten.permute.default: _permute,
    aten.t.default: _permute,
    aten.transpose.int: _permute,
    aten.expand.default: _expand,
    aten.clone.default: _assign,
    aten.alias.default: _assign,
    aten.detach.default: _assign,
    aten.lift_fresh_copy.default: _assign,
    aten._to_copy.default: _to_copy,
    aten.slice.Tensor: _slice,
    aten.select.int: _select,
    aten.cat.default: _cat,
    aten.split_with_sizes.default: _split,
    aten.split.Tensor: _split,
    aten.embedding.default: _embedding,
    aten.index_select.default: _index_select,
    aten.constant_pad_nd.default: _pad,
    aten.native_layer_norm.default: _layer_norm,
    aten._native_batch_norm_legit_no_training.default: _batch_norm,
    aten.cumsum.default: _cumsum,
    aten.argmax.default: _argmax,
    aten.max.dim: _max_dim("reduce_max", "arg_max"),
    aten.min.dim: _max_dim("reduce_min", "arg_min"),
    aten.topk.default: _topk,
    aten.sort.default: _sort,
    aten.zeros_like.default: _fill_like,
    aten.ones_like.default: _fill_like,
    aten.full_like.default: _fill_like,
    aten._assert_tensor_metadata.default: _skip,
    aten._assert_scalar.default: _skip,
}


def _rnn_target():
    return torch.ops.paddle_tpu_torch.rnn.default


# ops that make a tensor from their arguments alone: always folded
_CREATION = {aten.full.default, aten.zeros.default, aten.ones.default,
             aten.arange.default, aten.arange.start,
             aten.arange.start_step, aten.scalar_tensor.default,
             aten.empty.memory_format}


def _try_fold(em, node) -> bool:
    """Evaluate ``node`` on the host when every tensor input is a folded
    constant (small) — no op emitted; materialized where used."""
    if node.target in _CREATION:
        kw = dict(node.kwargs)
        kw["device"] = "cpu"
        kw.pop("pin_memory", None)
        if node.target == aten.empty.memory_format:
            kw.pop("memory_format", None)
            val = torch.zeros(*node.args, **kw)
        else:
            val = node.target(*node.args, **kw)
        em.known[node] = val
        return True
    flat = [a for a in node.args if isinstance(a, torch.fx.Node)]
    for a in node.args:
        if isinstance(a, (list, tuple)):
            flat += [b for b in a if isinstance(b, torch.fx.Node)]
    if not flat or not all(a in em.known for a in flat):
        return False
    if any(em.known[a].numel() > _FOLD_LIMIT for a in flat):
        return False

    def sub(a):
        if isinstance(a, torch.fx.Node):
            return em.known[a]
        if isinstance(a, (list, tuple)):
            return type(a)(sub(b) for b in a)
        return a

    kw = {k: ("cpu" if k == "device" else sub(v))
          for k, v in node.kwargs.items()}
    try:
        val = node.target(*[sub(a) for a in node.args], **kw)
    except Exception:
        return False
    if not isinstance(val, torch.Tensor):
        return False
    em.known[node] = val
    return True


def _walk(em, gm, sig, state, constants):
    """Bind the placeholders, then emit each node in order."""
    params = dict(sig.inputs_to_parameters)
    buffers = dict(sig.inputs_to_buffers)
    consts = dict(getattr(sig, "inputs_to_lifted_tensor_constants", {}))
    outputs = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            src = params.get(node.name) or buffers.get(node.name)
            if src is not None:
                val = state[src] if src in state else constants[src]
                arr = val.detach().cpu()
                em.declare(src, arr.shape, arr.dtype, persistable=True)
                em.scope[src] = arr.numpy()
                em.bind(node, src)
            elif node.name in consts:
                val = constants[consts[node.name]].detach().cpu()
                if val.numel() <= _FOLD_LIMIT:
                    em.known[node] = val
                else:
                    name = em.fresh("const")
                    em.declare(name, val.shape, val.dtype, persistable=True)
                    em.scope[name] = val.numpy()
                    em.bind(node, name)
            continue
        if node.op == "output":
            outputs = node.args[0]
            continue
        if node.op == "get_attr" and isinstance(
                getattr(gm, str(node.target), None), torch.nn.Module):
            continue  # a sub-graph of a higher-order op (refused below)
        if node.op != "call_function":
            raise NotImplementedError(
                f"fx export: graph node kind {node.op!r} ({node.name})")
        if node.target is operator.getitem:
            src, i = node.args
            if src in em.multi:
                name = em.multi[src][i]
                if name is None:
                    raise NotImplementedError(
                        f"fx export: output {i} of {src.target} (indices /"
                        " statistics) has no reference-op counterpart")
                em.bind(node, name)
            elif src in em.known:
                em.known[node] = em.known[src][i]
            else:
                raise KeyError(f"fx export: getitem of {src.name}")
            continue
        if isinstance(node.target, torch._ops.HigherOrderOperator):
            raise NotImplementedError(
                f"fx export: higher-order op {node.target.name()!r} "
                "(traced control flow and the exporter's sub-blocks) "
                "lands with slice 4b (ROADMAP.md Queue 1, item 4b)")
        if _try_fold(em, node):
            continue
        handler = _HANDLERS.get(node.target)
        if handler is None and node.target == _rnn_target():
            handler = _rnn_marker
        if handler is None:
            raise NotImplementedError(
                f"fx export: no ProgramDesc mapping for op "
                f"{node.target} (op set: "
                f"{sorted(str(k) for k in _HANDLERS)})")
        handler(em, node)
    return outputs


class _CallableModule(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        object.__setattr__(self, "fn", fn)

    def forward(self, *xs):
        return self.fn(*xs)


def program_from_traced(fn, example_inputs: List, scope: Dict,
                        input_names: List[str] = None):
    """Trace ``fn(*example_inputs)`` (a module or a callable) with
    `torch.export` and emit its graph as a Program.  Parameters and
    buffers become persistable vars with their values collected into
    ``scope``.  Returns the Program; feed targets are the positional
    inputs, fetch targets the outputs."""
    from .program import Program

    module = fn if isinstance(fn, torch.nn.Module) else _CallableModule(fn)
    examples = tuple(torch.as_tensor(x) for x in example_inputs)
    with torch.no_grad(), export_trace_context("program"):
        ep = torch.export.export(module, examples, strict=False)
        ep = ep.run_decompositions()

    program = Program()
    block = program.global_block()
    block.create_var("feed", type=proto.VarType.FEED_MINIBATCH,
                     persistable=True)
    block.create_var("fetch", type=proto.VarType.FETCH_LIST,
                     persistable=True)
    em = _Emitter(program, scope)
    gm = ep.graph_module
    names = input_names or [f"input_{i}" for i in range(len(examples))]
    user = [n for n in gm.graph.nodes if n.op == "placeholder" and
            n.name in set(ep.graph_signature.user_inputs)]
    for i, (node, name) in enumerate(zip(user, names)):
        val = node.meta["val"]
        block.create_var(name, list(val.shape), _np_name(val.dtype),
                         need_check_feed=True)
        em.emit("feed", {"X": "feed"}, {"Out": name}, {"col": i})
        em.bind(node, name)
    outputs = _walk(em, gm, ep.graph_signature, ep.state_dict,
                    ep.constants)
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    for i, v in enumerate(outs):
        out_name = f"output_{i}"
        val = v.meta["val"] if isinstance(v, torch.fx.Node) else \
            em.known[v]
        block.create_var(out_name, list(val.shape), _np_name(val.dtype))
        em.emit("assign", {"X": em.var(v)}, {"Out": out_name}, {})
        em.emit("fetch", {"X": out_name}, {"Out": "fetch"}, {"col": i})
    return program
