"""Program/Block/Variable/Operator mirrors over the ProgramDesc format
(counterpart: paddle_tpu/static/program.py).

Reference: the Python mirror classes in `fluid/framework.py` (Program,
Block, Variable, Operator) wrapping the C++ descs
(`framework/program_desc.h:31`).  Here the descs are the plain dicts of
`paddle_tpu_torch.static.proto`, and execution happens through the
torch interpreter (`paddle_tpu_torch.static.interp`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import proto
from .proto import AttrType, VarType


class Variable:
    def __init__(self, block: "Block", desc: Dict[str, Any]):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc["name"]

    @property
    def persistable(self) -> bool:
        return bool(self.desc.get("persistable", False))

    @persistable.setter
    def persistable(self, v):
        self.desc["persistable"] = bool(v)

    @property
    def shape(self):
        t = self.desc.get("type", {})
        lt = t.get("lod_tensor")
        if lt:
            return tuple(lt["tensor"].get("dims", []))
        return ()

    @property
    def dtype(self):
        t = self.desc.get("type", {})
        lt = t.get("lod_tensor")
        if lt:
            return proto.vartype_to_np_dtype(lt["tensor"]["data_type"])
        return None

    def __repr__(self):
        return f"Variable({self.name}, shape={self.shape})"


class Operator:
    def __init__(self, block: "Block", desc: Dict[str, Any]):
        self.block = block
        self.desc = desc

    @property
    def type(self):
        return self.desc["type"]

    def input(self, name):
        for v in self.desc.get("inputs", []):
            if v["parameter"] == name:
                return v.get("arguments", [])
        return []

    def output(self, name):
        for v in self.desc.get("outputs", []):
            if v["parameter"] == name:
                return v.get("arguments", [])
        return []

    @property
    def input_arg_names(self):
        return [a for v in self.desc.get("inputs", [])
                for a in v.get("arguments", [])]

    @property
    def output_arg_names(self):
        return [a for v in self.desc.get("outputs", [])
                for a in v.get("arguments", [])]

    def attr(self, name):
        from .interp import _attr_value

        for a in self.desc.get("attrs", []):
            if a["name"] == name:
                return _attr_value(a)
        return None


def _attr_desc(name: str, value) -> Dict[str, Any]:
    """Python value -> OpDesc.Attr dict with the right AttrType."""
    d: Dict[str, Any] = {"name": name}
    if isinstance(value, bool):
        d["type"] = AttrType.BOOLEAN
        d["b"] = value
    elif isinstance(value, (int, np.integer)):
        if -(2 ** 31) <= int(value) < 2 ** 31:
            d["type"] = AttrType.INT
            d["i"] = int(value)
        else:
            d["type"] = AttrType.LONG
            d["l"] = int(value)
    elif isinstance(value, (float, np.floating)):
        d["type"] = AttrType.FLOAT
        d["f"] = float(value)
    elif isinstance(value, str):
        d["type"] = AttrType.STRING
        d["s"] = value
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], bool):
            d["type"] = AttrType.BOOLEANS
            d["bools"] = [bool(v) for v in value]
        elif value and isinstance(value[0], str):
            d["type"] = AttrType.STRINGS
            d["strings"] = list(value)
        elif value and isinstance(value[0], (float, np.floating)):
            d["type"] = AttrType.FLOATS
            d["floats"] = [float(v) for v in value]
        else:
            d["type"] = AttrType.INTS
            d["ints"] = [int(v) for v in value]
    elif isinstance(value, (BlockRef, Block)):
        d["type"] = AttrType.BLOCK
        d["block_idx"] = int(value.idx)
    else:
        raise TypeError(f"unsupported attr value {value!r}")
    return d


class BlockRef:
    """Marker for a BLOCK-typed op attribute (sub_block of
    while/conditional_block/recurrent): `attrs={"sub_block":
    BlockRef(idx)}`."""

    def __init__(self, idx: int):
        self.idx = int(idx)


class Block:
    def __init__(self, program: "Program", desc: Dict[str, Any]):
        self.program = program
        self.desc = desc
        desc.setdefault("vars", [])
        desc.setdefault("ops", [])

    @property
    def idx(self):
        return self.desc.get("idx", 0)

    @property
    def ops(self) -> List[Operator]:
        return [Operator(self, d) for d in self.desc["ops"]]

    def list_vars(self) -> List[Variable]:
        return [Variable(self, d) for d in self.desc["vars"]]

    def var(self, name) -> Variable:
        for d in self.desc["vars"]:
            if d["name"] == name:
                return Variable(self, d)
        raise KeyError(f"variable {name!r} not in block {self.idx}")

    def has_var(self, name) -> bool:
        return any(d["name"] == name for d in self.desc["vars"])

    def create_var(self, name, shape=None, dtype="float32",
                   persistable=False, type=VarType.LOD_TENSOR,
                   lod_level=0, need_check_feed=False) -> Variable:
        if self.has_var(name):
            return self.var(name)
        vt: Dict[str, Any] = {"type": type}
        if type == VarType.LOD_TENSOR:
            vt["lod_tensor"] = {
                "tensor": {
                    "data_type": proto.np_dtype_to_vartype(dtype),
                    "dims": [int(d) for d in (shape or [])],
                },
                "lod_level": lod_level,
            }
        d = {"name": name, "type": vt, "persistable": persistable,
             "need_check_feed": need_check_feed}
        self.desc["vars"].append(d)
        return Variable(self, d)

    def append_op(self, type: str, inputs: Optional[Dict] = None,
                  outputs: Optional[Dict] = None,
                  attrs: Optional[Dict] = None) -> Operator:
        def norm(m):
            out = []
            for param, args in (m or {}).items():
                if isinstance(args, str):
                    args = [args]
                out.append({"parameter": param,
                            "arguments": [str(a) for a in args]})
            return out

        d = {
            "type": type,
            "inputs": norm(inputs),
            "outputs": norm(outputs),
            "attrs": [_attr_desc(k, v)
                      for k, v in sorted((attrs or {}).items())],
        }
        self.desc["ops"].append(d)
        return Operator(self, d)


class Program:
    """A real ProgramDesc (reference `fluid/framework.py` Program)."""

    def __init__(self):
        self.desc: Dict[str, Any] = {
            "blocks": [{"idx": 0, "parent_idx": -1, "vars": [], "ops": []}],
            "version": {"version": 0},
        }
        self.random_seed = None

    # -- blocks --------------------------------------------------------------
    @property
    def blocks(self) -> List[Block]:
        return [Block(self, b) for b in self.desc["blocks"]]

    def global_block(self) -> Block:
        return Block(self, self.desc["blocks"][0])

    def block(self, idx) -> Block:
        return Block(self, self.desc["blocks"][idx])

    def create_block(self, parent_idx: int = 0) -> Block:
        """Append a sub-block (while/conditional_block/recurrent bodies;
        reference `BlockDesc` with parent_idx)."""
        d = {"idx": len(self.desc["blocks"]), "parent_idx": int(parent_idx),
             "vars": [], "ops": []}
        self.desc["blocks"].append(d)
        return Block(self, d)

    def num_blocks(self):
        return len(self.desc["blocks"])

    def list_vars(self):
        return [v for b in self.blocks for v in b.list_vars()]

    # -- serialization (the reference interchange contract) ------------------
    def serialize_to_string(self) -> bytes:
        # Stamp current op versions (reference REGISTER_OP_VERSION
        # registry): a reader of this program must not apply
        # pre-version-1 compat upgrades to ops we emitted with current
        # conventions (static/op_version.py).  Serialization works on a
        # COPY: interpreter-internal attrs are stripped from the wire
        # format, entries for op types outside our registry are
        # preserved verbatim, and ops still carrying legacy semantics
        # (__legacy_formula__ from a v0 load) keep version 0 so any
        # reader re-applies its own compat translation.
        import copy

        from .op_version import UPGRADERS

        desc = copy.deepcopy(self.desc)
        legacy_types = set()
        present = set()
        for b in desc.get("blocks", []):
            for op in b.get("ops", []):
                present.add(op["type"])
                attrs = op.get("attrs", [])
                if any(a.get("name") == "__legacy_formula__"
                       for a in attrs):
                    legacy_types.add(op["type"])
                    op["attrs"] = [a for a in attrs if
                                   a.get("name") != "__legacy_formula__"]
        vmap = desc.get("op_version_map") or {}
        pairs = {p.get("op_name"): p for p in vmap.get("pair", [])}
        for t in sorted(present & set(UPGRADERS)):
            ver = 0 if t in legacy_types else                 max(v for v, _ in UPGRADERS[t])
            pairs[t] = {"op_name": t, "op_version": {"version": ver}}
        if pairs:
            desc["op_version_map"] = {
                "pair": [pairs[k] for k in sorted(pairs)]}
        return proto.serialize_program(desc)

    @classmethod
    def parse_from_string(cls, data: bytes) -> "Program":
        from .op_version import upgrade_program

        p = cls()
        p.desc = proto.parse_program(data)
        p.desc.setdefault("blocks", [])
        # translate old-version op conventions to current semantics
        # (reference op_version_registry checkpoint application)
        upgrade_program(p.desc)
        return p

    def clone(self, for_test=False) -> "Program":
        import copy

        p = Program()
        p.desc = copy.deepcopy(self.desc)
        return p

    # -- feed/fetch discovery ------------------------------------------------
    def feed_target_names(self) -> List[str]:
        outs = []
        for op in self.global_block().ops:
            if op.type == "feed":
                outs.append((op.attr("col") or 0, op.output("Out")[0]))
        return [n for _, n in sorted(outs)]

    def fetch_target_names(self) -> List[str]:
        outs = []
        for op in self.global_block().ops:
            if op.type == "fetch":
                outs.append((op.attr("col") or 0, op.input("X")[0]))
        return [n for _, n in sorted(outs)]

    def persistable_vars(self) -> List[Variable]:
        seen = set()
        out = []
        for v in self.list_vars():
            if v.persistable and v.name not in seen and \
                    v.desc.get("type", {}).get("type") not in (
                        VarType.FEED_MINIBATCH, VarType.FETCH_LIST,
                        VarType.RAW):
                seen.add(v.name)
                out.append(v)
        return out


# ---------------------------------------------------------------------------
# Layer -> Program conversion (sequential topologies)
# ---------------------------------------------------------------------------
def program_from_layer(layer, input_spec, scope: Optional[Dict] = None
                       ) -> "Program":
    """Convert a sequential nn.Layer composition into a ProgramDesc with
    reference op types, collecting parameter values into `scope`.

    Covers the layer set of typical CNN/MLP inference models (Linear,
    Conv2D, BatchNorm2D, LayerNorm, Embedding, ReLU & friends, pooling,
    Flatten, Dropout, Softmax, Sequential/LayerList nesting).  The result
    is loadable by the REFERENCE framework (same op/attr names,
    `operators/*.cc`) and by our own interpreter/Predictor."""
    from .. import nn
    from .input_spec import InputSpec, np_name

    prog = Program()
    block = prog.global_block()
    scope = scope if scope is not None else {}
    counter = [0]

    specs = list(input_spec) if isinstance(input_spec, (list, tuple)) \
        else [input_spec]
    if not all(isinstance(s, InputSpec) for s in specs):
        raise TypeError("input_spec must be InputSpec(s)")
    if len(specs) > 1:
        # multi-input models have no sequential-chain reading — capture
        # by tracing
        return _program_from_layer_traced_multi(layer, specs, scope)
    spec = specs[0]
    in_name = spec.name or "x"
    in_shape = [(-1 if s is None else int(s)) for s in spec.shape]
    in_dtype = np_name(spec.dtype)

    block.create_var("feed", type=VarType.FEED_MINIBATCH, persistable=True)
    block.create_var("fetch", type=VarType.FETCH_LIST, persistable=True)
    block.create_var(in_name, shape=in_shape, dtype=in_dtype,
                     need_check_feed=True)
    block.append_op("feed", {"X": "feed"}, {"Out": in_name}, {"col": 0})

    def fresh(prefix):
        counter[0] += 1
        return f"{prefix}_{counter[0]}.tmp"

    def fresh_var(prefix, dtype="float32"):
        # every op output needs a declared VarDesc: the reference executor
        # creates scope vars from block vars and FindVar-enforces them
        name = fresh(prefix)
        block.create_var(name, dtype=dtype)
        return name

    def add_param(name, tensor):
        arr = tensor.detach().cpu().numpy()
        block.create_var(name, shape=list(arr.shape), dtype=str(arr.dtype),
                         persistable=True)
        scope[name] = arr
        return name

    def emit(ly, x):
        nm = getattr(ly, "_full_name", ly.__class__.__name__.lower())
        if isinstance(ly, (nn.Sequential,)):
            for sub in ly:
                x = emit(sub, x)
            return x
        if isinstance(ly, nn.Linear):
            w = add_param(fresh("w"), ly.weight)
            out = fresh("fc")
            block.create_var(out, dtype="float32")
            block.append_op("matmul_v2", {"X": x, "Y": w}, {"Out": out},
                            {"trans_x": False, "trans_y": False})
            if ly.bias is not None:
                b = add_param(fresh("b"), ly.bias)
                out2 = fresh("fc_bias")
                block.create_var(out2, dtype="float32")
                block.append_op("elementwise_add", {"X": out, "Y": b},
                                {"Out": out2}, {"axis": -1})
                out = out2
            return out
        if isinstance(ly, nn.Conv2D):
            w = add_param(fresh("conv_w"), ly.weight)
            out = fresh("conv")
            block.create_var(out, dtype="float32")
            def pair(v, default):
                v = getattr(ly, v, default)
                return [int(v), int(v)] if isinstance(v, int) else \
                    [int(a) for a in v]

            stride = pair("_stride", 1)
            pad = pair("_padding", 0)
            dil = pair("_dilation", 1)
            block.append_op(
                "conv2d", {"Input": x, "Filter": w}, {"Output": out},
                {"strides": stride, "paddings": pad, "dilations": dil,
                 "groups": int(getattr(ly, "_groups", 1)),
                 "padding_algorithm": "EXPLICIT",
                 "data_format": "NCHW"})
            if ly.bias is not None:
                b = add_param(fresh("conv_b"), ly.bias)
                out2 = fresh("conv_bias")
                block.create_var(out2, dtype="float32")
                block.append_op("elementwise_add", {"X": out, "Y": b},
                                {"Out": out2}, {"axis": 1})
                out = out2
            return out
        if isinstance(ly, (nn.BatchNorm2D, nn.BatchNorm1D)):
            scale = add_param(fresh("bn_scale"), ly.weight)
            bias = add_param(fresh("bn_bias"), ly.bias)
            mean = add_param(fresh("bn_mean"), ly._mean)
            var = add_param(fresh("bn_var"), ly._variance)
            out = fresh("bn")
            block.create_var(out, dtype="float32")
            sm = fresh_var("bn_saved_mean")
            sv = fresh_var("bn_saved_var")
            block.append_op(
                "batch_norm",
                {"X": x, "Scale": scale, "Bias": bias, "Mean": mean,
                 "Variance": var},
                {"Y": out, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": sm, "SavedVariance": sv},
                {"epsilon": float(ly._epsilon), "is_test": True,
                 "data_layout": "NCHW"})
            return out
        if isinstance(ly, nn.LayerNorm):
            # begin_norm_axis: trailing dims are normalized; without full
            # shape inference we support the common normalize-last-axes
            # placement counted from the input spec's rank
            out = fresh("ln")
            block.create_var(out, dtype="float32")
            ins = {"X": x}
            if ly.weight is not None:
                ins["Scale"] = add_param(fresh("ln_scale"), ly.weight)
            if ly.bias is not None:
                ins["Bias"] = add_param(fresh("ln_bias"), ly.bias)
            nshape = getattr(ly, "_normalized_shape", None) or [0]
            begin = max(1, len(in_shape) - len(nshape))
            block.append_op(
                "layer_norm", ins,
                {"Y": out, "Mean": fresh_var("ln_mean"),
                 "Variance": fresh_var("ln_var")},
                {"epsilon": float(ly._epsilon),
                 "begin_norm_axis": int(begin)})
            return out
        if isinstance(ly, nn.Embedding):
            w = add_param(fresh("emb_w"), ly.weight)
            out = fresh("emb")
            block.create_var(out, dtype="float32")
            block.append_op("lookup_table_v2", {"W": w, "Ids": x},
                            {"Out": out}, {"padding_idx": -1})
            return out
        simple = {
            nn.ReLU: ("relu", {}),
            nn.Sigmoid: ("sigmoid", {}),
            nn.Tanh: ("tanh", {}),
            nn.GELU: ("gelu", {}),
            nn.Softmax: ("softmax", {"axis": -1}),
            nn.ReLU6: ("relu6", {}),
            nn.Silu: ("silu", {}),
            nn.Hardswish: ("hard_swish", {}),
        }
        for cls, (op_type, attrs) in simple.items():
            if isinstance(ly, cls):
                out = fresh(op_type)
                block.create_var(out, dtype="float32")
                block.append_op(op_type, {"X": x}, {"Out": out}, attrs)
                return out
        if isinstance(ly, nn.MaxPool2D) or isinstance(ly, nn.AvgPool2D):
            ptype = "max" if isinstance(ly, nn.MaxPool2D) else "avg"
            out = fresh("pool")
            block.create_var(out, dtype="float32")
            k = ly.ksize if hasattr(ly, "ksize") else ly.kernel_size
            k = [k, k] if isinstance(k, int) else list(k)
            s = getattr(ly, "stride", None) or k
            s = [s, s] if isinstance(s, int) else list(s)
            p = getattr(ly, "padding", 0)
            p = [p, p] if isinstance(p, int) else list(p)
            block.append_op("pool2d", {"X": x}, {"Out": out},
                            {"pooling_type": ptype, "ksize": k,
                             "strides": s, "paddings": p,
                             "global_pooling": False, "adaptive": False,
                             "ceil_mode": False, "exclusive": True})
            return out
        if isinstance(ly, nn.AdaptiveAvgPool2D):
            out = fresh("gap")
            block.create_var(out, dtype="float32")
            block.append_op("pool2d", {"X": x}, {"Out": out},
                            {"pooling_type": "avg", "ksize": [1, 1],
                             "strides": [1, 1], "paddings": [0, 0],
                             "global_pooling": True, "adaptive": False,
                             "ceil_mode": False, "exclusive": True})
            return out
        if isinstance(ly, nn.Flatten):
            out = fresh("flatten")
            block.create_var(out, dtype="float32")
            block.append_op("flatten_contiguous_range", {"X": x},
                            {"Out": out, "XShape": fresh_var("xshape")},
                            {"start_axis": int(getattr(ly, "start_axis",
                                                       1)),
                             "stop_axis": int(getattr(ly, "stop_axis",
                                                      -1))})
            return out
        if isinstance(ly, nn.Dropout):
            out = fresh("dropout")
            block.create_var(out, dtype="float32")
            block.append_op(
                "dropout", {"X": x},
                {"Out": out, "Mask": fresh_var("mask", "uint8")},
                {"dropout_prob": float(getattr(ly, "p", 0.5)),
                 "is_test": True,
                 "dropout_implementation": "upscale_in_train"})
            return out
        raise NotImplementedError(
            f"program_from_layer: no ProgramDesc emitter for "
            f"{ly.__class__.__name__} (wrap unsupported layers or use "
            "paddle_tpu_torch.jit.save for the torch.export deployable format)")

    # walk: a bare Layer whose children form a pipeline, or one with a
    # custom forward is only convertible if it IS Sequential-like
    if isinstance(layer, nn.Sequential):
        out_name = emit(layer, in_name)
    else:
        # chaining the children is only faithful when forward() IS that
        # chain; a custom forward (functional ops, branching) is
        # captured by TRACING instead (torch.export -> ProgramDesc,
        # static/fx_export.py) — any exportable model exports
        if type(layer).forward is not nn.Layer.forward:
            return _program_from_layer_traced(layer, spec, scope,
                                              in_name)
        children = [ly for _, ly in layer.named_children()]
        if not children:
            raise NotImplementedError("layer has no convertible structure")
        out_name = in_name
        for ly in children:
            out_name = emit(ly, out_name)
    block.append_op("fetch", {"X": out_name}, {"Out": "fetch"}, {"col": 0})
    return prog


def _program_from_layer_traced_multi(layer, specs, scope,
                                     names=None):
    """Traced capture for layers with any number of inputs (the ONE
    trace-capture path; the single-input helper delegates here): every
    input becomes a feed target."""
    import torch

    from .fx_export import program_from_traced
    from .input_spec import np_name

    names = list(names) if names else \
        [s.name or f"input_{i}" for i, s in enumerate(specs)]
    reserved = {"feed", "fetch"}
    if len(set(names)) != len(names) or reserved & set(names):
        raise ValueError(
            f"program_from_layer: input names {names} must be unique "
            "and must not use the reserved names 'feed'/'fetch' (a "
            "collision would silently alias feeds)")
    device = next((t.device for t in list(layer.parameters())
                   + list(layer.buffers())), torch.device("cpu"))
    examples = []
    for i, spec in enumerate(specs):
        if any(s in (-1, None) for s in spec.shape):
            raise NotImplementedError(
                "program_from_layer: traced export needs concrete "
                f"shapes; InputSpec[{i}] has a dynamic dim "
                f"{list(spec.shape)}")
        examples.append(torch.zeros([int(s) for s in spec.shape],
                                    dtype=getattr(torch, np_name(
                                        spec.dtype)), device=device))

    was_training = layer.training
    layer.eval()
    try:
        prog = program_from_traced(layer, examples, scope,
                                   input_names=names)
    finally:
        if was_training:
            layer.train()
    return prog


def _program_from_layer_traced(layer, spec, scope, in_name):
    """Single-input traced capture — delegates to the multi-input
    helper (one implementation to maintain)."""
    return _program_from_layer_traced_multi(layer, [spec], scope,
                                            names=[in_name])
