"""Bit-compatible reader/writer for the reference ProgramDesc format
(a copy of paddle_tpu/static/proto.py: host-only, byte for byte the same
encoder, so both packages write the same bytes).

Reference interchange contract: `paddle/fluid/framework/framework.proto`
(proto2, package paddle.framework.proto) — ProgramDesc -> BlockDesc ->
OpDesc/VarDesc with the AttrType and VarType.Type enums (SURVEY.md
Appendix C).  Reference-era `.pdmodel` / `__model__` files and the
LoDTensor payloads of `.pdiparams` / `__params__` must round-trip through
here byte-for-byte.

Implementation: a small hand-rolled protobuf *wire format* codec (varint /
64-bit / length-delimited / 32-bit) plus the message schemas as data
tables keyed by field number.  No generated code, no protobuf runtime
dependency — the field numbers ARE the contract, the schema tables below
restate them.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# enums (framework.proto values)
# ---------------------------------------------------------------------------


class AttrType:
    INT = 0
    FLOAT = 1
    STRING = 2
    INTS = 3
    FLOATS = 4
    STRINGS = 5
    BOOLEAN = 6
    BOOLEANS = 7
    BLOCK = 8
    LONG = 9
    BLOCKS = 10
    LONGS = 11
    FLOAT64S = 12


class VarType:
    # POD dtypes
    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    SIZE_T = 19
    UINT8 = 20
    INT8 = 21
    BF16 = 22
    COMPLEX64 = 23
    COMPLEX128 = 24
    # container types
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18


# numpy dtype <-> VarType POD code
_NP_TO_VT = {
    "bool": VarType.BOOL, "int16": VarType.INT16, "int32": VarType.INT32,
    "int64": VarType.INT64, "float16": VarType.FP16,
    "float32": VarType.FP32, "float64": VarType.FP64,
    "uint8": VarType.UINT8, "int8": VarType.INT8,
    "bfloat16": VarType.BF16, "complex64": VarType.COMPLEX64,
    "complex128": VarType.COMPLEX128,
}
_VT_TO_NP = {v: k for k, v in _NP_TO_VT.items()}


def np_dtype_to_vartype(dtype) -> int:
    return _NP_TO_VT[str(dtype)]


def vartype_to_np_dtype(vt: int) -> str:
    return _VT_TO_NP[vt]


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _w_varint(out: bytearray, v: int):
    if v < 0:  # proto int32/int64 negative -> 10-byte two's complement
        v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _r_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed32(v: int) -> int:
    v &= (1 << 64) - 1
    v = v & 0xFFFFFFFF if v < (1 << 32) else v & (1 << 64) - 1
    v = _signed64(v)
    if v > 0x7FFFFFFF:
        v -= 1 << 32
    return v


def _w_tag(out: bytearray, field: int, wt: int):
    _w_varint(out, (field << 3) | wt)


# ---------------------------------------------------------------------------
# schema tables: field -> (name, kind, repeated, [submessage])
# kinds: int32 int64 uint64 bool float double string enum msg
# ---------------------------------------------------------------------------
_S = {
    "Version": {1: ("version", "int64", False)},
    "OpDesc.Attr": {
        1: ("name", "string", False),
        2: ("type", "enum", False),
        3: ("i", "int32", False),
        4: ("f", "float", False),
        5: ("s", "string", False),
        6: ("ints", "int32", True),
        7: ("floats", "float", True),
        8: ("strings", "string", True),
        10: ("b", "bool", False),
        11: ("bools", "bool", True),
        12: ("block_idx", "int32", False),
        13: ("l", "int64", False),
        14: ("blocks_idx", "int32", True),
        15: ("longs", "int64", True),
        16: ("float64s", "double", True),
    },
    "OpDesc.Var": {
        1: ("parameter", "string", False),
        2: ("arguments", "string", True),
    },
    "OpDesc": {
        1: ("inputs", "msg", True, "OpDesc.Var"),
        2: ("outputs", "msg", True, "OpDesc.Var"),
        3: ("type", "string", False),
        4: ("attrs", "msg", True, "OpDesc.Attr"),
        5: ("is_target", "bool", False),
    },
    "VarType.TensorDesc": {
        1: ("data_type", "enum", False),
        2: ("dims", "int64", True),
    },
    "VarType.LoDTensorDesc": {
        1: ("tensor", "msg", False, "VarType.TensorDesc"),
        2: ("lod_level", "int32", False),
    },
    "VarType.LoDTensorArrayDesc": {
        1: ("tensor", "msg", False, "VarType.TensorDesc"),
        2: ("lod_level", "int32", False),
    },
    "VarType.ReaderDesc": {
        1: ("lod_tensor", "msg", True, "VarType.LoDTensorDesc"),
    },
    "VarType.Tuple": {1: ("element_type", "enum", True)},
    "VarType": {
        1: ("type", "enum", False),
        2: ("selected_rows", "msg", False, "VarType.TensorDesc"),
        3: ("lod_tensor", "msg", False, "VarType.LoDTensorDesc"),
        4: ("tensor_array", "msg", False, "VarType.LoDTensorArrayDesc"),
        5: ("reader", "msg", False, "VarType.ReaderDesc"),
        7: ("tuple", "msg", False, "VarType.Tuple"),
    },
    "VarDesc": {
        1: ("name", "string", False),
        2: ("type", "msg", False, "VarType"),
        3: ("persistable", "bool", False),
        4: ("need_check_feed", "bool", False),
    },
    "BlockDesc": {
        1: ("idx", "int32", False),
        2: ("parent_idx", "int32", False),
        3: ("vars", "msg", True, "VarDesc"),
        4: ("ops", "msg", True, "OpDesc"),
        5: ("forward_block_idx", "int32", False),
    },
    "OpVersion": {1: ("version", "int32", False)},
    "OpVersionMap.OpVersionPair": {
        1: ("op_name", "string", False),
        2: ("op_version", "msg", False, "OpVersion"),
    },
    "OpVersionMap": {
        1: ("pair", "msg", True, "OpVersionMap.OpVersionPair"),
    },
    "ProgramDesc": {
        1: ("blocks", "msg", True, "BlockDesc"),
        4: ("version", "msg", False, "Version"),
        5: ("op_version_map", "msg", False, "OpVersionMap"),
    },
}

# field emission order: proto encoders conventionally write by ascending
# field number; the reference's C++ protobuf does the same, which keeps
# our bytes comparable with protoc-generated ones
_ORDERED = {m: sorted(f.items()) for m, f in _S.items()}


def decode(msg_name: str, buf: bytes, start: int = 0,
           end: Optional[int] = None) -> Dict[str, Any]:
    """Parse wire bytes into a dict (repeated fields become lists)."""
    schema = _S[msg_name]
    out: Dict[str, Any] = {}
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        key, pos = _r_varint(buf, pos)
        field, wt = key >> 3, key & 7
        spec = schema.get(field)
        if spec is None:  # unknown field: skip per wire type
            if wt == _WT_VARINT:
                _, pos = _r_varint(buf, pos)
            elif wt == _WT_I64:
                pos += 8
            elif wt == _WT_LEN:
                ln, pos = _r_varint(buf, pos)
                pos += ln
            elif wt == _WT_I32:
                pos += 4
            else:
                raise ValueError(f"bad wire type {wt} in {msg_name}")
            continue
        name, kind, repeated = spec[0], spec[1], spec[2]
        if kind == "msg":
            ln, pos = _r_varint(buf, pos)
            val = decode(spec[3], buf, pos, pos + ln)
            pos += ln
        elif kind == "string":
            ln, pos = _r_varint(buf, pos)
            val = buf[pos:pos + ln].decode("utf-8", errors="surrogateescape")
            pos += ln
        elif kind == "float":
            if wt == _WT_LEN:  # packed
                ln, pos = _r_varint(buf, pos)
                vals = list(struct.unpack_from(f"<{ln // 4}f", buf, pos))
                pos += ln
                out.setdefault(name, []).extend(vals)
                continue
            val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif kind == "double":
            if wt == _WT_LEN:
                ln, pos = _r_varint(buf, pos)
                vals = list(struct.unpack_from(f"<{ln // 8}d", buf, pos))
                pos += ln
                out.setdefault(name, []).extend(vals)
                continue
            val = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        else:  # varint family: int32 int64 bool enum
            if wt == _WT_LEN and repeated:  # packed repeated varints
                ln, pos = _r_varint(buf, pos)
                stop = pos + ln
                while pos < stop:
                    raw, pos = _r_varint(buf, pos)
                    out.setdefault(name, []).append(
                        _coerce_varint(kind, raw))
                continue
            raw, pos = _r_varint(buf, pos)
            val = _coerce_varint(kind, raw)
        if repeated:
            out.setdefault(name, []).append(val)
        else:
            out[name] = val
    return out


def _coerce_varint(kind: str, raw: int):
    if kind == "bool":
        return bool(raw)
    if kind == "int32":
        return _signed32(raw)
    if kind == "int64":
        return _signed64(raw)
    return raw  # enum / uint


def encode(msg_name: str, obj: Dict[str, Any]) -> bytes:
    """Serialize a dict (as produced by decode) back to wire bytes."""
    out = bytearray()
    for field, spec in _ORDERED[msg_name]:
        name, kind, repeated = spec[0], spec[1], spec[2]
        if name not in obj or obj[name] is None:
            continue
        vals = obj[name] if repeated else [obj[name]]
        for v in vals:
            if kind == "msg":
                sub = encode(spec[3], v)
                _w_tag(out, field, _WT_LEN)
                _w_varint(out, len(sub))
                out += sub
            elif kind == "string":
                data = v.encode("utf-8", errors="surrogateescape") \
                    if isinstance(v, str) else bytes(v)
                _w_tag(out, field, _WT_LEN)
                _w_varint(out, len(data))
                out += data
            elif kind == "float":
                _w_tag(out, field, _WT_I32)
                out += struct.pack("<f", float(v))
            elif kind == "double":
                _w_tag(out, field, _WT_I64)
                out += struct.pack("<d", float(v))
            elif kind == "bool":
                _w_tag(out, field, _WT_VARINT)
                _w_varint(out, 1 if v else 0)
            else:  # int32/int64/enum
                _w_tag(out, field, _WT_VARINT)
                _w_varint(out, int(v))
    return bytes(out)


def parse_program(data: bytes) -> Dict[str, Any]:
    return decode("ProgramDesc", data)


def serialize_program(prog: Dict[str, Any]) -> bytes:
    return encode("ProgramDesc", prog)


# ---------------------------------------------------------------------------
# LoDTensor payload streams (save_op / .pdiparams records)
# ---------------------------------------------------------------------------
def write_lod_tensor(arr, lod: Optional[List[List[int]]] = None) -> bytes:
    """Serialize one array in the reference `SerializeToStream` layout:
    u32 version | u64 lod_level | per-level (u64 nbytes + u64 offsets) |
    u32 version | i32 desc_len | TensorDesc proto | raw data
    (`framework/lod_tensor.cc:244`, `tensor_util.cc:771`)."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    out = bytearray()
    out += struct.pack("<I", 0)  # LoDTensor version
    lod = lod or []
    out += struct.pack("<Q", len(lod))
    for level in lod:
        level_arr = np.asarray(level, np.uint64)
        out += struct.pack("<Q", level_arr.nbytes)
        out += level_arr.tobytes()
    out += struct.pack("<I", 0)  # Tensor version
    desc = encode("VarType.TensorDesc", {
        "data_type": np_dtype_to_vartype(arr.dtype),
        "dims": [int(d) for d in arr.shape],
    })
    out += struct.pack("<i", len(desc))
    out += desc
    out += arr.tobytes()
    return bytes(out)


def read_lod_tensor(buf: bytes, pos: int = 0):
    """Parse one SerializeToStream record; returns (array, lod, new_pos)."""
    import numpy as np

    (ver,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if ver != 0:
        raise ValueError(f"unsupported LoDTensor version {ver}")
    (lod_level,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        level = np.frombuffer(buf, np.uint64, count=nbytes // 8,
                              offset=pos)
        lod.append([int(x) for x in level])
        pos += nbytes
    (tver,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if tver != 0:
        raise ValueError(f"unsupported Tensor version {tver}")
    (desc_len,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    desc = decode("VarType.TensorDesc", buf, pos, pos + desc_len)
    pos += desc_len
    dtype = np.dtype(vartype_to_np_dtype(desc["data_type"]))
    dims = desc.get("dims", [])
    count = 1
    for d in dims:
        count *= int(d)
    arr = np.frombuffer(buf, dtype, count=count, offset=pos).reshape(dims)
    pos += count * dtype.itemsize
    return arr.copy(), lod, pos
