"""The port's ProgramDesc stack against the JAX package's
(`paddle_tpu_torch/static/{proto,op_version,program,interp,op_bridge}.py`).

- The interpreter and its bridge run exactly the JAX registry's op types
  (neither registers a ``*_grad`` op; static training is the next
  slice), with the same data-dependent-shape set and the same
  ``PROGRAM_FORM_NA`` table.
- The wire codec is the JAX package's byte for byte: a program and
  LoDTensor records the JAX package writes parse in the port and
  serialize back to the same bytes, and both packages write the same
  bytes for the same program and arrays.
- The op-version upgraders change an old program's descs as the JAX
  package's do.
- The op sweep: every op type of the registry, on the OpDescs the JAX
  interpreter tests build (recorded op by op, `tests/
  torch_static_common.py`) and on `tests/torch_static_cases.py` for the
  types those tests reach only under jit; each case runs through the
  JAX translator and the port's on the same inputs.  Values agree within
  rtol 1e-4 / atol 1e-5 in f32 (exact for integers and booleans; the
  JAX package keeps 32-bit integers where the port keeps 64); random
  ops hold shapes and dtypes (torch's draws are not JAX's); a case the
  JAX translator refuses, the port refuses too.

The harvest runs the JAX interpreter tests once a run (about a minute:
`tests/torch_static_common.py`); the file takes 95-120 s alone, and
under ``-n 6`` one worker harvests while the others wait for it (the
four new files of the slice together: 138 s).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax  # noqa: F401
from paddle_tpu.static import interp as JI
from paddle_tpu.static import op_bridge as JB
from paddle_tpu.static import op_version as JV
from paddle_tpu.static import proto as JP
from paddle_tpu.static.program import Program as JProgram

from paddle_tpu_torch.static import interp as TI
from paddle_tpu_torch.static import op_bridge as TB
from paddle_tpu_torch.static import op_version as TV
from paddle_tpu_torch.static import proto as TP
from paddle_tpu_torch.static.program import Program as TProgram

from torch_static_common import RANDOM_OPS, compare, replay, shared_harvest

OP_TYPES = sorted(JI.OP_TRANSLATORS)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_registry_is_the_jax_registry_less_grad_ops():
    jax_types = {t for t in JI.OP_TRANSLATORS if not t.endswith("_grad")}
    assert set(TI.OP_TRANSLATORS) == jax_types
    assert not any(t.endswith("_grad") for t in TI.OP_TRANSLATORS)
    assert TI.DYNAMIC_SHAPE_OPS == JI.DYNAMIC_SHAPE_OPS
    assert TB.PROGRAM_FORM_NA == JB.PROGRAM_FORM_NA
    assert set(TB.BRIDGED) == set(JB.BRIDGED)


def test_grad_op_names_the_next_slice():
    desc = {"type": "mul_grad", "inputs": [], "outputs": [],
            "attrs": [{"name": "__forward_op__", "type": TP.AttrType.STRING,
                       "s": "{}"}]}
    with TI.blocks_context([{"ops": [desc]}]):
        with pytest.raises(NotImplementedError, match="4b"):
            TI.run_block([desc], TI.Scope(), {}, {})


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
def _every_attr_program(P):
    """A program with one attr of every AttrType, sub-blocks, negative
    and 64-bit values, and the var kinds the reference uses."""
    prog = P()
    blk = prog.global_block()
    blk.create_var("feed", type=TP.VarType.FEED_MINIBATCH, persistable=True)
    blk.create_var("fetch", type=TP.VarType.FETCH_LIST, persistable=True)
    blk.create_var("x", shape=[-1, 4], dtype="float32",
                   need_check_feed=True)
    blk.create_var("w", shape=[4, 3], dtype="float32", persistable=True)
    blk.create_var("ids", shape=[-1], dtype="int64")
    sub = prog.create_block(0)
    sub.create_var("t", shape=[2], dtype="int32")
    blk.append_op("feed", {"X": "feed"}, {"Out": "x"}, {"col": 0})
    blk.append_op("matmul_v2", {"X": "x", "Y": "w"}, {"Out": "y"},
                  {"trans_x": False, "trans_y": True, "alpha": -0.75,
                   "name": "mm", "shape": [-1, 2 ** 20, 3],
                   "scales": [0.5, -1.25], "tags": ["a", "b"],
                   "flags": [True, False], "big": 2 ** 40,
                   "neg": -(2 ** 33)})
    op = blk.append_op("while", {"X": ["y"], "Condition": "c"},
                       {"Out": ["y"]}, {"is_test": True})
    op.desc["attrs"].append({"name": "sub_block",
                             "type": TP.AttrType.BLOCK, "block_idx": 1})
    op.desc["attrs"].append({"name": "longs", "type": TP.AttrType.LONGS,
                             "longs": [-1, 2 ** 45]})
    op.desc["attrs"].append({"name": "f64", "type": TP.AttrType.FLOAT64S,
                             "float64s": [0.1, -2.5e300]})
    blk.append_op("fetch", {"X": "y"}, {"Out": "fetch"}, {"col": 0})
    return prog


def test_program_bytes_roundtrip_and_match():
    jbytes = _every_attr_program(JProgram).serialize_to_string()
    tbytes = _every_attr_program(TProgram).serialize_to_string()
    assert tbytes == jbytes
    # JAX's bytes parse in the port and serialize back unchanged
    assert TP.serialize_program(TP.parse_program(jbytes)) == jbytes
    assert TProgram.parse_from_string(jbytes).serialize_to_string() == \
        jbytes
    assert TP.parse_program(jbytes) == JP.parse_program(jbytes)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "int8", "uint8", "bool", "float16"])
def test_lod_tensor_records_match(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 4)) * 10).astype(dtype)
    for lod in (None, [[0, 1, 3]], [[0, 2, 3], [0, 1, 2, 3]]):
        jb = JP.write_lod_tensor(arr, lod)
        assert TP.write_lod_tensor(arr, lod) == jb
        got, got_lod, pos = TP.read_lod_tensor(jb, 0)
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == arr.dtype and pos == len(jb)
        assert got_lod == (lod or [])


def test_empty_and_scalar_records_match():
    for arr in (np.zeros((0, 3), np.float32), np.float32(2.5).reshape(())):
        jb = JP.write_lod_tensor(arr)
        assert TP.write_lod_tensor(arr) == jb
        got, _, _ = TP.read_lod_tensor(jb)
        want, _, _ = JP.read_lod_tensor(jb)
        assert got.shape == want.shape and got.dtype == want.dtype


# ---------------------------------------------------------------------------
# op versions
# ---------------------------------------------------------------------------
def _old_program(P, optype):
    prog = P()
    blk = prog.global_block()
    attrs = {"alpha": 2.0} if optype == "leaky_relu" else {"axis": 0}
    ins = {"X": "x"}
    outs = {"Out": "y"}
    if optype == "roi_align":
        ins = {"X": "x", "ROIs": "r", "RpnRoisLod": "l"}
    if optype == "generate_proposals":
        outs = {"RpnRois": "y", "RpnRoisLod": "l"}
    blk.append_op(optype, ins, outs, attrs)
    return prog.desc  # no op_version_map: a pre-registry program


@pytest.mark.parametrize("optype", sorted(JV.UPGRADERS))
def test_upgrades_match_jax(optype):
    from paddle_tpu_torch.static import proto as P

    raw = P.serialize_program(_old_program(TProgram, optype))
    jp = JProgram.parse_from_string(raw)
    tp = TProgram.parse_from_string(raw)
    assert tp.desc == jp.desc
    assert tp.serialize_to_string() == jp.serialize_to_string()
    assert TV.upgrade_program(tp.desc) == JV.upgrade_program(jp.desc)


def test_legacy_leaky_relu_runs_the_old_formula():
    raw = TP.serialize_program(_old_program(TProgram, "leaky_relu"))
    ops = TProgram.parse_from_string(raw).desc["blocks"][0]["ops"]
    x = torch.tensor([-1.0, 2.0])
    scope = TI.Scope({"x": x})
    with TI.blocks_context([{"ops": ops}]):
        TI.run_block(ops, scope, {}, {})
    # max(x, 2x): the pre-version-1 formula, not where(x > 0, x, 2x)
    assert scope["y"].tolist() == [-1.0, 4.0]


# ---------------------------------------------------------------------------
# the op sweep
# ---------------------------------------------------------------------------
@pytest.fixture(scope="session")
def op_cases(tmp_path_factory):
    return shared_harvest(tmp_path_factory)


def _box_clip_rows(case):
    """box_clip with the reference's batched ImInfo [N, 3]: the JAX
    package reads im_info[1] and [2] of a one-row array, which jnp clamps
    to row 0 (its result then has a wrong shape); the port's read of a
    missing row raises.  A by-design difference (ROADMAP.md Queue 3)."""
    im = [v for k, v in case["ins"].items() if k.startswith("iminfo")]
    return im and im[0][1].ndim == 2


def _py_func_case():
    """py_func's registry is process-local (as the reference's): the
    same callable registered in both packages' registries."""
    from test_op_bridge import _encode_attr
    from torch_static_cases import Case

    def fn(a, b):
        return a * 2 + b, np.tanh(a)

    jid = JB.register_py_func(fn)
    tid = TB.register_py_func(fn)
    c = Case("py_func", {"X": [np.arange(6, dtype=np.float32).reshape(2, 3),
                               np.ones((2, 3), np.float32)]},
             {"forward_callable_id": jid}, outs=("Out*2",))
    from torch_static_common import run_jax_case

    case = run_jax_case(c)
    case["desc"]["attrs"] = [_encode_attr("forward_callable_id", tid)]
    return case


def _compare_perspective(case, got):
    """roi_perspective_transform's crossing-number in-quad test decides
    each output pixel by float comparisons against the quad's edges: a
    pixel centre within rounding of an edge may fall inside in one
    package and outside in the other.  Pixels inside in both agree
    within the sweep's tolerance; at most 5% of pixels may flip."""
    (mk,) = [k for k in case["outs"] if k.startswith("mask")]
    (ok,) = [k for k in case["outs"] if k.startswith("out_")]
    jm, tm = case["outs"][mk][1], got[mk][1]
    assert jm.shape == tm.shape
    assert (jm != tm).mean() <= 0.05, (jm != tm).mean()
    both = np.broadcast_to((jm == 1) & (tm == 1), case["outs"][ok][1].shape)
    np.testing.assert_allclose(got[ok][1][both], case["outs"][ok][1][both],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("optype", OP_TYPES)
def test_op_matches_jax(optype, op_cases):
    cases = op_cases.get(optype)
    assert cases, f"no case reaches {optype!r}"
    if optype == "py_func":
        cases = [_py_func_case()]
    for case in cases:
        if optype == "box_clip" and _box_clip_rows(case):
            with pytest.raises(IndexError):
                replay(case)
            continue
        if "raises" in case:
            with pytest.raises(Exception):
                replay(case)
            continue
        got = replay(case)
        if optype == "roi_perspective_transform":
            _compare_perspective(case, got)
            continue
        compare(case, got, values=optype not in RANDOM_OPS)
