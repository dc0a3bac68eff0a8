"""Op-level cases of the JAX interpreter, replayed on the port's.

`harvest()` runs the JAX package's interpreter tests (`tests/
test_op_bridge.py`, `test_op_bridge_sweep.py`, `test_interp_*.py`,
`test_op_version.py`) with every translator of
`paddle_tpu.static.interp.OP_TRANSLATORS` wrapped: each call whose inputs
are concrete arrays is recorded as a case — the OpDesc, its input values
(with their ``@LOD`` sidecars), the desc-level constants in force, the
program's blocks for sub-block ops, and what the JAX translator wrote (or
that it raised).  `replay(case)` runs the same OpDesc on the same inputs
through the port's translator on the CPU and returns what it wrote.

Harvesting takes about a minute; under pytest-xdist one worker harvests
into a pickle beside the run's base temp directory and the others load
it (`shared_harvest`).
"""
from __future__ import annotations

import copy
import fcntl
import inspect
import itertools
import os
import pickle
import tempfile
import pathlib

import numpy as np

HARVESTED_MODULES = ("test_op_bridge", "test_op_bridge_sweep",
                     "test_interp_sequence_ops", "test_interp_control_flow",
                     "test_interp_training_ops", "test_op_version")

# ops whose values come from a random generator: the port's draws are
# torch's, so a case compares shapes and dtypes only
RANDOM_OPS = {"bernoulli", "multinomial", "sampling_id", "randint",
              "randperm", "gaussian_random", "uniform_random",
              "gaussian_random_batch_size_like",
              "uniform_random_batch_size_like",
              "truncated_gaussian_random", "dpsgd", "shuffle_batch",
              "random_crop", "nce", "sample_logits", "tdm_sampler",
              "pyramid_hash"}


def _snap(v):
    """A JAX scope value as plain data, or None when it is not concrete
    (a tracer under jit)."""
    import jax
    from paddle_tpu.static import interp as J

    if isinstance(v, jax.core.Tracer):
        return None
    if isinstance(v, J.TensorArrayVal):
        buf, n = _snap(v.buffer), _snap(v.length)
        if buf is None or n is None:
            return None
        return ("TA", buf[1], int(np.asarray(n[1]).reshape(())))
    if isinstance(v, J.RankTableVal):
        idx, ln = _snap(v.idx), _snap(v.lengths)
        if idx is None or ln is None:
            return None
        return ("RT", idx[1], ln[1], v.t_max)
    try:
        # a copy: a view of a JAX buffer sees the memory reused later
        return ("A", np.array(v, copy=True))
    except Exception:
        return None


_DEPTH = [0]


def _record_call(fn, op, scope, feeds, fetches, sink):
    """Record one translator call (the outermost only: a translator that
    calls another, as inplace_abn calls batch_norm, is one case)."""
    if _DEPTH[0]:
        return fn(op, scope, feeds, fetches)
    _DEPTH[0] += 1
    try:
        _record_outer(fn, op, scope, feeds, fetches, sink)
    finally:
        _DEPTH[0] -= 1


def _record_outer(fn, op, scope, feeds, fetches, sink):
    from paddle_tpu.static import interp as J

    # inputs, and outputs the op updates in place (a TensorArray written
    # at an index, a while's carries)
    names = [a for args in list(op._in.values()) + list(op._out.values())
             for a in args]
    if op.attr("sub_block") is not None or op.type in ("while",
                                                       "recurrent"):
        names = list(dict.keys(scope))  # sub-blocks read the outer scope
    names = names + [n + "@LOD" for n in names if n + "@LOD" in scope]
    ins = {}
    ok = True
    for n in names:
        if n not in scope:
            continue
        s = _snap(scope[n])
        if s is None:
            ok = False
            break
        ins[n] = s
    fd = {}
    for k, v in feeds.items():
        s = _snap(v)
        if s is None:
            ok = False
            break
        fd[k] = s
    case = None
    if ok:
        case = dict(type=op.type, label=op.type, desc=copy.deepcopy(op.desc), ins=ins,
                    feeds=fd,
                    consts={k: np.array(v, copy=True) for k, v in
                            J._consts().items()},
                    bounds=dict(J._consts_bounds()),
                    blocks=copy.deepcopy(getattr(J._BLOCKS_TLS, "blocks",
                                                 None)))
    try:
        fn(op, scope, feeds, fetches)
    except Exception as e:
        if case is not None:
            case["raises"] = type(e).__name__
            sink.append(case)
        raise
    if case is None:
        return
    outs = {}
    for n in [a for args in op._out.values() for a in args]:
        for key in (n, n + "@LOD"):
            if key in scope:
                s = _snap(scope[key])
                if s is None:
                    return
                outs[key] = s
    case["outs"] = outs
    sink.append(case)


def _calls(fn, tmp_dir):
    """The argument sets pytest would call ``fn`` with (its parametrize
    marks, and a fresh ``tmp_path`` under ``tmp_dir``); None for other
    fixtures."""
    params = [p for p in inspect.signature(fn).parameters
              if p != "self"]
    grids = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = [n.strip() for n in (mark.args[0].split(",")
                     if isinstance(mark.args[0], str) else mark.args[0])]
            rows = [r if len(names) > 1 else (r,) for r in mark.args[1]]
            grids.append([dict(zip(names, r)) for r in rows])
    out = []
    for combo in itertools.product(*grids) if grids else [()]:
        kw = {}
        for d in combo:
            kw.update(d)
        for p in params:
            if p == "tmp_path":
                kw[p] = pathlib.Path(tempfile.mkdtemp(prefix="harvest_",
                                                      dir=tmp_dir))
            elif p not in kw:
                return None
        out.append(kw)
    return out


def harvest(tmp_dir):
    """{op type: [case, ...]} over the JAX interpreter tests (their files
    written under ``tmp_dir``)."""
    import importlib

    from paddle_tpu.static import interp as J

    sink = []
    originals = dict(J.OP_TRANSLATORS)
    # the interpreter tests run programs through ProgramRunner, jitted by
    # default: record them op by op (ProgramRunner(jit=False), the form
    # the port's eager runner matches)
    runner_init = J.ProgramRunner.__init__

    def eager_init(self, program, scope, jit=True, donate_feeds=False):
        runner_init(self, program, scope, jit=False)

    J.ProgramRunner.__init__ = eager_init
    for name, fn in originals.items():
        def wrapped(op, scope, feeds, fetches, _fn=fn):
            _record_call(_fn, op, scope, feeds, fetches, sink)
        J.OP_TRANSLATORS[name] = wrapped
    try:
        for modname in HARVESTED_MODULES:
            mod = importlib.import_module(modname)
            for attr in dir(mod):
                obj = getattr(mod, attr)
                tests = []
                if inspect.isclass(obj) and attr.startswith("Test"):
                    for m in dir(obj):
                        if m.startswith("test_"):
                            tests.append((obj, getattr(obj, m)))
                elif attr.startswith("test_") and callable(obj):
                    tests.append((None, obj))
                for cls, fn in tests:
                    for kw in _calls(fn, tmp_dir) or []:
                        try:
                            if cls is None:
                                fn(**kw)
                            else:
                                getattr(cls(), fn.__name__)(**kw)
                        except KeyboardInterrupt:
                            raise
                        except BaseException:
                            # pytest's outcomes too: the JAX test's own
                            # verdict is its file's
                            pass
    finally:
        J.ProgramRunner.__init__ = runner_init
        J.OP_TRANSLATORS.clear()
        J.OP_TRANSLATORS.update(originals)
    by_type = {}
    for c in sink:
        by_type.setdefault(c["type"], []).append(c)
    return by_type


def shared_harvest(tmp_path_factory):
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = (tmp_path_factory.getbasetemp().parent / f"torch_static_{uid}"
            if uid else tmp_path_factory.getbasetemp() / "torch_static")
    base.mkdir(parents=True, exist_ok=True)
    path = base / "harvest.pkl"
    with open(base / "harvest.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            from torch_static_cases import extra_cases

            cases = harvest(str(base))
            for c in extra_cases():
                case = run_jax_case(c)
                cases.setdefault(case["type"], []).append(case)
            with open(path, "wb") as f:
                pickle.dump(cases, f)
    with open(path, "rb") as f:
        return pickle.load(f)


def run_jax_case(c):
    """A `torch_static_cases.Case` through the JAX translator, recorded
    as a harvested case (named as `test_op_bridge.bridge_run` names
    arguments)."""
    import jax.numpy as jnp
    from paddle_tpu.static import interp as J
    from test_op_bridge import _encode_attr

    scope = J.Scope()
    desc_in, desc_out = [], []

    def put(name, v):
        if isinstance(v, tuple) and v[0] == "RT":
            scope[name] = J.RankTableVal(jnp.asarray(v[1]),
                                         jnp.asarray(v[2]), v[3])
        else:
            scope[name] = jnp.asarray(v)

    for p, v in c.ins.items():
        if isinstance(v, list):
            names = [f"{p.lower()}_{i}" for i in range(len(v))]
            for n, a in zip(names, v):
                put(n, a)
        else:
            names = [p.lower() + "_v"]
            put(names[0], v)
        if p in c.lods:
            scope[names[0] + "@LOD"] = jnp.asarray(c.lods[p])
        desc_in.append({"parameter": p, "arguments": names})
    for o in c.outs:
        p, _, k = o.partition("*")
        desc_out.append({"parameter": p, "arguments": [
            f"{p.lower()}_out_{i}" for i in range(int(k or 1))]})
    desc = {"type": c.type, "inputs": desc_in, "outputs": desc_out,
            "attrs": [_encode_attr(k, v) for k, v in c.attrs.items()]}
    blocks = [{"ops": [desc]}]
    if c.sub is not None:
        blocks.append({"ops": [
            {"type": t, "inputs": [{"parameter": k, "arguments": [v]}
                                   for k, v in ins.items()],
             "outputs": [{"parameter": k, "arguments": [v]}
                         for k, v in outs.items()],
             "attrs": [_encode_attr(k, v) for k, v in attrs.items()]}
            for t, ins, outs, attrs in c.sub]})
        for a in desc["attrs"]:
            if a["name"] == "sub_block":
                from paddle_tpu.static.proto import AttrType

                a.clear()
                a.update(name="sub_block", type=AttrType.BLOCK,
                         block_idx=1)
    sink = []
    with J.blocks_context(blocks):
        try:
            _record_call(J.OP_TRANSLATORS[c.type], J.OpView(desc), scope,
                         {}, {}, sink)
        except Exception:
            pass  # recorded with "raises"
    case = sink[0]
    case["label"] = c.label
    if c.sub is not None:
        case["blocks"] = copy.deepcopy(blocks)
    return case


# ---------------------------------------------------------------------------
# replay on the port
# ---------------------------------------------------------------------------
def _to_port(s):
    import torch
    from paddle_tpu_torch.static import interp as T

    kind = s[0]
    if kind == "TA":
        return T.TensorArrayVal(torch.from_numpy(np.array(s[1])), s[2])
    if kind == "RT":
        return T.RankTableVal(torch.from_numpy(np.array(s[1])),
                              torch.from_numpy(np.array(s[2])), s[3])
    return torch.from_numpy(np.array(s[1]))


def replay(case):
    """Run the case's OpDesc through the port's translator; returns
    ``{name: snapshot}`` of what it wrote to the case's output names."""
    import torch
    from paddle_tpu_torch.static import interp as T

    scope = T.Scope({k: _to_port(v) for k, v in case["ins"].items()})
    feeds = {k: _to_port(v) for k, v in case["feeds"].items()}
    blocks = case["blocks"] or [{"ops": [case["desc"]]}]
    with T.blocks_context(blocks, "cpu"):
        T._consts().update(case["consts"])
        T._consts_bounds().update(case["bounds"])
        T.OP_TRANSLATORS[case["type"]](T.OpView(case["desc"]), scope,
                                       feeds, {})
    out = {}
    for key in case.get("outs", {}):
        if key in scope:
            v = scope[key]
            if isinstance(v, T.TensorArrayVal):
                out[key] = ("TA", v.buffer.numpy(), v.length)
            elif isinstance(v, T.RankTableVal):
                out[key] = ("RT", v.idx.numpy(), v.lengths.numpy(), v.t_max)
            elif isinstance(v, torch.Tensor):
                out[key] = ("A", v.detach().numpy())
            else:
                out[key] = ("A", np.asarray(v))
    return out


def _kind(a):
    a = np.asarray(a)
    if a.dtype == bool:
        return "b"
    if np.issubdtype(a.dtype, np.integer):
        return "i"
    if np.issubdtype(a.dtype, np.complexfloating):
        return "c"
    return "f"


def compare(case, got, rtol=1e-4, atol=1e-5, values=True):
    """Hold the port's outputs against the JAX translator's: every name
    JAX wrote written, shapes equal, dtype kinds equal (JAX keeps 32-bit
    integers where the port keeps 64), values within the tolerance
    (exact for integers and booleans)."""
    for key, want in case["outs"].items():
        assert key in got, (case["type"], key, "not written")
        have = got[key]
        assert have[0] == want[0], (case["type"], key, have[0], want[0])
        if want[0] == "TA":
            assert have[2] == want[2], (case["type"], key, "length")
            pairs = [(have[1][:want[2]], want[1][:want[2]])]
        elif want[0] == "RT":
            pairs = [(have[1], want[1]), (have[2], want[2])]
        else:
            pairs = [(have[1], want[1])]
        for h, w in pairs:
            h, w = np.asarray(h), np.asarray(w)
            assert h.shape == w.shape, (case["type"], key, h.shape, w.shape)
            assert _kind(h) == _kind(w), (case["type"], key, h.dtype,
                                          w.dtype)
            if not values or h.size == 0:
                continue
            if _kind(w) in "fc":
                np.testing.assert_allclose(
                    h.astype(np.complex128 if _kind(w) == "c"
                             else np.float64),
                    w.astype(np.complex128 if _kind(w) == "c"
                             else np.float64),
                    rtol=rtol, atol=atol, equal_nan=True,
                    err_msg=f"{case['type']}.{key}")
            else:
                np.testing.assert_array_equal(
                    h.astype(np.int64), w.astype(np.int64),
                    err_msg=f"{case['type']}.{key}")
