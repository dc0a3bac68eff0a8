"""paddle_tpu_torch's functional tensor API against the JAX package's.

Every public name of ``paddle_tpu/ops/{creation, math, manipulation,
logic, search, stat, random, linalg}.py`` and ``paddle_tpu/linalg.py``
is one parametrised case here: the same inputs, made from a numpy seed,
go through ``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>`` (the
port on the CPU, by ``set_device("cpu")``) at tiny shapes.  Tolerances
by family (``tests/torch_op_tables.py:TOL``): f32 elementwise rtol 1e-5,
atol 1e-6; special functions rtol 1e-5, atol 5e-6 (JAX's own f32
``gammaln`` is 1.6e-6 from the f64 value near its zeros); reductions
rtol 1e-5, atol 1e-5; linear algebra by its invariants (reconstruction, sorted or absolute
values) at rtol 1e-4; integer and bool outputs exactly, by value (the
port keeps int64 where JAX narrows to int32).  Gradients
(``torch.autograd.grad`` against ``paddle_tpu.grad``) hold at the
family's tolerance, AMP output dtypes exactly, random ops in
distribution (two-sample Kolmogorov-Smirnov and chi-square tests at
fixed seeds, so the p-values are deterministic).  Also: the device
default (the card unless ``set_device`` names the CPU) and the
top-level helpers.  (That importing the port replaces no attribute of
``torch.Tensor`` is ``tests/test_torch_serving.py``'s guard.)
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab

SHAPE = (3, 4, 5)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's expected place is the CPU for each test, then what it
    was."""
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def rng(seed=0):
    return np.random.default_rng(seed)


def to_np(v):
    if isinstance(v, (list, tuple)):
        return [to_np(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def assert_close(got, want, family, label=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, family, f"{label}[{i}]")
        return
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if family == "exact" or want.dtype.kind in "biu":
        if want.dtype.kind in "iu":
            got, want = got.astype(np.int64), want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=label)
        return
    rtol, atol = tab.TOL[family]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=label)


def _tensors(pkg, arrays, grad=False):
    """``arrays`` as ``pkg``'s tensors; with ``grad`` the float ones take
    gradients."""
    if pkg is P:
        return [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind
                                                  == "f")) for a in arrays]
    return [torch.from_numpy(np.array(a)).requires_grad_(
        grad and a.dtype.kind == "f") for a in arrays]


def cotangents(shapes):
    r = rng(1)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _float_out(o):
    return str(o.dtype).split(".")[-1] in ("float32", "float64")


_REFS = {}


def jax_ref(case, call, arrays, grad):
    """``(outputs, grads)`` of the JAX package for ``case``: the flattened
    outputs of ``call(P, *tensors)`` on ``arrays`` and, with ``grad``,
    ``paddle_tpu.grad`` of every float output that takes one, against
    `cotangents` of all float outputs, with respect to the float inputs
    (None where unused).  Traced under one ``jax.jit`` (one compile a
    case, where eager dispatch compiles each op's forward and backward
    apart), or run eagerly where a JAX op reads values on the host; cached
    for the case's forward and gradient tests."""
    key = (id(case), grad)
    if key in _REFS:
        return _REFS[key]
    floats = [np.asarray(a).dtype.kind == "f" for a in arrays]

    def run(*arrs):
        xs = [P.Tensor(a, stop_gradient=not (grad and f))
              for a, f in zip(arrs, floats)]
        outs = tab.flat(call(P, *xs))
        grads = None
        if grad:
            fl = [o for o in outs if _float_out(o)]
            live = [(o, P.Tensor(c)) for o, c in zip(
                fl, cotangents([tuple(o.shape) for o in fl]))
                if not o.stop_gradient]
            wrt = [x for x in xs if not x.stop_gradient]
            grads = [None] * len(wrt)
            if live:
                grads = [None if g is None else g._array for g in P.grad(
                    [o for o, _ in live], wrt,
                    grad_outputs=[c for _, c in live], allow_unused=True)]
        return [o._array if isinstance(o, P.Tensor) else o
                for o in outs], grads

    try:
        outs, grads = jax.jit(run)(*arrays)
    except jax.errors.JAXTypeError:
        outs, grads = run(*arrays)
    _REFS[key] = ([np.asarray(o) for o in outs],
                  grads and [None if g is None else np.asarray(g)
                             for g in grads])
    return _REFS[key]


def port_grads(call, arrays):
    """The port's counterpart of `jax_ref`'s gradients (zeros where an
    input is unused)."""
    xs = _tensors(T, arrays, grad=True)
    fl = [o for o in tab.flat(call(T, *xs)) if _float_out(o)]
    live = [(o, torch.from_numpy(c)) for o, c in zip(
        fl, cotangents([tuple(o.shape) for o in fl])) if o.requires_grad]
    wrt = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad([o for o, _ in live], wrt,
                                [c for _, c in live], allow_unused=True) \
        if live else [None] * len(wrt)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(wrt, grads)]


def check_forward(case, call, arrays, family, label=None):
    want, _ = jax_ref(case, call, arrays, case.grad)
    got = tab.flat(call(T, *_tensors(T, arrays)))
    assert_close(got, want, family, label or repr(case))
    return got, want


# ---------------------------------------------------------------------------
# the shape-generic tables (also run on the card by chip_smoke.py)
# ---------------------------------------------------------------------------
def table_arrays(op):
    if isinstance(op, tab.LinOp):
        return op.inputs(rng(), 4, (2,))
    return op.inputs(rng(), (3, 16) if op in tab.SEARCH else SHAPE)


def table_call(op):
    return lambda pkg, *xs: op.call(pkg, *xs)


@pytest.mark.parametrize("op", tab.ELEMENTWISE, ids=repr)
def test_elementwise(op):
    check_forward(op, table_call(op), table_arrays(op), op.family)


@pytest.mark.parametrize("op", tab.REDUCTIONS, ids=repr)
def test_reduction(op):
    check_forward(op, table_call(op), table_arrays(op), op.family)


@pytest.mark.parametrize("op", tab.SEARCH, ids=repr)
def test_search(op):
    check_forward(op, table_call(op), table_arrays(op), op.family)


def check_linalg(op, got, want, arrays):
    """Hold a linear-algebra result by the invariant its row names
    (`torch_op_tables.linalg_excess`)."""
    ex = tab.linalg_excess(op.check, to_np(got), to_np(want), arrays[0],
                           *tab.TOL["linalg"])
    assert max(ex.values()) <= 0, (op.label, ex)


@pytest.mark.parametrize("op", tab.LINALG, ids=lambda o: f"{o.ns}.{o.label}")
def test_linalg(op):
    arrays = table_arrays(op)
    want, _ = jax_ref(op, table_call(op), arrays, op.grad)
    got = tab.flat(op.call(T, *_tensors(T, arrays)))
    check_linalg(op, got, want, arrays)


# ---------------------------------------------------------------------------
# the rest: one case a name, its inputs and call written out
# ---------------------------------------------------------------------------
class M:
    """``call(pkg, *tensors)`` on the tensors of ``make(rng)``."""

    def __init__(self, name, make, call, family="ew", grad=False):
        self.name, self.make, self.call = name, make, call
        self.family, self.grad = family, grad

    def __repr__(self):
        return self.name


def n(*shape):
    return lambda r: [r.standard_normal(shape).astype(np.float32)]


def nn_(*shapes):
    return lambda r: [r.standard_normal(s).astype(np.float32)
                      for s in shapes]


def idx(*arrays):
    return lambda r: [np.asarray(a) for a in arrays]


def with_idx(shape, index):
    return lambda r: [r.standard_normal(shape).astype(np.float32),
                      np.asarray(index)]


X = "exact"
MISC = [
    # creation: made on the expected place
    M("zeros", idx(), lambda p: p.zeros([2, 3])),
    M("ones", idx(), lambda p: p.ones([2, 3], dtype="int32"), X),
    M("full", idx(), lambda p: [p.full([2, 2], 3), p.full([2], 1.5),
                                p.full([2], True)], X),
    M("empty", idx(), lambda p: p.empty([2, 3])),
    M("zeros_like", n(2, 3), lambda p, x: p.zeros_like(x)),
    M("ones_like", n(2, 3), lambda p, x: p.ones_like(x, dtype="int32"), X),
    M("full_like", n(2, 3), lambda p, x: p.full_like(x, 2.5)),
    M("empty_like", n(2, 3), lambda p, x: p.empty_like(x)),
    M("arange", idx(), lambda p: [p.arange(5), p.arange(1, 10, 3),
                                  p.arange(0, 1, 0.25)], X),
    M("linspace", idx(), lambda p: p.linspace(-1, 2, 7)),
    M("logspace", idx(), lambda p: p.logspace(0, 2, 5)),
    M("eye", idx(), lambda p: [p.eye(3), p.eye(2, 4)]),
    M("assign", n(2, 3), lambda p, x: p.assign(x), grad=True),
    M("clone", n(2, 3), lambda p, x: p.clone(x), grad=True),
    M("diag", nn_((4,), (3, 4)), lambda p, v, m: [
        p.diag(v), p.diag(v, offset=1, padding_value=-1.0), p.diag(m, 1)],
      grad=True),
    M("diag_embed", n(2, 3), lambda p, x: [p.diag_embed(x),
                                           p.diag_embed(x, offset=-1)],
      grad=True),
    M("diagonal", n(3, 4, 5), lambda p, x: p.diagonal(x, 1, 1, 2),
      grad=True),
    M("tril", n(4, 5), lambda p, x: p.tril(x, 1), grad=True),
    M("triu", n(4, 5), lambda p, x: p.triu(x, -1), grad=True),
    M("meshgrid", nn_((3,), (4,)), lambda p, a, b: p.meshgrid(a, b)),
    M("one_hot", idx([0, 3, 4, 5, -1, 2]), lambda p, i: p.one_hot(i, 5)),
    M("complex", nn_((3,), (3,)), lambda p, a, b: p.complex(a, b)),
    # math beyond the tables
    M("add_n", nn_((2, 3), (2, 3), (2, 3)),
      lambda p, a, b, c: p.add_n([a, b, c]), grad=True),
    M("increment", n(3), lambda p, x: p.increment(x, 2.5)),
    M("inner", nn_((2, 3), (4, 3)), lambda p, a, b: p.inner(a, b),
      grad=True),
    M("outer", nn_((3,), (2, 2)), lambda p, a, b: p.outer(a, b), grad=True),
    M("kron", nn_((2, 3), (2, 2)), lambda p, a, b: p.kron(a, b), grad=True),
    M("mm", nn_((2, 3), (3, 4)), lambda p, a, b: p.mm(a, b), grad=True),
    M("dot", nn_((2, 3), (2, 3)), lambda p, a, b: p.dot(a, b), grad=True),
    M("mv", nn_((2, 3), (3,)), lambda p, a, b: p.mv(a, b), grad=True),
    M("addmm", nn_((2, 4), (2, 3), (3, 4)),
      lambda p, i, a, b: p.addmm(i, a, b, beta=0.5, alpha=2.0), grad=True),
    M("multiplex", lambda r: [r.standard_normal((4, 3)).astype(np.float32),
                              r.standard_normal((4, 3)).astype(np.float32),
                              np.array([[1], [0], [1], [0]])],
      lambda p, a, b, i: p.multiplex([a, b], i), grad=True),
    M("allclose", lambda r: [np.ones(3, np.float32),
                             np.ones(3, np.float32) + 1e-7],
      lambda p, a, b: [p.allclose(a, b), p.allclose(a, b * 2)], X),
    M("trace", n(3, 4), lambda p, x: [p.trace(x), p.trace(x, 1)],
      grad=True),
    M("matmul", nn_((2, 3), (2, 4)),
      lambda p, a, b: p.matmul(a, b, transpose_x=True), grad=True),
    # manipulation
    M("cast", n(2, 3), lambda p, x: p.cast(x * 3, "int32"), X),
    M("reshape", n(3, 4, 5), lambda p, x: p.reshape(x, [4, -1]),
      grad=True),
    M("transpose", n(3, 4, 5), lambda p, x: p.transpose(x, [2, 0, 1]),
      grad=True),
    M("t", n(3, 4), lambda p, x: p.t(x), grad=True),
    M("concat", nn_((2, 3), (2, 4)), lambda p, a, b: p.concat([a, b], 1),
      grad=True),
    M("stack", nn_((2, 3), (2, 3)), lambda p, a, b: p.stack([a, b], 1),
      grad=True),
    M("split", n(3, 6), lambda p, x: p.split(x, 3, axis=1)
      + p.split(x, [1, -1, 2], axis=1), grad=True),
    M("chunk", n(4, 3), lambda p, x: p.chunk(x, 2), grad=True),
    M("squeeze", n(1, 3, 1, 2), lambda p, x: [p.squeeze(x),
                                              p.squeeze(x, [0, 1])],
      grad=True),
    M("unsqueeze", n(3, 2), lambda p, x: [p.unsqueeze(x, [0, 2]),
                                          p.unsqueeze(x, -1)], grad=True),
    M("flatten", n(2, 3, 4, 5), lambda p, x: p.flatten(x, 1, 2),
      grad=True),
    M("tile", n(2, 3), lambda p, x: p.tile(x, [2, 1, 2]), grad=True),
    M("expand", n(1, 3, 1), lambda p, x: p.expand(x, [2, -1, 4]),
      grad=True),
    M("broadcast_to", n(3, 1), lambda p, x: p.broadcast_to(x, [2, 3, 4]),
      grad=True),
    M("expand_as", nn_((3, 1), (2, 3, 4)),
      lambda p, x, y: p.expand_as(x, y), grad=True),
    M("broadcast_tensors", nn_((3, 1), (1, 4)),
      lambda p, a, b: p.broadcast_tensors([a, b])),
    M("flip", n(3, 4, 2), lambda p, x: p.flip(x, [0, 2]), grad=True),
    M("roll", n(3, 4), lambda p, x: [p.roll(x, 2, 1), p.roll(x, 5)],
      grad=True),
    M("rot90", n(2, 3, 4), lambda p, x: p.rot90(x, 1, [1, 2]), grad=True),
    M("gather", with_idx((5, 3), [[4, 0], [1, 1]]),
      lambda p, x, i: [p.gather(x, i), p.gather(x, i[0], axis=0)],
      grad=True),
    M("gather_nd", with_idx((3, 4, 2), [[0, 1], [2, 3], [1, 0]]),
      lambda p, x, i: p.gather_nd(x, i), grad=True),
    M("take_along_axis", with_idx((3, 4), [[0, 3], [1, 1], [2, 0]]),
      lambda p, x, i: p.take_along_axis(x, i, 1), grad=True),
    M("put_along_axis", lambda r: [
        r.standard_normal((3, 4)).astype(np.float32),
        np.array([[0, 3], [2, 1], [1, 0]]),
        r.standard_normal((3, 2)).astype(np.float32)],
      lambda p, x, i, v: [p.put_along_axis(x, i, v, 1),
                          p.put_along_axis(x, i, v, 1, reduce="add"),
                          p.put_along_axis(x, i, v, 1, reduce="multiply")]),
    M("scatter", lambda r: [
        r.standard_normal((5, 3)).astype(np.float32),
        np.array([3, 0, 1]), np.array([3, 3, 1]),
        r.standard_normal((3, 3)).astype(np.float32)],
      lambda p, x, i, j, u: [p.scatter(x, i, u),
                             p.scatter(x, j, u, overwrite=False)]),
    M("scatter_nd_add", lambda r: [
        r.standard_normal((3, 4)).astype(np.float32),
        np.array([[0, 1], [2, 3], [0, 1]]),
        r.standard_normal(3).astype(np.float32)],
      lambda p, x, i, u: p.scatter_nd_add(x, i, u), grad=True),
    M("scatter_nd", lambda r: [np.array([[1], [3], [1]]),
                               r.standard_normal((3, 2)).astype(np.float32)],
      lambda p, i, u: p.scatter_nd(i, u, [5, 2]), grad=True),
    M("index_select", with_idx((4, 3), [3, 0, 0]),
      lambda p, x, i: p.index_select(x, i, axis=0), grad=True),
    M("index_sample", with_idx((3, 5), [[4, 0], [1, 1], [0, 2]]),
      lambda p, x, i: p.index_sample(x, i), grad=True),
    M("index_add", lambda r: [
        r.standard_normal((4, 3)).astype(np.float32), np.array([0, 2, 0]),
        r.standard_normal((4, 3)).astype(np.float32)],
      lambda p, x, i, v: p.index_add(x, i, 1, v), grad=True),
    M("masked_select", lambda r: [r.standard_normal((3, 4)).astype(
        np.float32), r.random((3, 4)) < 0.5],
      lambda p, x, m: p.masked_select(x, m)),
    M("masked_fill", lambda r: [r.standard_normal((3, 4)).astype(
        np.float32), r.random((3, 4)) < 0.5],
      lambda p, x, m: p.masked_fill(x, m, -2.0), grad=True),
    M("where", lambda r: [r.random((3, 4)) < 0.5,
                          r.standard_normal((3, 4)).astype(np.float32),
                          r.standard_normal((3, 4)).astype(np.float32)],
      lambda p, c, x, y: [p.where(c, x, y), p.where(c)]),
    M("nonzero", idx([[0, 1, 0], [2, 0, 3]]),
      lambda p, x: [p.nonzero(x), list(p.nonzero(x, as_tuple=True))], X),
    M("slice", n(3, 4, 5), lambda p, x: p.slice(x, [0, 2], [1, -3],
                                                [3, 100]), grad=True),
    M("strided_slice", n(6, 7), lambda p, x: [
        p.strided_slice(x, [0, 1], [0, 1], [6, 7], [2, 3]),
        p.strided_slice(x, [1], [5], [0], [-2])], grad=True),
    M("unbind", n(3, 2), lambda p, x: p.unbind(x, 1), grad=True),
    M("unstack", n(3, 2), lambda p, x: p.unstack(x), grad=True),
    M("unique", idx([[3, 1, 3], [0, 1, 2]]),
      lambda p, x: [p.unique(x), list(p.unique(
          x, return_index=True, return_inverse=True, return_counts=True)),
          list(p.unique(x, return_index=True, return_counts=True, axis=1))],
      X),
    M("unique_consecutive", idx([1, 1, 2, 2, 2, 3, 1, 1]),
      lambda p, x: [p.unique_consecutive(x), list(p.unique_consecutive(
          x, return_inverse=True, return_counts=True))], X),
    M("pad", n(2, 3, 4, 5), lambda p, x: [
        p.pad(x, [1, 2, 0, 1], value=0.5), p.pad(x, [1, 2, 2, 1],
                                                  mode="reflect"),
        p.pad(x, [2, 0, 0, 3], mode="replicate"),
        p.pad(x, [1, 2, 3, 0], mode="circular"),
        p.pad(x, [0, 0, 0, 0, 1, 1, 2, 0])], grad=True),
    M("shard_index", idx([[1], [6], [12], [19]]),
      lambda p, x: p.shard_index(x, 20, 2, 1), X),
    M("repeat_interleave", n(2, 3), lambda p, x: [
        p.repeat_interleave(x, 2, 1), p.repeat_interleave(x, 3)],
      grad=True),
    M("moveaxis", n(2, 3, 4), lambda p, x: p.moveaxis(x, 0, 2), grad=True),
    M("swapaxes", n(2, 3, 4), lambda p, x: p.swapaxes(x, 0, 2), grad=True),
    M("as_complex", n(3, 2), lambda p, x: p.as_complex(x)),
    M("as_real", lambda r: [(r.standard_normal(3) + 1j * r.standard_normal(
        3)).astype(np.complex64)], lambda p, x: p.as_real(x)),
    M("tensordot", nn_((2, 3, 4), (3, 4, 5)),
      lambda p, a, b: [p.tensordot(a, b), p.tensordot(a, b, [[1], [0]])],
      grad=True),
    M("numel", n(2, 3), lambda p, x: p.numel(x), X),
    M("shape", n(2, 3, 4), lambda p, x: p.shape(x), X),
    M("crop", n(4, 5), lambda p, x: p.crop(x, [2, 3], [1, 2]), grad=True),
    # logic
    M("equal_all", lambda r: [np.arange(3), np.arange(3), np.arange(4)],
      lambda p, a, b, c: [p.equal_all(a, b), p.equal_all(a, c),
                          p.equal_all(a, b * 2)], X),
    M("is_empty", lambda r: [np.zeros((2, 0)), np.zeros(2)],
      lambda p, a, b: [p.is_empty(a), p.is_empty(b)], X),
    M("is_tensor", n(2), lambda p, x: [p.to_tensor(p.is_tensor(x)),
                                       p.to_tensor(p.is_tensor(3))], X),
    # stat beyond the tables
    M("histogram", lambda r: [r.standard_normal(50).astype(np.float32)],
      lambda p, x: [p.histogram(x, bins=7),
                    p.histogram(x, bins=4, min=-1, max=1)], X),
    M("bincount", lambda r: [r.integers(0, 6, 20), r.random(20).astype(
        np.float32)], lambda p, x, w: [p.bincount(x, minlength=8),
                                       p.bincount(x, w)]),
    M("corrcoef", n(3, 6), lambda p, x: [p.corrcoef(x),
                                         p.corrcoef(x, rowvar=False)],
      "reduce", grad=True),
    M("cov", lambda r: [r.standard_normal((3, 6)).astype(np.float32),
                        r.integers(1, 4, 6), r.random(6).astype(np.float32)],
      lambda p, x, f, a: [p.cov(x), p.cov(x, rowvar=False, ddof=False),
                          p.cov(x, fweights=f, aweights=a)], "reduce"),
    # linalg beyond the table
    M("cross", nn_((2, 3), (2, 3)), lambda p, a, b: p.cross(a, b),
      grad=True),
    M("multi_dot", nn_((2, 3), (3, 4), (4, 2)),
      lambda p, a, b, c: p.multi_dot([a, b, c]), "reduce", grad=True),
    M("bilinear_tensor_product", nn_((2, 3), (2, 4), (5, 3, 4), (5,)),
      lambda p, x, y, w, b: p.bilinear_tensor_product(x, y, w, b),
      "reduce", grad=True),
]


@pytest.mark.parametrize("case", MISC, ids=repr)
def test_misc(case):
    check_forward(case, case.call, case.make(rng()), case.family)


def test_histogramdd_raises_in_both():
    for pkg in (P, T):
        with pytest.raises(NotImplementedError):
            pkg.histogramdd(np.zeros((3, 2)))


def test_device_of_made_tensors_follows_set_device():
    """Creation ops land on the expected place, ops over a tensor keep
    its device."""
    assert T.get_device() == "cpu:0" == P.get_device()
    for t in (T.zeros([2]), T.arange(3), T.eye(2), T.full([1], 2.0),
              T.linspace(0, 1, 3), T.randn([2]), T.rand([2]),
              T.randint(0, 3, [2]), T.randperm(3), T.to_tensor([1.0])):
        assert t.device.type == "cpu"
    assert isinstance(T.set_device("cpu"), T.CPUPlace)
    with pytest.raises(ValueError, match="tpu"):
        T.set_device("tpu")
    with pytest.raises(ValueError, match="xpu"):
        T.set_device("xpu:0")


def test_without_a_card_creation_raises_unless_cpu_is_set():
    """With nothing set the expected place is the card: on a machine
    without one every made tensor raises rather than landing on the
    CPU; ``set_device("cpu")`` is how the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    TPL._EXPECTED_DEVICE[0] = None
    for make in (lambda: T.zeros([2]), lambda: T.arange(3),
                 lambda: T.randn([2]), lambda: T.to_tensor([1.0]),
                 lambda: T.nn.BatchNorm2D(3), T.get_device):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.set_device("gpu")
    T.set_device("cpu")
    assert T.zeros([2]).device.type == "cpu"
    assert T.nn.BatchNorm2D(3)._mean.device.type == "cpu"


class _DeviceRecorder(torch.overrides.TorchFunctionMode):
    """Records the ``device=`` of each torch call and makes the tensor on
    the CPU instead (the card is stood in for)."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("device") is not None:
            self.devices.append(torch.device(kwargs["device"]))
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


def test_unset_device_follows_the_current_card(monkeypatch):
    """With nothing set, made tensors and new layers take the *current*
    card (``torch.device("cuda")``, which follows
    ``torch.cuda.set_device`` as each launched rank sets it), not a
    fixed cuda:0; ``set_device("gpu:N")`` fixes card N.  The card is
    stood in for: CUDA reports itself available with card 1 current,
    and each factory call is recorded and run on the CPU."""
    from paddle_tpu_torch.core import framework
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(framework.Generator, "for_device",
                        lambda self, device: rec.devices.append(
                            torch.device(device)) or torch.Generator())
    makes = (lambda: T.zeros([2]), lambda: T.to_tensor([1.0]),
             lambda: T.nn.Linear(3, 4), lambda: T.nn.BatchNorm2D(3),
             lambda: T.randn([3]), lambda: T.arange(3),
             lambda: T.full([2], 1.5), lambda: T.randint(0, 3, [2]))
    for setting, want, name in ((None, torch.device("cuda"), "gpu:1"),
                                ("gpu", torch.device("cuda"), "gpu:1"),
                                ("gpu:2", torch.device("cuda", 2),
                                 "gpu:2")):
        TPL._EXPECTED_DEVICE[0] = None
        if setting is not None:
            assert T.set_device(setting) == T.CUDAPlace(int(name[-1]))
        assert T.get_device() == name
        rec = _DeviceRecorder()
        with rec:
            for make in makes:
                make()
        assert rec.devices and set(rec.devices) == {want}, (setting,
                                                             rec.devices)


def test_top_level_helpers_match_jax():
    assert T.in_dynamic_mode() and P.in_dynamic_mode()
    T.enable_static()
    P.enable_static()
    assert T.in_dynamic_mode() is False is P.in_dynamic_mode()
    T.disable_static()
    P.disable_static()
    assert T.in_dynamic_mode() and P.in_dynamic_mode()
    assert T.device_count() == torch.cuda.device_count()
    assert T.linalg.inv is T.linalg.inverse is T.inverse
    assert T.linalg.__name__ == "paddle_tpu_torch.linalg"


def _public(mod):
    src = Path(mod.__file__).read_text()
    return {nm for nm in dir(mod) if not nm.startswith("_")
            and callable(getattr(mod, nm))
            and (getattr(getattr(mod, nm), "__module__", None)
                 == mod.__name__ or f"\n{nm} =" in src
                 or f"\ndef {nm}(" in src)}


def test_every_public_name_exists_and_has_a_case():
    """Each public name of the eight JAX op modules (and ``linalg``'s
    ``inv``) is at the port's top level (``linalg.*`` in its namespace)
    and has a parity case in this file (``histogramdd`` raises in both)."""
    from paddle_tpu.ops import (creation, linalg, logic, manipulation, math,
                                random, search, stat)
    names = set()
    for mod in (creation, math, manipulation, logic, search, stat, random,
                linalg):
        names |= _public(mod)
    assert len(names) == 256, len(names)
    missing = sorted(nm for nm in names if not hasattr(T, nm))
    assert not missing, missing
    assert set(P.linalg.__all__) <= set(dir(T.linalg))
    covered = {o.name for o in tab.ELEMENTWISE + tab.REDUCTIONS + tab.SEARCH
               + tab.LINALG} | {c.name for c in MISC} | set(RANDOM) | {
        "histogramdd", "seed", "get_rng_state", "set_rng_state"}
    assert names - covered == set(), sorted(names - covered)


# ---------------------------------------------------------------------------
# gradients: torch.autograd.grad against paddle_tpu.grad
# ---------------------------------------------------------------------------
GRAD_CASES = ([o for o in tab.ELEMENTWISE + tab.REDUCTIONS + tab.SEARCH
               if o.grad] + [o for o in tab.LINALG if o.grad]
              + [c for c in MISC if c.grad])


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: f"{getattr(c, 'ns', '')}.{c!r}")
def test_grad(case):
    if isinstance(case, M):
        call, arrays = case.call, case.make(rng())
    else:
        call, arrays = table_call(case), table_arrays(case)
    _, want = jax_ref(case, call, arrays, True)
    got = port_grads(call, arrays)
    want = [np.zeros(g.shape, np.float32) if w is None else w
            for w, g in zip(want, to_np(got))]
    family = {"ew": "ew", "special": "special"}.get(case.family, "reduce")
    if isinstance(case, tab.LinOp):
        family = "linalg"
    assert_close(list(got), want, family, repr(case))


# ---------------------------------------------------------------------------
# AMP: the output dtypes under auto_cast against JAX's
# ---------------------------------------------------------------------------
AMP_CASES = {
    "white": [("matmul", [(2, 3), (3, 4)]), ("mm", [(2, 3), (3, 4)]),
              ("bmm", [(2, 2, 3), (2, 3, 4)]), ("mv", [(2, 3), (3,)]),
              ("dot", [(2, 3), (2, 3)]),
              ("addmm", [(2, 4), (2, 3), (3, 4)])],
    "black": [("mean", [(2, 3)]), ("logsumexp", [(2, 3)])],
    "none": [("add", [(2, 3), (2, 3)]), ("exp", [(2, 3)]),
             ("sum", [(2, 3)]), ("max", [(2, 3)]), ("cumsum", [(2, 3)]),
             ("concat", None)],
}


@pytest.mark.parametrize("policy", sorted(AMP_CASES))
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_amp_output_dtypes(policy, in_dtype):
    r = rng()
    for name, shapes in AMP_CASES[policy]:
        shapes = shapes or [(2, 3), (2, 3)]
        arrays = [r.standard_normal(s).astype(np.float32) for s in shapes]
        jx = [P.to_tensor(a).astype(in_dtype) for a in arrays]
        tx = [torch.from_numpy(a).to(getattr(torch, in_dtype))
              for a in arrays]
        if name == "concat":
            jx, tx = [jx], [tx]
        with P.amp.auto_cast(dtype="bfloat16"):
            want = getattr(P, name)(*jx)
        with T.amp.auto_cast(dtype="bfloat16"):
            got = getattr(T, name)(*tx)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        tol = 1e-2 if "bfloat16" in (in_dtype, str(want.dtype)) else 1e-5
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# random ops: in distribution against JAX's draws, repeatable under seed
# ---------------------------------------------------------------------------
DRAWS = 20000


def _ks(a, b):
    return scipy.stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue


def _chi2(a, b, k):
    counts = np.stack([np.bincount(np.ravel(a).astype(np.int64),
                                   minlength=k)[:k],
                       np.bincount(np.ravel(b).astype(np.int64),
                                   minlength=k)[:k]])
    counts = counts[:, counts.sum(0) > 0]
    return scipy.stats.chi2_contingency(counts).pvalue


RANDOM = {
    "uniform": (lambda p: p.uniform([DRAWS], min=-2.0, max=3.0), _ks),
    "rand": (lambda p: p.rand([DRAWS]), _ks),
    "normal": (lambda p: p.normal(1.0, 2.0, [DRAWS]), _ks),
    "gaussian": (lambda p: p.gaussian([DRAWS], mean=-1.0, std=0.5), _ks),
    "randn": (lambda p: p.randn([DRAWS]), _ks),
    "standard_normal": (lambda p: p.standard_normal([DRAWS]), _ks),
    "normal_like": (lambda p: p.normal_like(p.zeros([DRAWS]), 0.5, 3.0),
                    _ks),
    "randint": (lambda p: p.randint(2, 9, [DRAWS]),
                lambda a, b: _chi2(a, b, 9)),
    "randint_like": (lambda p: p.randint_like(p.zeros([DRAWS], "int32"),
                                              0, 7),
                     lambda a, b: _chi2(a, b, 7)),
    "bernoulli": (lambda p: p.bernoulli(p.full([DRAWS], 0.3)),
                  lambda a, b: _chi2(a, b, 2)),
    "poisson": (lambda p: p.poisson(p.full([DRAWS], 3.0)),
                lambda a, b: _chi2(np.minimum(a, 9), np.minimum(b, 9), 10)),
    "multinomial": (lambda p: p.multinomial(
        p.to_tensor(np.array([0.1, 0.2, 0.3, 0.4], np.float32)), DRAWS),
        lambda a, b: _chi2(a, b, 4)),
    "randperm": (lambda p: p.stack([p.randperm(8) for _ in range(300)]),
                 lambda a, b: min(_chi2(a[:, i], b[:, i], 8)
                                  for i in range(8)) * 8),
    "shuffle": (lambda p: p.stack([p.shuffle(p.arange(6)) for _ in
                                   range(300)]),
                lambda a, b: min(_chi2(a[:, i], b[:, i], 6)
                                 for i in range(6)) * 6),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_in_distribution(name):
    """The port's draws against JAX's: a two-sample test at p > 1e-3
    (seeded on both sides, so each p-value is fixed); the same seed
    repeats the port's draw, another changes it."""
    draw, test = RANDOM[name]
    P.seed(11)
    want = to_np(draw(P))
    T.seed(11)
    got = to_np(draw(T))
    assert got.shape == want.shape
    p_value = test(got, want)
    assert p_value > 1e-3, (name, p_value)
    T.seed(11)
    np.testing.assert_array_equal(to_np(draw(T)), got)
    T.seed(12)
    assert not np.array_equal(to_np(draw(T)), got)
    if name in ("randperm", "shuffle"):
        assert (np.sort(got, 1) == np.sort(want, 1)).all()


def test_rng_state_round_trip_and_seed():
    """``get_rng_state``/``set_rng_state`` repeat a draw in both
    packages; ``seed`` returns the generator."""
    for pkg in (P, T):
        pkg.seed(5)
        state = pkg.get_rng_state()
        a = to_np(pkg.rand([4]))
        pkg.set_rng_state(state)
        np.testing.assert_array_equal(to_np(pkg.rand([4])), a)
    assert T.seed(3) is T.core.framework.default_generator
