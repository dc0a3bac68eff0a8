"""paddle_tpu_torch's nn activations, losses and norms against the JAX
package's.

Every public name of ``paddle_tpu/nn/functional/{activation, loss,
norm}.py`` and ``paddle_tpu/nn/layer/{activation, loss, norm}.py``
(``SyncBatchNorm`` and ``SpectralNorm`` excepted: they come with
``nn/utils.py`` and a cross-rank test) is one parametrised case: the
same inputs, made from a numpy seed, through both packages at tiny
shapes, with the port on the CPU (``set_device("cpu")``).  Tolerances:
elementwise activations rtol 1e-5, atol 1e-6; losses and norms (sums
and means) rtol 1e-5, atol 1e-5; integer outputs exactly.  Each layer
loads the JAX layer's ``state_dict()`` (as numpy, buffers included)
through ``set_state_dict`` and matches its forward; ``BatchNorm`` in
train mode also its updated ``_mean`` and ``_variance``.  Gradients
(``torch.autograd.grad`` against ``paddle_tpu.grad``) at the same
tolerances, AMP output dtypes exactly, the random activations
(``rrelu`` in training, ``gumbel_softmax``) in distribution.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import jax
import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_tensor_api import (_tensors, assert_close, check_forward,
                                   jax_ref, port_grads, rng, to_np)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


class C:
    """``call(F, *tensors)`` (F: the package's ``nn.functional``) on the
    tensors of ``make(rng)``; ``grad`` whether the float inputs are
    differentiated in `test_grad`."""

    def __init__(self, name, make, call, family="ew", grad=True):
        self.name, self.make, self.call = name, make, call
        self.family, self.grad = family, grad

    def __repr__(self):
        return self.name


def wide(*shape):
    """Normal inputs times 3: both sides of every threshold."""
    return lambda r: [3 * r.standard_normal(shape).astype(np.float32)]


def floats(*shapes):
    return lambda r: [r.standard_normal(s).astype(np.float32)
                      for s in shapes]


def act(name, *variants):
    """An activation over a [2, 4, 6] input, once per keyword set."""
    variants = variants or ({},)
    return C(name, wide(2, 4, 6), lambda F, x: [getattr(F, name)(x, **v)
                                                for v in variants])


ACTIVATIONS = [
    act("relu"), act("relu6"), act("sigmoid"), act("log_sigmoid"),
    act("tanh"), act("tanhshrink"),
    act("gelu", {}, dict(approximate=True)),
    act("leaky_relu", {}, dict(negative_slope=0.2)),
    act("elu", dict(alpha=0.5)), act("celu", dict(alpha=0.7)),
    act("selu"), act("silu"), act("swish"), act("mish"),
    act("hardtanh", dict(min=-0.5, max=2.0)), act("hardsigmoid"),
    act("hardswish"), act("hardshrink", dict(threshold=0.3)),
    act("softshrink", dict(threshold=0.3)),
    act("softplus", {}, dict(beta=2.0, threshold=3.0)), act("softsign"),
    act("thresholded_relu", dict(threshold=0.5)),
    act("softmax", {}, dict(axis=1)), act("log_softmax", {}, dict(axis=1)),
    act("maxout", dict(groups=2), dict(groups=2, axis=-1)),
    act("glu", {}, dict(axis=1)),
    act("rrelu", dict(lower=0.1, upper=0.3)),
    C("prelu", floats((2, 4, 3), (4,), (1,), (2, 3, 4)),
      lambda F, x, w, w1, x_last: [
          F.prelu(x, w), F.prelu(x, w1),
          F.prelu(x_last, w, data_format="NHWC")]),
    C("relu_", wide(2, 3), lambda F, x: F.relu_(x * 1), grad=False),
    C("softmax_", wide(2, 3), lambda F, x: F.softmax_(x * 1), grad=False),
    C("gumbel_softmax", wide(2, 3),
      lambda F, x: F.gumbel_softmax(x).sum(-1), grad=False),
]


def labels(n, c, ignore=None):
    def make(r):
        y = r.integers(0, c, n)
        if ignore is not None:
            y[1] = ignore
        return y
    return make


def probs(*shape):
    def make(r):
        p = r.random(shape).astype(np.float32) + 0.1
        return p / p.sum(-1, keepdims=True)
    return make


def m(*makers):
    return lambda r: [mk(r) for mk in makers]


def f(*shape):
    return lambda r: r.standard_normal(shape).astype(np.float32)


def u(*shape):
    return lambda r: r.uniform(0.05, 0.95, shape).astype(np.float32)


def sign(*shape):
    return lambda r: np.where(r.random(shape) < 0.5, -1, 1).astype(
        np.float32)


def const(a):
    return lambda r: np.asarray(a)


R = "reduce"
LOSSES = [
    C("cross_entropy", m(f(6, 5), labels(6, 5, ignore=-100), u(5)),
      lambda F, x, y, w: [
          F.cross_entropy(x, y), F.cross_entropy(x, y, reduction="sum"),
          F.cross_entropy(x, y, reduction="none"),
          F.cross_entropy(x, y, weight=w),
          F.cross_entropy(x, y, weight=w, reduction="sum")], R),
    C("cross_entropy", m(f(6, 5), probs(6, 5)),
      lambda F, x, y: [F.cross_entropy(x, y, soft_label=True),
                       F.cross_entropy(x, y, soft_label=True,
                                       reduction="none")], R),
    C("cross_entropy", m(probs(6, 5), labels(6, 5, ignore=3), u(5)),
      lambda F, p, y, w: [
          F.cross_entropy(p, y, use_softmax=False, ignore_index=3),
          F.cross_entropy(p, y, weight=w, use_softmax=False,
                          ignore_index=3)], R),
    C("cross_entropy", m(f(2, 5, 3), const([[0, 4, 1], [2, 2, 3]])),
      lambda F, x, y: F.cross_entropy(x, y, axis=1), R),
    C("softmax_with_cross_entropy", m(f(4, 5), const([[1], [0], [4], [2]])),
      lambda F, x, y: list(F.softmax_with_cross_entropy(
          x, y, return_softmax=True)), R),
    C("mse_loss", m(f(3, 4), f(3, 4)), lambda F, a, b: [
        F.mse_loss(a, b), F.mse_loss(a, b, "none")], R),
    C("square_error_cost", m(f(3, 4), f(3, 4)),
      lambda F, a, b: F.square_error_cost(a, b), R),
    C("l1_loss", m(f(3, 4), f(3, 4)), lambda F, a, b: [
        F.l1_loss(a, b), F.l1_loss(a, b, "sum")], R),
    C("smooth_l1_loss", m(f(3, 4), f(3, 4)), lambda F, a, b: [
        F.smooth_l1_loss(a, b), F.smooth_l1_loss(a, b, delta=0.5)], R),
    C("huber_loss", m(f(3, 4), f(3, 4)),
      lambda F, a, b: F.huber_loss(a, b, delta=0.7), R),
    C("nll_loss", m(f(6, 5), labels(6, 5, ignore=-100), u(5)),
      lambda F, x, y, w: [F.nll_loss(x, y), F.nll_loss(x, y, weight=w),
                          F.nll_loss(x, y, reduction="none")], R),
    C("binary_cross_entropy", m(u(3, 4), u(3, 4), u(3, 4)),
      lambda F, p, y, w: [F.binary_cross_entropy(p, y),
                          F.binary_cross_entropy(p, y, w, "sum")], R),
    C("binary_cross_entropy_with_logits", m(f(3, 4), u(3, 4), u(3, 4), u(4)),
      lambda F, z, y, w, pw: [
          F.binary_cross_entropy_with_logits(z, y),
          F.binary_cross_entropy_with_logits(z, y, w, pos_weight=pw)], R),
    C("sigmoid_focal_loss", m(f(3, 4), u(3, 4), const(np.float32(2.0))),
      lambda F, z, y, nrm: [F.sigmoid_focal_loss(z, y),
                            F.sigmoid_focal_loss(z, y, nrm, gamma=1.5,
                                                 reduction="mean")], R),
    C("kl_div", m(f(3, 4), u(3, 4)), lambda F, lp, y: [
        F.kl_div(lp, y), F.kl_div(lp, y, "batchmean")], R),
    C("margin_ranking_loss", m(f(5), f(5), sign(5)),
      lambda F, a, b, y: F.margin_ranking_loss(a, b, y, margin=0.1), R),
    C("hinge_embedding_loss", m(f(5), sign(5)),
      lambda F, a, y: F.hinge_embedding_loss(a, y), R),
    C("cosine_embedding_loss", m(f(4, 3), f(4, 3), sign(4)),
      lambda F, a, b, y: F.cosine_embedding_loss(a, b, y, margin=0.2), R),
    C("triplet_margin_loss", m(f(4, 3), f(4, 3), f(4, 3)),
      lambda F, a, p, n: [F.triplet_margin_loss(a, p, n),
                          F.triplet_margin_loss(a, p, n, p=1.0, swap=True)],
      R),
    C("log_loss", m(u(4, 1), u(4, 1)), lambda F, p, y: F.log_loss(p, y), R),
    C("npair_loss", m(f(4, 3), f(4, 3), const([0, 1, 0, 2])),
      lambda F, a, p, y: F.npair_loss(a, p, y), R),
    C("ctc_loss", m(f(6, 2, 4), const([[1, 2, 1], [3, 1, 0]]),
                    const([6, 5]), const([3, 2])),
      lambda F, lp, y, il, ll: [F.ctc_loss(lp, y, il, ll),
                                F.ctc_loss(lp, y, il, ll,
                                           reduction="none")], R),
]


def _norm_call(op):
    def call(F, x, *extra):
        args, kw = tab.norm_args(op, x, rng(7), lambda a: type(x)(a)
                                 if hasattr(x, "_array") else
                                 torch.from_numpy(a))
        out = getattr(F, op.name)(x, *args, **dict(op.kw, **kw))
        return [out] + [a for a in args if not isinstance(a, list)]
    return call


NORMS = [C(op.label, m(f(2, 4, 3, 3)), _norm_call(op), R)
         for op in tab.NORMS] + [
    C("layer_norm", m(f(2, 3, 4)), lambda F, x: [
        F.layer_norm(x, [3, 4]), F.layer_norm(x, 4)], R),
    C("group_norm", m(f(2, 3, 3, 4)), lambda F, x: F.group_norm(
        x, 2, data_format="NHWC"), R),
    C("batch_norm", m(f(2, 3, 4)), lambda F, x: F.batch_norm(
        x, x[0, 0, :] * 0, x[0, 0, :] * 0 + 1, training=True,
        data_format="NLC"), R),
]

CASES = ACTIVATIONS + LOSSES + NORMS


def functional(case):
    return lambda pkg, *xs: case.call(pkg.nn.functional, *xs)


@pytest.mark.parametrize("case", CASES, ids=repr)
def test_functional(case):
    check_forward(case, functional(case), case.make(rng()), case.family)


@pytest.mark.parametrize("case", [c for c in CASES if c.grad], ids=repr)
def test_grad(case):
    arrays = case.make(rng())
    _, want = jax_ref(case, functional(case), arrays, True)
    got = port_grads(functional(case), arrays)
    want = [np.zeros(g.shape, np.float32) if w is None else w
            for w, g in zip(want, to_np(got))]
    assert_close(list(got), want, case.family, case.name)


def test_every_public_name_has_a_case():
    from paddle_tpu.nn.functional import activation, loss, norm
    from test_torch_tensor_api import _public
    names = _public(activation) | _public(loss) | _public(norm)
    assert len(names) == 56, len(names)
    assert all(hasattr(T.nn.functional, nm) for nm in names)
    covered = {c.name.replace("_eval", "") for c in CASES}
    assert names - covered == set(), sorted(names - covered)
    from paddle_tpu.nn.layer import activation as la, loss as lo, norm as ln
    layers = (_public(la) | _public(lo) | _public(ln)) - {
        "SyncBatchNorm", "SpectralNorm"}
    assert len(layers) == 52, len(layers)
    assert all(hasattr(T.nn, nm) for nm in layers)
    assert layers == {c.name for c in LAYERS}


# ---------------------------------------------------------------------------
# layers: the JAX layer's state loads into the port's, equal forwards
# ---------------------------------------------------------------------------
class L:
    """``cls(*args)`` of both packages over the tensors of ``make``."""

    def __init__(self, name, args=(), make=wide(2, 4, 6), kw=None,
                 train=False):
        self.name, self.args, self.make = name, args, make
        self.kw, self.train = kw or {}, train

    def __repr__(self):
        return self.name


LAYERS = [L(nm) for nm in (
    "ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink", "SELU",
    "Silu", "Swish", "Mish", "Hardsigmoid", "Hardswish", "Softsign",
    "RReLU")] + [
    L("GELU", (True,)), L("LeakyReLU", (0.2,)), L("ELU", (0.5,)),
    L("CELU", kw=dict(alpha=0.7)), L("Hardtanh", (-0.5, 2.0)),
    L("Hardshrink", (0.3,)), L("Softshrink", kw=dict(threshold=0.3)),
    L("Softplus", (2.0, 3.0)), L("ThresholdedReLU", (0.5,)),
    L("Softmax", (1,)), L("LogSoftmax"), L("Maxout", (2,)), L("GLU", (1,)),
    L("PReLU", (4,)),
    L("CrossEntropyLoss", make=m(f(6, 5), labels(6, 5))),
    L("MSELoss", make=m(f(3, 4), f(3, 4))),
    L("L1Loss", ("sum",), make=m(f(3, 4), f(3, 4))),
    L("SmoothL1Loss", make=m(f(3, 4), f(3, 4))),
    L("NLLLoss", make=m(f(6, 5), labels(6, 5))),
    L("BCELoss", make=m(u(3, 4), u(3, 4))),
    L("BCEWithLogitsLoss", make=m(f(3, 4), u(3, 4))),
    L("KLDivLoss", ("batchmean",), make=m(f(3, 4), u(3, 4))),
    L("MarginRankingLoss", (0.1,), make=m(f(5), f(5), sign(5))),
    L("HingeEmbeddingLoss", make=m(f(5), sign(5))),
    L("CosineEmbeddingLoss", make=m(f(4, 3), f(4, 3), sign(4))),
    L("TripletMarginLoss", make=m(f(4, 3), f(4, 3), f(4, 3))),
    L("CTCLoss", make=m(f(6, 2, 4), const([[1, 2, 1], [3, 1, 0]]),
                        const([6, 5]), const([3, 2]))),
    L("HSigmoidLoss", (3, 6), make=m(f(5, 3), const([0, 5, 2, 3, 1]))),
    L("BatchNorm", (4,), make=f(2, 4, 3, 3)),
    L("BatchNorm1D", (4,), make=f(5, 4)),
    L("BatchNorm2D", (4,), make=f(2, 4, 3, 3), train=True),
    L("BatchNorm3D", (4,), make=f(2, 4, 2, 2, 2), train=True),
    L("LayerNorm", ([3, 3],), make=f(2, 4, 3, 3)),
    L("GroupNorm", (2, 4), make=f(2, 4, 3, 3)),
    L("InstanceNorm1D", (4,), make=f(2, 4, 5)),
    L("InstanceNorm2D", (4,), make=f(2, 4, 3, 3)),
    L("InstanceNorm3D", (4,), make=f(2, 4, 2, 2, 2)),
    L("LocalResponseNorm", (3,), make=f(2, 4, 3, 3)),
]


@pytest.mark.parametrize("case", LAYERS, ids=repr)
def test_layer_loads_jax_state_and_matches(case):
    arrays = case.make(rng())
    arrays = arrays if isinstance(arrays, list) else [arrays]
    jl = getattr(P.nn, case.name)(*case.args, **case.kw)
    r = rng(3)
    for p in jl.parameters():
        p.set_value((np.asarray(p.numpy()) + 0.1 * r.standard_normal(
            p.shape)).astype(np.float32))
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = getattr(T.nn, case.name)(*case.args, **case.kw)
    missing, unexpected = tl.set_state_dict(state)
    assert missing == [] and unexpected == [], (missing, unexpected)
    if case.train:
        want = jl(*_tensors(P, arrays))
    else:
        # one compile for the whole forward (CTC's scan, the hierarchical
        # sigmoid's path loop); a train-mode layer writes its buffers, so
        # it runs eagerly
        jl.eval()
        tl.eval()
        want = jax.jit(lambda *a: jl(*[P.Tensor(x) for x in a])._array)(
            *arrays)
    got = tl(*_tensors(T, arrays))
    assert_close(got, want, "reduce", case.name)
    after = {k: v for k, v in jl.state_dict().items()}
    for k, v in tl.state_dict().items():
        assert_close(v, after[k], "reduce", f"{case.name}.{k}")


# ---------------------------------------------------------------------------
# AMP policies of the functionals
# ---------------------------------------------------------------------------
AMP = {
    "black": [lambda F, x, y: F.softmax(x), lambda F, x, y: F.log_softmax(x),
              lambda F, x, y: F.cross_entropy(x, F.softmax(y),
                                              soft_label=True)],
    "none": [lambda F, x, y: F.relu(x), lambda F, x, y: F.gelu(x),
             lambda F, x, y: F.mse_loss(x, y),
             lambda F, x, y: F.layer_norm(x, 5)],
}


@pytest.mark.parametrize("policy", sorted(AMP))
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_amp_output_dtypes(policy, in_dtype):
    r = rng()
    a, b = (r.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    jx = [P.to_tensor(v).astype(in_dtype) for v in (a, b)]
    tx = [torch.from_numpy(v).to(getattr(torch, in_dtype)) for v in (a, b)]
    for fn in AMP[policy]:
        with P.amp.auto_cast(dtype="bfloat16"):
            want = fn(P.nn.functional, *jx)
        with T.amp.auto_cast(dtype="bfloat16"):
            got = fn(T.nn.functional, *tx)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-2,
                                   atol=1e-2)


def test_cross_entropy_hard_labels_keep_bf16_logits():
    """Hard labels through softmax run no AMP cast in either package: the
    loss is f32 from bf16 logits without an f32 copy of them.  The port
    rounds the shifted logits to bf16 as the JAX source writes it; XLA's
    CPU fusion keeps the shift in f32, so the two differ by that rounding
    (2**-9 of a shifted logit): rtol 1e-3."""
    r = rng()
    x = r.standard_normal((4, 7)).astype(np.float32)
    y = np.array([1, 0, 6, 3])
    with P.amp.auto_cast(dtype="bfloat16"):
        want = P.nn.functional.cross_entropy(
            P.to_tensor(x).astype("bfloat16"), P.to_tensor(y))
    with T.amp.auto_cast(dtype="bfloat16"):
        got = T.nn.functional.cross_entropy(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(y))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-3)


# ---------------------------------------------------------------------------
# the random activations, in distribution
# ---------------------------------------------------------------------------
def test_rrelu_training_slopes_in_distribution():
    x = -np.ones(20000, np.float32)
    P.seed(3)
    want = -to_np(P.nn.functional.rrelu(P.to_tensor(x), 0.1, 0.3,
                                        training=True))
    T.seed(3)
    got = -to_np(T.nn.functional.rrelu(torch.from_numpy(x), 0.1, 0.3,
                                       training=True))
    assert got.min() >= 0.1 and got.max() < 0.3
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3


def test_gumbel_softmax_in_distribution():
    logits = np.log(np.array([[0.1, 0.2, 0.3, 0.4]] * 5000, np.float32))
    P.seed(4)
    want = to_np(P.nn.functional.gumbel_softmax(P.to_tensor(logits),
                                                hard=True))
    T.seed(4)
    got = to_np(T.nn.functional.gumbel_softmax(torch.from_numpy(logits),
                                               hard=True))
    assert ((got == 0) | (got == 1)).all() and (got.sum(-1) == 1).all()
    counts = np.stack([got.sum(0), want.sum(0)])
    assert scipy.stats.chi2_contingency(counts).pvalue > 1e-3
