"""paddle_tpu_torch's nn library against the JAX package's: the Layer API,
the containers, the common, convolution, pooling and sampling
functionals and their layers, SyncBatchNorm and SpectralNorm, and
``nn.utils``' weight and spectral norm.

Each family is table-driven: the same inputs, made from a numpy seed,
through both packages at tiny shapes, the port on the CPU
(``set_device("cpu")``), each JAX case traced under one ``jax.jit``
(`test_torch_tensor_api.jax_ref`; ops that read values on the host run
eagerly).  Tolerances: f32 outputs and gradients rtol 1e-5 with atol
1e-6 (elementwise) or 1e-5 (sums: convolutions, pools, losses); indices
and other integers exactly.  Layers load the JAX layer's
``state_dict()`` (as numpy) and match its forward and, for the
parametrised ones, the gradients of their parameters.  ``nce`` with a
nonzero seed draws the JAX package's negatives (both use numpy's
``RandomState``) and matches it exactly; with ``seed=0`` it draws fresh
ones, held in distribution, as are the training dropouts.
``SyncBatchNorm`` over two gloo ranks rides the two-rank job of
``tests/test_torch_tensor_parallel.py`` and is held against the JAX
``BatchNorm`` on the global batch.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import jax
import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu as P
import paddle_tpu.nn.utils  # noqa: F401  (P.nn.utils)
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_nn_functional import C, const, f, floats, m, u
from test_torch_tensor_api import (_public, _tensors, assert_close,
                                   check_forward, cotangents, jax_ref,
                                   port_grads, rng, to_np)

R, X = "reduce", "exact"


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def ints(*a):
    return lambda r: np.asarray(a[0] if len(a) == 1 else a)


def grid(*shape):
    return lambda r: r.uniform(-1.2, 1.2, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# functionals: common
# ---------------------------------------------------------------------------
COMMON = [
    C("linear", floats((3, 4), (4, 5), (5,)), lambda F, x, w, b: [
        F.linear(x, w, b), F.linear(x, w)], R),
    C("embedding", m(f(6, 3), const([[0, 2], [5, 2]])), lambda F, w, i: [
        F.embedding(i, w), F.embedding(i, w, padding_idx=2)]),
    C("one_hot", m(const([0, 3, 1])), lambda F, i: F.one_hot(i, 4), X,
      grad=False),
    C("label_smooth", m(u(3, 4), u(1, 4)), lambda F, y, p: [
        F.label_smooth(y), F.label_smooth(y, p, 0.2)]),
    C("cosine_similarity", floats((3, 4, 5), (3, 4, 5)), lambda F, a, b: [
        F.cosine_similarity(a, b), F.cosine_similarity(a, b, axis=-1)], R),
    C("pairwise_distance", floats((3, 5), (3, 5)), lambda F, a, b: [
        F.pairwise_distance(a, b),
        F.pairwise_distance(a, b, p=1.0, keepdim=True)], R),
    C("bilinear", floats((3, 4), (3, 5), (2, 4, 5), (2,)),
      lambda F, a, b, w, bi: [F.bilinear(a, b, w, bi), F.bilinear(a, b, w)],
      R),
    C("pixel_shuffle", floats((2, 8, 3, 3), (2, 3, 3, 8)), lambda F, x, y: [
        F.pixel_shuffle(x, 2), F.pixel_shuffle(y, 2, "NHWC")]),
    C("pixel_unshuffle", floats((2, 2, 4, 6)),
      lambda F, x: F.pixel_unshuffle(x, 2)),
    C("channel_shuffle", floats((2, 6, 2, 2)),
      lambda F, x: F.channel_shuffle(x, 3)),
    C("unfold", floats((2, 3, 5, 6)), lambda F, x: [
        F.unfold(x, 2), F.unfold(x, [2, 3], strides=[1, 2], paddings=[1, 0],
                                 dilations=[2, 1])]),
    C("fold", floats((2, 12, 20)),
      lambda F, x: F.fold(x, [4, 5], 2, paddings=[1, 0]), R),
    C("interpolate", floats((2, 3, 4, 5), (2, 4, 5, 3), (2, 3, 5),
                            (1, 2, 3, 4, 4)),
      lambda F, x, xl, x1, x3: [
          F.interpolate(x, size=[6, 7]),
          F.interpolate(x, scale_factor=0.5),
          F.interpolate(x, size=[7, 9], mode="bilinear"),
          F.interpolate(x, size=[2, 3], mode="bilinear"),
          F.interpolate(x, size=[6, 8], mode="bicubic"),
          F.interpolate(x, size=[2, 2], mode="area"),
          F.interpolate(xl, size=[3, 7], mode="bilinear",
                        data_format="NHWC"),
          F.interpolate(x1, size=8, mode="linear", data_format="NCW"),
          F.interpolate(x3, size=[4, 5, 3], mode="trilinear",
                        data_format="NCDHW")], R),
    C("upsample", floats((2, 3, 4, 5)), lambda F, x: [
        F.upsample(x, scale_factor=2, mode="bilinear"),
        F.upsample(x, size=[3, 3])], R),
    C("affine_grid", floats((2, 2, 3)), lambda F, t: [
        F.affine_grid(t, [2, 3, 4, 5]),
        F.affine_grid(t, [2, 3, 4, 5], align_corners=False)], R),
    C("grid_sample", m(f(2, 3, 4, 5), grid(2, 3, 4, 2)), lambda F, x, g: [
        F.grid_sample(x, g), F.grid_sample(x, g, padding_mode="border"),
        F.grid_sample(x, g, align_corners=False),
        F.grid_sample(x, g, mode="nearest")], R),
    C("temporal_shift", floats((4, 8, 2, 2)), lambda F, x: [
        F.temporal_shift(x, 2), F.temporal_shift(x, 2, 0.5)]),
    C("npair_loss", m(f(4, 3), f(4, 3), const([0, 1, 0, 2])),
      lambda F, a, p, y: F.npair_loss(a, p, y), R),
    C("dropout", floats((2, 3, 4, 5), (2, 3, 2, 4, 5)), lambda F, x, x3: [
        F.dropout(x, 0.3, training=False),
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        F.dropout2d(x, 0.3, training=False),
        F.dropout3d(x3, 0.3, training=False),
        F.alpha_dropout(x, 0.3, training=False)]),
]

# ---------------------------------------------------------------------------
# functionals: convolutions
# ---------------------------------------------------------------------------
CONV = [
    C("conv1d", floats((2, 4, 9), (6, 2, 3), (6,), (2, 9, 4)),
      lambda F, x, w, b, xl: [
          F.conv1d(x, w, b, padding=1, groups=2),
          F.conv1d(x, w, stride=2, padding="SAME", dilation=2, groups=2),
          F.conv1d(x, w, b, padding=[1, 2], groups=2),
          F.conv1d(xl, w, b, padding="VALID", groups=2, data_format="NLC")],
      R),
    C("conv2d", floats((2, 4, 7, 8), (6, 4, 3, 3), (6,), (2, 7, 8, 4),
                       (6, 2, 3, 3)),
      lambda F, x, w, b, xl, wg: [
          F.conv2d(x, w, b, padding=1),
          F.conv2d(x, w, stride=2, padding="SAME"),
          F.conv2d(x, w, b, padding="valid"),
          F.conv2d(x, w, b, padding=[0, 1, 2, 1]),
          F.conv2d(x, w, padding=[[1, 0], [0, 2]], dilation=2),
          F.conv2d(x, wg, b, stride=[2, 1], padding=[1, 2], groups=2),
          F.conv2d(xl, w, b, padding=1, data_format="NHWC")], R),
    C("conv3d", floats((1, 2, 4, 5, 5), (3, 2, 2, 3, 3), (3,)),
      lambda F, x, w, b: [F.conv3d(x, w, b, padding=1),
                          F.conv3d(x, w, stride=2, padding="SAME")], R),
    C("conv1d_transpose", floats((2, 4, 5), (4, 3, 3), (3,)),
      lambda F, x, w, b: [
          F.conv1d_transpose(x, w, b, stride=2, padding=1,
                             output_padding=1),
          F.conv1d_transpose(x, w, padding=[0, 2], dilation=2),
          F.conv1d_transpose(x, w, groups=2)], R),
    C("conv2d_transpose", floats((2, 4, 3, 4), (4, 2, 3, 3), (2,),
                                 (2, 3, 4, 4)),
      lambda F, x, w, b, xl: [
          F.conv2d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
          F.conv2d_transpose(x, w, b, padding=[1, 0, 0, 1]),
          F.conv2d_transpose(x, w, groups=2, dilation=2),
          F.conv2d_transpose(x, w, b, stride=[2, 3], output_padding=[1, 2],
                             output_size=[8, 12]),
          F.conv2d_transpose(xl, w, b, stride=2, data_format="NHWC")], R),
    C("conv3d_transpose", floats((1, 2, 3, 3, 3), (2, 2, 2, 2, 2), (2,)),
      lambda F, x, w, b: F.conv3d_transpose(x, w, b, stride=2), R),
]

# ---------------------------------------------------------------------------
# functionals: pooling
# ---------------------------------------------------------------------------
POOL = [
    C("max_pool1d", floats((2, 3, 9)), lambda F, x: [
        F.max_pool1d(x, 3, 2, 1), F.max_pool1d(x, 2, ceil_mode=True),
        F.max_pool1d(x, 4, 3, "SAME"), F.max_pool1d(x, 3, return_mask=True)],
      R),
    C("avg_pool1d", floats((2, 3, 9)), lambda F, x: [
        F.avg_pool1d(x, 3, 2, 1), F.avg_pool1d(x, 3, 2, 1, exclusive=False),
        F.avg_pool1d(x, 2, ceil_mode=True), F.avg_pool1d(x, 4, 3, "SAME")],
      R),
    C("max_pool2d", floats((2, 3, 7, 8), (2, 7, 8, 3)), lambda F, x, xl: [
        F.max_pool2d(x, 3, 2, 1, ceil_mode=True), F.max_pool2d(x, 2),
        F.max_pool2d(x, [3, 2], 2, "SAME"),
        F.max_pool2d(x, 2, 1, [[1, 0], [0, 1]]),
        F.max_pool2d(xl, 3, 2, 1, data_format="NHWC"),
        *F.max_pool2d(x, 3, 2, 1, return_mask=True, ceil_mode=True),
        *F.max_pool2d(xl, 2, return_mask=True, data_format="NHWC")], R),
    C("avg_pool2d", floats((2, 3, 7, 8), (2, 7, 8, 3)), lambda F, x, xl: [
        F.avg_pool2d(x, 3, 2, 1), F.avg_pool2d(x, 3, 2, 1, exclusive=False),
        F.avg_pool2d(x, 2, ceil_mode=True),
        F.avg_pool2d(x, [3, 2], 2, "SAME"),
        F.avg_pool2d(xl, 3, 2, 1, data_format="NHWC")], R),
    C("max_pool3d", floats((1, 2, 5, 6, 6)), lambda F, x: [
        F.max_pool3d(x, 2), F.max_pool3d(x, 3, 2, 1, ceil_mode=True),
        *F.max_pool3d(x, 2, return_mask=True)], R),
    C("avg_pool3d", floats((1, 2, 5, 6, 6)), lambda F, x: [
        F.avg_pool3d(x, 2), F.avg_pool3d(x, 3, 2, 1, ceil_mode=True)], R),
    C("adaptive_avg_pool1d", floats((2, 3, 10)), lambda F, x: [
        F.adaptive_avg_pool1d(x, 5), F.adaptive_avg_pool1d(x, 3)], R),
    C("adaptive_avg_pool2d", floats((2, 3, 7, 8), (2, 7, 8, 3)),
      lambda F, x, xl: [
          F.adaptive_avg_pool2d(x, [3, 4]), F.adaptive_avg_pool2d(x, 1),
          F.adaptive_avg_pool2d(xl, [2, 3], data_format="NHWC")], R),
    C("adaptive_avg_pool3d", floats((1, 2, 5, 6, 6)),
      lambda F, x: F.adaptive_avg_pool3d(x, [2, 3, 4]), R),
    C("adaptive_max_pool1d", floats((2, 3, 10)), lambda F, x: [
        F.adaptive_max_pool1d(x, 5), F.adaptive_max_pool1d(x, 3)], R),
    C("adaptive_max_pool2d", floats((2, 3, 7, 8)), lambda F, x: [
        F.adaptive_max_pool2d(x, [3, 4]), F.adaptive_max_pool2d(x, 2)], R),
    C("adaptive_max_pool3d", floats((1, 2, 5, 6, 6)),
      lambda F, x: F.adaptive_max_pool3d(x, [2, 3, 4]), R),
    C("max_unpool2d", floats((2, 3, 6, 8)), lambda F, x: F.max_unpool2d(
        *F.max_pool2d(x, 2, return_mask=True), 2), R),
    C("spatial_pyramid_pool", floats((2, 3, 8, 8)), lambda F, x: [
        F.spatial_pyramid_pool(x, 3),
        F.spatial_pyramid_pool(x, 2, "avg")], R),
    C("spp", floats((2, 3, 5, 6)), lambda F, x: F.spp(x, 2), R),
]

# ---------------------------------------------------------------------------
# functionals: sampled losses
# ---------------------------------------------------------------------------
_PATH_TABLE = [[0, 1, -1], [0, 1, 2], [0, 2, -1], [0, 1, 2]]
_PATH_CODE = [[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1]]
SAMPLING = [
    C("hsigmoid_loss", m(f(5, 3), const([0, 5, 2, 3, 1]), f(5, 3), f(5)),
      lambda F, x, y, w, b: [F.hsigmoid_loss(x, y, 6, w, b),
                             F.hsigmoid_loss(x, y, 6, w)], R),
    C("hierarchical_sigmoid", m(f(4, 3), const([0, 1, 2, 3]), f(3, 3),
                                f(3)),
      lambda F, x, y, w, b: F.hierarchical_sigmoid(
          x, y, 4, w, b, path_table=torch.tensor(_PATH_TABLE)
          if isinstance(x, torch.Tensor) else P.to_tensor(_PATH_TABLE),
          path_code=torch.tensor(_PATH_CODE)
          if isinstance(x, torch.Tensor) else P.to_tensor(_PATH_CODE)), R),
    C("nce", m(f(4, 3), const([[1], [7], [3], [0]]), f(8, 3), f(8),
               u(8)),
      lambda F, x, y, w, b, d: [
          F.nce(x, y, w, b, num_neg_samples=5, seed=11),
          F.nce(x, y, w, None, 8, 3, "log_uniform", seed=12),
          F.nce(x, y, w, b, num_neg_samples=4, sampler="custom_dist",
                custom_dist=np.asarray(to_np(d), np.float64), seed=13)], R),
]

CASES = COMMON + CONV + POOL + SAMPLING


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


# the shape-generic rows chip_smoke.py's phase 22 runs at ResNet-50's
# stages, here at a [2, 4, 8, 8] stage
STAGE = (2, 4, 8, 8)


@pytest.mark.parametrize("op", tab.CONV_POOL + tab.SAMPLED, ids=repr)
def test_stage_table(op):
    arrays = op.inputs(rng(), STAGE)
    check_forward(op, lambda pkg, *xs: op.call(pkg, *xs), arrays, op.family)


def _draws(pkg, fn, x, seed):
    pkg.seed(seed)
    return to_np(fn(pkg.nn.functional, pkg.to_tensor(x) if pkg is P
                    else torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["dropout3d", "alpha_dropout", "nce"])
def test_random_draws_in_distribution(name):
    """The training dropouts keep each channel (``dropout3d``) or element
    with probability 1 - p, and ``alpha_dropout``'s outputs, and
    ``nce``'s costs with fresh negatives (``seed=0``), follow the JAX
    package's distribution (two-sample KS, p > 1e-3)."""
    r = rng(5)
    if name == "nce":
        x, w, b = (r.standard_normal(s).astype(np.float32)
                   for s in ((400, 3), (50, 3), (50,)))
        y = r.integers(0, 50, (400, 1))

        def cost(pkg):
            t = (lambda a: pkg.to_tensor(a)) if pkg is P else torch.from_numpy
            return to_np(pkg.nn.functional.nce(t(x), t(y), t(w), t(b),
                                               num_neg_samples=3)).ravel()
        got, want = cost(T), cost(P)
        assert not np.array_equal(cost(T), got)  # fresh draws a call
    elif name == "dropout3d":
        x = np.ones((40, 50, 2, 2, 2), np.float32)
        fn = lambda F, t: F.dropout3d(t, 0.3)  # noqa: E731
        got, want = (_draws(pkg, fn, x, 3)[:, :, 0, 0, 0].ravel()
                     for pkg in (T, P))
        keep = _draws(T, fn, x, 3)
        assert (keep == keep[:, :, :1, :1, :1]).all()  # whole channels
    else:
        x = r.standard_normal(20000).astype(np.float32)
        fn = lambda F, t: F.alpha_dropout(t, 0.2)  # noqa: E731
        got, want = (_draws(pkg, fn, x, 4) for pkg in (T, P))
        assert abs(got.mean()) < 0.05 and abs(got.std() - 1) < 0.05
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3


def test_every_public_name_has_a_counterpart():
    """Every public name of the JAX modules this slice ports exists in the
    port, and every functional of them has a case here."""
    import importlib
    fn_mods = ["common", "conv", "pooling", "sampling"]
    names = set()
    for mod in fn_mods:
        names |= _public(importlib.import_module(
            f"paddle_tpu.nn.functional.{mod}"))
    assert all(hasattr(T.nn.functional, nm) for nm in names), \
        sorted(nm for nm in names if not hasattr(T.nn.functional, nm))
    covered = {c.name for c in CASES} | {"dropout2d", "dropout3d",
                                         "alpha_dropout", "upsample"}
    assert names - covered == set(), sorted(names - covered)
    for mod, ns in [("paddle_tpu.nn.layer.layers", T.nn),
                    ("paddle_tpu.nn.layer.container", T.nn),
                    ("paddle_tpu.nn.layer.common", T.nn),
                    ("paddle_tpu.nn.layer.conv", T.nn),
                    ("paddle_tpu.nn.layer.pooling", T.nn),
                    ("paddle_tpu.nn.layer.rnn", T.nn),
                    ("paddle_tpu.nn.layer.transformer", T.nn),
                    ("paddle_tpu.nn.layer.norm", T.nn),
                    ("paddle_tpu.nn.utils", T.nn.utils),
                    ("paddle_tpu.nn.decode", T.nn.decode)]:
        pub = {nm for nm in _public(importlib.import_module(mod))
               if nm not in ("Tensor", "dispatch", "unwrap", "Layer",
                             "Parameter", "Dropout", "Linear", "LayerNorm",
                             "gather_tree")} | ({"Layer", "Parameter"}
                                                if mod.endswith("layers")
                                                else set())
        missing = [nm for nm in pub if not hasattr(ns, nm)
                   and not hasattr(T.nn.layer.transformer, nm)
                   and not hasattr(T.nn.layer.layers, nm)]
        assert missing == [], (mod, missing)
    from paddle_tpu.models import bert as JB
    from paddle_tpu_torch.models import bert as TB
    assert set(JB.__all__) <= set(TB.__all__)
    assert hasattr(T, "gather_tree") and hasattr(T.ops, "gather_tree")


# ---------------------------------------------------------------------------
# layers: the JAX layer's state loads into the port's, equal forwards
# ---------------------------------------------------------------------------
class L:
    """``cls(*args, **kw)`` of both packages over the tensors of
    ``make``."""

    def __init__(self, name, args=(), make=floats((2, 4, 6, 6)), kw=None,
                 grad=False):
        self.name, self.args, self.make = name, args, make
        self.kw, self.grad = kw or {}, grad

    def __repr__(self):
        return self.name


LAYERS = [L(nm) for nm in ("Identity", "Dropout", "Dropout2D",
                           "AlphaDropout", "Flatten")] + [
    L("UpsamplingNearest2D", kw=dict(scale_factor=2)),
    L("Dropout3D", make=floats((2, 4, 3, 3, 3))),
    L("UpsamplingBilinear2D", kw=dict(scale_factor=2)),
    L("Upsample", kw=dict(size=[3, 5], mode="bicubic")),
    L("Linear", (6, 3), make=floats((2, 6)), grad=True),
    L("Embedding", (6, 3), kw=dict(padding_idx=1),
      make=ints([[0, 1], [5, 1]]), grad=True),
    L("Bilinear", (3, 4, 2), make=floats((5, 3), (5, 4)), grad=True),
    L("CosineSimilarity", make=floats((2, 4), (2, 4))),
    L("PairwiseDistance", (1.5,), make=floats((2, 4), (2, 4))),
    L("Pad1D", ([1, 2],), kw=dict(mode="reflect"), make=floats((2, 3, 5))),
    L("Pad2D", ([1, 0, 2, 1],), kw=dict(value=0.5)),
    L("Pad3D", ([1, 0, 1, 1, 0, 2],), kw=dict(mode="replicate"),
      make=floats((1, 2, 3, 3, 3))),
    L("ZeroPad2D", ([1, 1, 0, 2],)),
    L("PixelShuffle", (2,)), L("PixelUnshuffle", (2,)),
    L("ChannelShuffle", (2,)), L("Unfold", (3,)),
    L("Fold", ([4, 4], 2), make=floats((2, 8, 9))),
    L("Conv1D", (4, 6, 3), kw=dict(padding=1, groups=2),
      make=floats((2, 4, 7)), grad=True),
    L("Conv2D", (4, 6, 3), kw=dict(stride=2, padding="SAME"), grad=True),
    L("Conv3D", (2, 3, 2), make=floats((1, 2, 3, 4, 4)), grad=True),
    L("Conv1DTranspose", (4, 2, 3), kw=dict(stride=2, output_padding=1),
      make=floats((2, 4, 5)), grad=True),
    L("Conv2DTranspose", (4, 6, 3), kw=dict(padding=1, groups=2),
      grad=True),
    L("Conv3DTranspose", (2, 3, 2), kw=dict(stride=2),
      make=floats((1, 2, 2, 3, 3)), grad=True),
    L("MaxPool1D", (3, 2), make=floats((2, 4, 9))),
    L("MaxPool2D", (3, 2, 1)), L("MaxPool3D", (2,),
                                 make=floats((1, 2, 4, 4, 4))),
    L("AvgPool1D", (3, 2, 1), make=floats((2, 4, 9))),
    L("AvgPool2D", (2,)), L("AvgPool3D", (2,), make=floats((1, 2, 4, 4, 4))),
    L("AdaptiveAvgPool1D", (4,), make=floats((2, 4, 9))),
    L("AdaptiveAvgPool2D", ([4, 3],)),
    L("AdaptiveAvgPool3D", (2,), make=floats((1, 2, 4, 5, 4))),
    L("AdaptiveMaxPool1D", (4,), make=floats((2, 4, 9))),
    L("AdaptiveMaxPool2D", ([4, 3],)),
    L("AdaptiveMaxPool3D", (2,), make=floats((1, 2, 4, 5, 4))),
    L("SyncBatchNorm", (4,)),
    L("SpectralNorm", ([4, 3, 2],), kw=dict(dim=1, power_iters=2),
      make=floats((4, 3, 2)), grad=True),
]


def _jax_layer(case):
    jl = getattr(P.nn, case.name)(*case.args, **case.kw)
    r = rng(3)
    for p in jl.parameters():
        p.set_value((np.asarray(p.numpy()) + 0.1 * r.standard_normal(
            p.shape)).astype(np.float32))
    return jl


def _port_layer(case, jl):
    tl = getattr(T.nn, case.name)(*case.args, **case.kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing, unexpected = tl.set_state_dict(state)
    assert missing == [] and unexpected == [], (missing, unexpected)
    return tl


def jax_layer_run(jl, arrays, grad, call=None):
    """``(outputs, {name: grad})`` of the JAX layer ``jl`` on ``arrays``
    (``call(jl, *tensors)``, default ``jl(*tensors)``) under one
    ``jax.jit``: the parameters enter as arguments, and with ``grad``
    `paddle_tpu.grad` of the float outputs against `cotangents` runs
    inside the trace."""
    named = list(jl.named_parameters())

    def run(xs, ps):
        old = [p._array for _, p in named]
        try:
            for (_, p), a in zip(named, ps):
                p._array = a
            ins = [P.Tensor(a) for a in xs]
            outs = tab.flat(call(jl, *ins) if call else jl(*ins))
            grads = {}
            if grad:
                fl = [o for o in outs if "float" in str(o.dtype)]
                cots = cotangents([tuple(o.shape) for o in fl])
                gs = P.grad(fl, [p for _, p in named],
                            grad_outputs=[P.Tensor(c) for c in cots],
                            allow_unused=True)
                grads = {n: None if g is None else g._array
                         for (n, _), g in zip(named, gs)}
            return [o._array for o in outs], grads
        finally:
            for (_, p), a in zip(named, old):
                p._array = a

    outs, grads = jax.jit(run)(list(arrays), [p._array for _, p in named])
    return [np.asarray(o) for o in outs], \
        {k: None if v is None else np.asarray(v) for k, v in grads.items()}


def port_layer_grads(tl, outs):
    fl = [o for o in outs if o.is_floating_point()]
    cots = [torch.from_numpy(c) for c in
            cotangents([tuple(o.shape) for o in fl])]
    named = [(n, p) for n, p in tl.named_parameters()]
    gs = torch.autograd.grad(fl, [p for _, p in named], cots,
                             allow_unused=True)
    return {n: g for (n, _), g in zip(named, gs)}


@pytest.mark.parametrize("case", LAYERS, ids=repr)
def test_layer_loads_jax_state_and_matches(case):
    arrays = case.make(rng())
    arrays = arrays if isinstance(arrays, list) else [arrays]
    jl = _jax_layer(case).eval()
    tl = _port_layer(case, jl).eval()
    want, jgrads = jax_layer_run(jl, arrays, case.grad)
    got = tab.flat(tl(*_tensors(T, arrays)))
    assert_close(got, want, R, case.name)
    if case.grad:
        tgrads = port_layer_grads(tl, got)
        assert set(tgrads) == set(jgrads)
        for k, g in tgrads.items():
            if jgrads[k] is None:  # unused (SpectralNorm's weight_v)
                assert g is None, k
            else:
                assert_close(g, jgrads[k], R, f"{case.name}.grad.{k}")


def test_embedding_padding_row_starts_at_zero():
    for pkg in (P, T):
        w = to_np(pkg.nn.Embedding(5, 3, padding_idx=2).weight)
        assert (w[2] == 0).all() and (w[[0, 1, 3, 4]] != 0).all()


# ---------------------------------------------------------------------------
# the Layer API and the containers, against the JAX package's
# ---------------------------------------------------------------------------
def _tree(pkg):
    """A small tree of layers built by Paddle's registration calls."""
    nn = pkg.nn
    root = nn.Layer()
    root.add_sublayer("body", nn.Sequential([("fc", nn.Linear(3, 4)),
                                             ("act", nn.ReLU())]))
    root.add_sublayer("heads", nn.LayerDict({"a": nn.Linear(4, 2)}))
    root.add_sublayer("blocks", nn.LayerList([nn.Linear(2, 2)] * 1))
    extra = nn.Linear(2, 2).weight
    root.add_parameter("scale", extra)
    buf = pkg.ones([2]) if pkg is P else torch.ones(2)
    kept = pkg.zeros([2]) if pkg is P else torch.zeros(2)
    assert root.register_buffer("tmp", buf, persistable=False) is buf
    root.register_buffer("kept", kept)
    return root


def test_layer_registries_match_jax():
    jr, tr = _tree(P), _tree(T)
    for include_self in (False, True):
        assert [n for n, _ in tr.named_sublayers(include_self=include_self)] \
            == [n for n, _ in jr.named_sublayers(include_self=include_self)]
        assert len(tr.sublayers(include_self)) == len(
            jr.sublayers(include_self))
    # the same names (torch lists each layer's buffers beside its
    # parameters, JAX all parameters first)
    assert sorted(tr.state_dict()) == sorted(jr.state_dict())
    assert "tmp" not in tr.state_dict()
    jp, jb = jr.functional_state()
    tp, tb = tr.functional_state()
    assert sorted(tp) == sorted(jp) and sorted(tb) == sorted(jb)
    assert tr.full_name() == jr.full_name() == "layer"
    assert tr.body.full_name() == jr.body.full_name() == "sequential"
    # children first, then the layer itself
    seen, jseen = [], []
    assert tr.apply(lambda ly: seen.append(ly.full_name())) is tr
    jr.apply(lambda ly: jseen.append(type(ly).__mro__[0].__name__.lower()
                                     .replace("_act", "relu")))
    assert seen == jseen


def test_hooks_cast_and_containers():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = {}
    for pkg in (P, T):
        nn = pkg.nn
        seq = nn.Sequential([("fc", nn.Linear(3, 3)), ("act", nn.ReLU())])
        seq.fc.weight.set_value(np.eye(3, dtype=np.float32)) if pkg is P \
            else seq.fc.weight.data.copy_(torch.eye(3))
        assert seq["act"] is seq[1] and len(seq) == 2
        assert [type(s).__name__ for s in seq[:1]] == ["Linear"]
        pre = seq.register_forward_pre_hook(lambda ly, inp: (inp[0] * 2,))
        post = seq.register_forward_post_hook(
            lambda ly, inp, out: out + 1)
        t = pkg.to_tensor(x) if pkg is P else torch.from_numpy(x)
        hooked = to_np(seq(t))
        pre.remove()
        post.remove()
        plain = to_np(seq(t))
        seq.astype("bfloat16")
        params = nn.ParameterList([seq.fc.weight])
        params.append(seq.fc.bias)
        d = nn.LayerDict()
        d["x"] = nn.ReLU()
        d.update([("y", nn.Tanh())])
        popped = d.pop("x")
        outs[pkg.__name__] = (hooked, plain, str(seq.fc.weight.dtype),
                              len(params), list(d.keys()),
                              isinstance(popped, nn.ReLU),
                              [n for n, _ in params.named_parameters()])
    jo, to = outs["paddle_tpu"], outs["paddle_tpu_torch"]
    np.testing.assert_array_equal(to[0], jo[0])
    np.testing.assert_array_equal(to[1], jo[1])
    assert to[2] == "torch.bfloat16" and jo[2] == "bfloat16"
    assert to[3:] == jo[3:]


def test_layer_to_takes_paddle_names():
    lin = T.nn.Linear(2, 2)
    assert lin.to(device="cpu", dtype="float64").weight.dtype == \
        torch.float64
    assert lin.to("float32").weight.dtype == torch.float32
    assert lin.to(T.CPUPlace()).weight.device.type == "cpu"
    p = T.nn.Parameter(np.ones((2, 2), np.float32), is_bias=True)
    assert p.requires_grad and p.is_bias and \
        p.optimize_attr == {"learning_rate": 1.0}


# ---------------------------------------------------------------------------
# SyncBatchNorm and SpectralNorm
# ---------------------------------------------------------------------------
def test_sync_batchnorm_one_process_is_batchnorm_and_converts():
    """One process: SyncBatchNorm is BatchNorm (training statistics and
    running buffers as JAX's); ``convert_sync_batchnorm`` swaps every
    BatchNorm of a tree, keeping its parameters, as JAX's does."""
    x = rng().standard_normal((4, 3, 2, 2)).astype(np.float32)
    jl, tl = P.nn.SyncBatchNorm(3), T.nn.SyncBatchNorm(3)
    assert_close(tl(torch.from_numpy(x)), jl(P.to_tensor(x)), R)
    assert_close(tl._mean, jl._mean, R)
    assert_close(tl._variance, jl._variance, R)
    for pkg in (P, T):
        net = pkg.nn.Sequential(pkg.nn.Conv2D(3, 3, 1),
                                pkg.nn.BatchNorm2D(3))
        net[1].weight.set_value(np.full(3, 2.0, np.float32)) if pkg is P \
            else net[1].weight.data.fill_(2.0)
        out = pkg.nn.SyncBatchNorm.convert_sync_batchnorm(net)
        assert [type(s).__name__ for s in out.sublayers()] == [
            "Conv2D", "SyncBatchNorm"]
        assert (to_np(out[1].weight) == 2.0).all()


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    from test_torch_tensor_parallel import tp_job
    return tp_job(tmp_path_factory)


def _batch_norm_f64(a):
    """BatchNorm2D in training over the whole batch of ``a``
    (`sync_bn_inputs`) in f64: the output and the weight's gradient."""
    x, cot = a["x"].astype(np.float64), a["cot"].astype(np.float64)
    mean = x.mean((0, 2, 3), keepdims=True)
    xhat = (x - mean) / np.sqrt(((x - mean) ** 2).mean((0, 2, 3),
                                                       keepdims=True) + 1e-5)
    return (xhat * a["w"].reshape(1, -1, 1, 1) + a["b"].reshape(1, -1, 1, 1),
            (cot * xhat).sum((0, 2, 3)))


@pytest.mark.parametrize("case", ["centred", "uncentred"])
def test_sync_batchnorm_two_gloo_ranks_match_global_batchnorm(tp, case):
    """Two gloo ranks, each with half the batch: each rank's output and
    input gradient equal JAX ``BatchNorm``'s on the global batch at that
    rank's rows, both ranks' running buffers equal its, and the ranks'
    parameter gradients sum to its (rtol 1e-5, atol 1e-5).

    "uncentred" has channel means of about 100 against a std of 1, where
    a one-pass variance loses its digits.  Both packages apply the
    statistics as x * s + t, whose output and weight gradient (through
    sum(cot * x)) round at |x| / std times a centred x's: the JAX
    package's own dw is 4e-3 off the f64 truth there.  So in that case
    the output and dw are held to the f64 BatchNorm within the larger of
    the tolerance and the JAX package's own distance from it; the rest
    against JAX as above."""
    import torch_hybrid_runner as HR

    a = HR.sync_bn_inputs(case)
    jl = P.nn.BatchNorm2D(a["x"].shape[1])
    jl.weight.set_value(a["w"])
    jl.bias.set_value(a["b"])
    x = P.to_tensor(a["x"], stop_gradient=False)
    out = jl(x)
    gx, gw, gb = P.grad([out], [x, jl.weight, jl.bias],
                        grad_outputs=[P.to_tensor(a["cot"])])
    out, gw = to_np(out), to_np(gw)
    rtol, atol = tab.TOL[R]

    def held(got, want, label):
        if case == "centred":
            return assert_close(got, want, R, label)
        truth_out, truth_dw = _batch_norm_f64(a)
        truth = truth_dw if label == "dw" else truth_out[rows]
        allowed = np.maximum(np.abs(want - truth).max(),
                             atol + rtol * np.abs(truth))
        excess = np.abs(got - truth) - allowed
        assert excess.max() <= 0, (label, excess.max())

    half = a["x"].shape[0] // 2
    for r, res in enumerate(tp):
        got = res["sync_bn"][case]
        rows = slice(r * half, (r + 1) * half)
        held(got["out"], out[rows], f"rank {r} out")
        assert_close(got["dx"], to_np(gx)[rows], R, f"rank {r} dx")
        assert_close(got["mean"], jl._mean, R)
        assert_close(got["variance"], jl._variance, R)
    held(sum(res["sync_bn"][case]["dw"] for res in tp), gw, "dw")
    assert_close(sum(res["sync_bn"][case]["db"] for res in tp), gb, R)


# ---------------------------------------------------------------------------
# nn.utils: weight_norm, remove_weight_norm, spectral_norm
# ---------------------------------------------------------------------------
def _linear_pair(seed=3):
    jl = P.nn.Linear(4, 3)
    r = rng(seed)
    jl.weight.set_value(r.standard_normal((4, 3)).astype(np.float32))
    tl = T.nn.Linear(4, 3)
    tl.set_state_dict({k: to_np(v) for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_and_its_gradient_reaches_neither_g_nor_v(dim):
    """``weight_g``/``weight_v`` and the rebuilt weight equal JAX's; as in
    the JAX package's eager mode (its hook rebuilds the weight from the
    unwrapped arrays) a loss's gradient reaches neither ``weight_g`` nor
    ``weight_v``, only the bias; ``remove_weight_norm`` restores one
    trainable ``weight``."""
    jl, tl = _linear_pair()
    P.nn.utils.weight_norm(jl, dim=dim)
    T.nn.utils.weight_norm(tl, dim=dim)
    for nm in ("weight_g", "weight_v", "weight"):
        assert_close(getattr(tl, nm), getattr(jl, nm), R, nm)
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        n for n, _ in jl.named_parameters())
    x = rng(4).standard_normal((2, 4)).astype(np.float32)
    jl(P.to_tensor(x)).sum().backward()
    tl(torch.from_numpy(x)).sum().backward()
    assert jl.weight_g.grad is None and jl.weight_v.grad is None
    assert tl.weight_g.grad is None and tl.weight_v.grad is None
    assert_close(tl.bias.grad, jl.bias.grad, R)
    P.nn.utils.remove_weight_norm(jl)
    T.nn.utils.remove_weight_norm(tl)
    assert_close(tl.weight, jl.weight, R)
    assert isinstance(tl.weight, torch.nn.Parameter)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]


def test_spectral_norm_starts_from_jax_draws_and_steps_alike():
    """u and v start from ``np.random.RandomState(0)`` in both packages;
    the normalized weight and the stepped u, v agree after setup and
    after each of two forwards (two power iterations each)."""
    jl, tl = _linear_pair(5)
    P.nn.utils.spectral_norm(jl, n_power_iterations=2, dim=1)
    T.nn.utils.spectral_norm(tl, n_power_iterations=2, dim=1)
    x = rng(6).standard_normal((2, 4)).astype(np.float32)
    for step in range(3):
        for nm in ("weight", "weight_u", "weight_v", "weight_orig"):
            assert_close(getattr(tl, nm), getattr(jl, nm), R,
                         f"{nm} after {step} forwards")
        assert_close(tl(torch.from_numpy(x)), jl(P.to_tensor(x)), R)
    assert "weight_u" not in tl.state_dict() and \
        "weight_orig" in tl.state_dict()
