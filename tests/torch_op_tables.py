"""Op tables of the functional tensor API and nn's activations, norms,
convolutions, pools and sampled losses.

Shared by the CPU parity tests (``tests/test_torch_tensor_api.py``,
``tests/test_torch_nn_functional.py``, ``tests/test_torch_nn_layers.py``:
the port against the JAX package at tiny shapes) and by
``chip_smoke.py``'s phases 21 and 22 (the port on the card against the
port on the CPU at GPT-2-small widths and ResNet-50's stage shapes).  Imports neither JAX
nor either package: a row names an op by its namespace ("" the top
level, "nn.functional", "linalg"), builds its inputs from a numpy
``Generator`` and a shape, and names the family whose tolerance holds it.
"""
from __future__ import annotations

import numpy as np

# (rtol, atol) by family, float32.  Elementwise ops are one rounding of
# the same formula; special functions (erf, lgamma, Bessel, ...) are
# series whose implementations differ by more: near lgamma's zeros at 1
# and 2 JAX's f32 ``gammaln`` is 1.6e-6 from the f64 value (torch's
# 2e-8), so their atol is 5e-6; reductions sum in
# another order; linear algebra is held by its invariants
# (reconstruction, sorted or absolute values).  "exact" outputs (integers,
# bools, indices) are compared by value.
TOL = {"ew": (1e-5, 1e-6), "special": (1e-5, 5e-6), "reduce": (1e-5, 1e-5),
       "linalg": (1e-4, 1e-4), "exact": (0.0, 0.0)}


# -- input kinds: (rng, shape) -> np.ndarray --------------------------------
def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def positive(rng, shape):
    return rng.uniform(0.5, 2.0, shape).astype(np.float32)


def unit(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def above_one(rng, shape):
    return rng.uniform(1.1, 3.0, shape).astype(np.float32)


def prob(rng, shape):
    return rng.uniform(0.05, 0.95, shape).astype(np.float32)


def near_one(rng, shape):
    return rng.uniform(0.97, 1.03, shape).astype(np.float32)


def coarse(rng, shape):
    """Few distinct values: ties for the sorts and comparisons."""
    return rng.integers(-3, 4, shape).astype(np.float32)


def ints(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.int64)


def small_ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.int64)


def pos_ints(rng, shape):
    return rng.integers(1, 13, shape).astype(np.int64)


def bools(rng, shape):
    return rng.random(shape) < 0.5


def with_nan(rng, shape):
    a = normal(rng, shape)
    a[rng.random(shape) < 0.2] = np.nan
    return a


def sorted_rows(rng, shape):
    return np.sort(normal(rng, shape), axis=-1)


def flat(v):
    """Nested lists and tuples of outputs as one list."""
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in flat(x)]
    return [v]


class Op:
    """One op of a table: ``ns.name(*inputs, **kw)``; ``grad`` whether
    its float inputs are differentiated in the gradient cases; ``amp``
    the policy it has under ``auto_cast`` (None: its inputs' dtypes);
    ``acc`` how a reduction's rounding error grows with the n terms
    behind one output: "sum" (a sum or scan of O(1) terms: as sqrt(n),
    a random walk of roundings), "mean" (such a sum over n: as
    1/sqrt(n)), None (a selection, a product or a log-sum: not with n;
    the family's tolerance holds it)."""

    def __init__(self, name, ins, kw=None, ns="", family="ew", grad=True,
                 variants=None, amp=None, label=None, acc=None):
        self.name, self.ins, self.kw, self.ns = name, ins, kw or {}, ns
        self.family, self.grad, self.amp = family, grad, amp
        self.acc = acc
        self.variants = variants or [{}]
        self.label = label or name

    def inputs(self, rng, shape):
        return [kind(rng, shape) for kind in self.ins]

    def fn(self, pkg):
        mod = pkg
        for part in filter(None, self.ns.split(".")):
            mod = getattr(mod, part)
        return getattr(mod, self.name)

    def call(self, pkg, *xs):
        """The op of ``pkg`` on ``xs``, once per variant."""
        return [self.fn(pkg)(*xs, **dict(self.kw, **v))
                for v in self.variants]

    def __repr__(self):
        return self.label


E, S = "ew", "special"

# elementwise ops of one or two tensors of one shape ([8, 1024, 768] on
# the card)
ELEMENTWISE = [
    Op("abs", [normal]), Op("sqrt", [positive]), Op("rsqrt", [positive]),
    Op("square", [normal]), Op("exp", [normal]), Op("expm1", [normal]),
    Op("log", [positive]), Op("log2", [positive]), Op("log10", [positive]),
    Op("log1p", [positive]), Op("sin", [normal]), Op("cos", [normal]),
    Op("tan", [unit]), Op("asin", [unit]), Op("acos", [unit]),
    Op("atan", [normal]), Op("sinh", [normal]), Op("cosh", [normal]),
    Op("tanh", [normal]), Op("asinh", [normal]), Op("acosh", [above_one]),
    Op("atanh", [unit]), Op("floor", [normal], grad=False),
    Op("ceil", [normal], grad=False), Op("round", [normal], grad=False),
    Op("trunc", [normal], grad=False), Op("frac", [normal]),
    Op("sign", [normal], grad=False), Op("neg", [normal]),
    Op("reciprocal", [positive]), Op("erf", [normal], family=S),
    Op("erfinv", [unit], family=S), Op("lgamma", [positive], family=S),
    Op("digamma", [positive], family=S), Op("sigmoid", [normal]),
    Op("logit", [prob]), Op("angle", [normal], grad=False),
    Op("conj", [normal]), Op("real", [normal]),
    Op("imag", [normal], grad=False), Op("deg2rad", [normal]),
    Op("rad2deg", [normal]), Op("rsqrt_", [positive]),
    Op("i0", [normal], family=S), Op("i1", [normal], family=S),
    Op("nan_to_num", [with_nan], grad=False),
    Op("clip", [normal], dict(min=-0.5, max=0.7)),
    Op("stanh", [normal]), Op("scale", [normal], dict(scale=2.0, bias=0.5)),
    Op("isfinite", [with_nan], family="exact", grad=False),
    Op("isnan", [with_nan], family="exact", grad=False),
    Op("isinf", [with_nan], family="exact", grad=False),
    Op("logical_not", [bools], family="exact", grad=False),
    Op("bitwise_not", [ints], family="exact", grad=False),
    Op("add", [normal, normal]), Op("subtract", [normal, normal]),
    Op("multiply", [normal, normal]), Op("divide", [normal, positive]),
    Op("floor_divide", [normal, positive], grad=False),
    Op("remainder", [normal, positive], grad=False),
    Op("mod", [normal, positive], grad=False),
    Op("floor_mod", [normal, positive], grad=False),
    Op("pow", [positive, normal]), Op("maximum", [normal, normal]),
    Op("minimum", [normal, normal]), Op("fmax", [normal, normal]),
    Op("fmin", [normal, normal]), Op("atan2", [normal, normal]),
    Op("hypot", [normal, normal]), Op("logaddexp", [normal, normal]),
    Op("heaviside", [coarse, normal], grad=False),
    Op("gcd", [ints, ints], family="exact", grad=False),
    Op("lcm", [small_ints, small_ints], family="exact", grad=False),
    Op("nextafter", [normal, normal], grad=False),
    Op("copysign", [normal, normal], grad=False),
    Op("ldexp", [normal, small_ints], grad=False),
    Op("lerp", [normal, normal], dict(weight=0.3)),
    Op("equal", [coarse, coarse], family="exact", grad=False),
    Op("not_equal", [coarse, coarse], family="exact", grad=False),
    Op("less_than", [coarse, coarse], family="exact", grad=False),
    Op("less_equal", [coarse, coarse], family="exact", grad=False),
    Op("greater_than", [coarse, coarse], family="exact", grad=False),
    Op("greater_equal", [coarse, coarse], family="exact", grad=False),
    Op("logical_and", [bools, bools], family="exact", grad=False),
    Op("logical_or", [bools, bools], family="exact", grad=False),
    Op("logical_xor", [bools, bools], family="exact", grad=False),
    Op("bitwise_and", [ints, ints], family="exact", grad=False),
    Op("bitwise_or", [ints, ints], family="exact", grad=False),
    Op("bitwise_xor", [ints, ints], family="exact", grad=False),
    Op("isclose", [coarse, coarse], family="exact", grad=False),
]

R = "reduce"
_AXES = [{}, dict(axis=-1), dict(axis=[0, 1], keepdim=True)]

# reductions, each over every axis, the last and the first two
REDUCTIONS = [
    Op("sum", [normal], family=R, variants=_AXES, acc="sum"),
    Op("mean", [normal], family=R, variants=_AXES, amp="black",
       acc="mean"),
    Op("max", [normal], family=R, variants=_AXES),
    Op("min", [normal], family=R, variants=_AXES),
    Op("amax", [normal], family=R, variants=_AXES),
    Op("amin", [normal], family=R, variants=_AXES),
    Op("prod", [near_one], family=R, variants=_AXES),
    Op("logsumexp", [normal], family=R, variants=_AXES, amp="black"),
    Op("nansum", [with_nan], family=R, variants=_AXES, grad=False,
       acc="sum"),
    Op("nanmean", [with_nan], family=R, variants=_AXES, grad=False,
       acc="mean"),
    Op("count_nonzero", [small_ints], family="exact", variants=_AXES,
       grad=False),
    Op("all", [bools], family="exact", variants=_AXES, grad=False),
    Op("any", [bools], family="exact", variants=_AXES, grad=False),
    Op("var", [normal], family=R, variants=_AXES, acc="mean"),
    Op("std", [normal], family=R, variants=_AXES, acc="mean"),
    Op("median", [normal], family=R, variants=_AXES),
    Op("nanmedian", [with_nan], family=R, variants=_AXES, grad=False),
    Op("quantile", [normal], dict(q=0.3), family=R, variants=_AXES),
    Op("nanquantile", [with_nan], dict(q=0.3), family=R, variants=_AXES,
       grad=False),
]

# scans, sorts and searches along the last axis (logits [8, 50304] on the
# card); ties come from `coarse`
SEARCH = [
    Op("cumsum", [normal], dict(axis=-1), family=R, acc="sum"),
    Op("cumprod", [near_one], dict(dim=-1), family=R),
    Op("cummax", [coarse], dict(axis=-1), family="exact", grad=False),
    Op("cummin", [coarse], dict(axis=-1), family="exact", grad=False),
    Op("argmax", [coarse], dict(axis=-1), family="exact", grad=False),
    Op("argmin", [coarse], dict(axis=-1), family="exact", grad=False),
    Op("argsort", [coarse], dict(axis=-1), family="exact", grad=False,
       variants=[{}, dict(descending=True)]),
    Op("sort", [coarse], dict(axis=-1), family="exact", grad=False,
       variants=[{}, dict(descending=True)]),
    Op("topk", [coarse], dict(k=5), family="exact", grad=False,
       variants=[{}, dict(largest=False)]),
    Op("kthvalue", [coarse], dict(k=3), family="exact", grad=False),
    Op("mode", [coarse], family="exact", grad=False),
    Op("searchsorted", [sorted_rows, normal], family="exact", grad=False,
       variants=[{}, dict(right=True)]),
    Op("bucketize", [normal, sorted_rows], family="exact", grad=False),
    Op("logsumexp", [normal], dict(axis=-1), family=R, amp="black",
       label="logsumexp_rows"),
]


# -- linear algebra: inputs made from (rng, n, batch) -----------------------
def general(rng, n, batch=()):
    """A well-conditioned square matrix: the identity plus a normal
    matrix of spectral radius ~0.5."""
    return (0.5 * rng.standard_normal(batch + (n, n)) / np.sqrt(n)
            + np.eye(n)).astype(np.float32)


def spd(rng, n, batch=()):
    a = rng.standard_normal(batch + (n, n)).astype(np.float64) / np.sqrt(n)
    return (a @ np.swapaxes(a, -1, -2) + np.eye(n)).astype(np.float32)


def lower(rng, n, batch=()):
    return np.tril(general(rng, n, batch)).astype(np.float32)


def rhs(rng, n, batch=()):
    return rng.standard_normal(batch + (n, 3)).astype(np.float32)


def cholesky_factor(rng, n, batch=()):
    return np.linalg.cholesky(spd(rng, n, batch)).astype(np.float32)


class LinOp(Op):
    """A linear-algebra op: inputs from makers of ``(rng, n, batch)``;
    ``check`` names the invariant that holds a decomposition ("values":
    the outputs themselves)."""

    def __init__(self, name, makers, kw=None, check="values", grad=True,
                 batched=True, ns=""):
        super().__init__(name, makers, kw, ns=ns, family="linalg",
                         grad=grad)
        self.check, self.batched = check, batched

    def inputs(self, rng, n, batch=()):
        return [b(rng, n, batch if self.batched else ()) for b in self.ins]


def excess(got, want, rtol, atol):
    """How far ``got`` is beyond ``|got - want| <= atol + rtol |want|``:
    the worst ``|d| - atol - rtol |want|`` (<= 0 within it; inf on another
    shape or a NaN); integer and bool outputs must be equal."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    if want.dtype.kind in "biu":
        return 0.0 if np.array_equal(got.astype(np.int64),
                                     want.astype(np.int64)) else float("inf")
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(
        want) else np.float64
    d = (np.abs(got.astype(wide) - want.astype(wide)) - atol
         - rtol * np.abs(want.astype(wide)))
    return float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0


def _orthonormal(q, rtol, atol):
    k = q.shape[-1]
    eye = np.broadcast_to(np.eye(k), q.shape[:-2] + (k, k))
    return excess(np.swapaxes(q, -1, -2).conj() @ q, eye, rtol, atol)


def _wide_gap_columns(vectors, want_vectors, values, rtol, atol):
    """|vectors| against |want_vectors| (signs are free) in the columns
    whose value (``values``: sorted along the last axis) lies at least
    ``10 atol`` from its neighbours: a vector's error is the backward
    error over that gap, so close values leave their vectors free to mix
    and only the reconstruction holds them."""
    gaps = np.abs(np.diff(values, axis=-1))
    inf = np.full(values.shape[:-1] + (1,), np.inf)
    gap = np.minimum(np.concatenate([inf, gaps], -1),
                     np.concatenate([gaps, inf], -1))
    wide = (gap >= 10 * atol)[..., None, :]
    d = (np.abs(np.abs(vectors) - np.abs(want_vectors)) - atol
         - rtol * np.abs(want_vectors))
    return float(np.where(wide, d, -np.inf).max())


def linalg_excess(check, got, want, a, rtol, atol):
    """Hold a linear-algebra result by the invariant ``check`` names,
    against ``want`` (another implementation's outputs) on the input
    matrix ``a``; numpy arrays in.  ``{invariant: excess}``, each <= 0
    within ``(rtol, atol)``.  "values": the outputs themselves; "qr":
    q r = a, |r|, q orthonormal; "svd": s, u diag(s) v^T = a, u and v
    orthonormal, |u| where the values are apart; "eigh": the values,
    a v = v diag(w), v orthonormal, |v| where the values are apart;
    "eig": a v = v diag(w), and the eigenvalues matched without an
    order: their sorted real and imaginary parts and each one's nearest
    other; "lstsq": solution, residuals, rank (equal) and singular
    values."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    a = np.asarray(a, np.float64)
    if check == "values":
        return {f"output {i}": excess(g, w, rtol, atol)
                for i, (g, w) in enumerate(zip(got, want))}
    if check == "qr":
        q, r = got
        return {"q r = a": excess(q.astype(np.float64) @ r, a, rtol, atol),
                "|r|": excess(np.abs(r), np.abs(want[1]), rtol, atol),
                "q orthonormal": _orthonormal(q.astype(np.float64), rtol,
                                              atol)}
    if check == "svd":
        u, s, v = (x.astype(np.float64) for x in got)
        return {"s": excess(s, want[1], rtol, atol),
                "u s v^T = a": excess((u * s[..., None, :])
                                      @ np.swapaxes(v, -1, -2), a, rtol, atol),
                "u orthonormal": _orthonormal(u, rtol, atol),
                "v orthonormal": _orthonormal(v, rtol, atol),
                "|u|": _wide_gap_columns(u, want[0], want[1], rtol, atol)}
    if check == "eigh":
        w, v = (x.astype(np.float64) for x in got)
        return {"w": excess(w, want[0], rtol, atol),
                "a v = v w": excess(a @ v, v * w[..., None, :], rtol, atol),
                "v orthonormal": _orthonormal(v, rtol, atol),
                "|v|": _wide_gap_columns(v, want[1], want[0], rtol, atol)}
    if check == "eig":
        w, v = (x.astype(np.complex128) for x in got)
        ref = want[0].astype(np.complex128)
        apart = (np.abs(w[..., :, None] - ref[..., None, :]) - atol
                 - rtol * np.abs(ref[..., None, :]))
        return {"a v = v w": excess(a @ v, v * w[..., None, :], rtol, atol),
                "sorted real parts": excess(np.sort(w.real, -1),
                                            np.sort(ref.real, -1), rtol, atol),
                "sorted imaginary parts": excess(
                    np.sort(w.imag, -1), np.sort(ref.imag, -1), rtol, atol),
                "nearest eigenvalue": float(max(apart.min(-1).max(),
                                                apart.min(-2).max()))}
    if check == "lstsq":
        return {name: excess(g, w, rtol, atol) for name, g, w in zip(
            ("solution", "residuals", "rank", "singular values"), got, want)}
    raise ValueError(check)


LINALG = [
    LinOp("det", [general]),
    LinOp("slogdet", [general], batched=False, grad=False),
    LinOp("inverse", [general]), LinOp("inv", [general], ns="linalg"),
    LinOp("pinv", [general]), LinOp("matrix_power", [general], dict(n=3)),
    LinOp("matrix_rank", [general], grad=False),
    LinOp("cholesky", [spd]), LinOp("cholesky", [spd], dict(upper=True),
                                    ns="linalg"),
    LinOp("cholesky_solve", [rhs, cholesky_factor]),
    LinOp("solve", [general, rhs]),
    LinOp("triangular_solve", [lower, rhs], dict(upper=False)),
    LinOp("qr", [general], check="qr", grad=False),
    LinOp("svd", [general], check="svd", grad=False),
    LinOp("eigh", [spd], check="eigh", grad=False),
    LinOp("eigvalsh", [spd], grad=False),
    LinOp("eig", [general], check="eig", grad=False),
    LinOp("lstsq", [general, rhs], check="lstsq", grad=False,
          batched=False),
    LinOp("cond", [general], grad=False),
    LinOp("norm", [general], dict(p=2, axis=[-2, -1])),
    LinOp("norm", [general], dict(p=float("inf"), axis=-1), ns="linalg"),
    LinOp("p_norm", [general], dict(p=3)),
    LinOp("dist", [general, general], dict(p=2)),
    LinOp("matmul", [general, general]), LinOp("bmm", [general, general]),
]

N = "nn.functional"
# functional norms of an NCHW activation ([32, 256, 56, 56] on the card);
# "batch_norm" gets running buffers and writes them in training
NORMS = [
    Op("batch_norm", [normal], dict(training=True), ns=N, family=R),
    Op("batch_norm", [normal], dict(training=False), ns=N, family=R,
       label="batch_norm_eval"),
    Op("layer_norm", [normal], ns=N, family=R),
    Op("group_norm", [normal], dict(num_groups=2), ns=N, family=R),
    Op("instance_norm", [normal], ns=N, family=R),
    Op("local_response_norm", [normal], dict(size=5), ns=N, family=R),
    Op("normalize", [normal], dict(axis=1), ns=N, family=R),
]


def norm_args(op, x, rng, pkg_tensor):
    """The extra inputs of a NORMS row over ``x`` [N, C, ...]:
    per-channel affine parameters (and for batch_norm the running
    buffers), each made by ``pkg_tensor(numpy array)``."""
    def affine(c):
        return dict(weight=pkg_tensor((1 + 0.1 * rng.standard_normal(c))
                                      .astype(np.float32)),
                    bias=pkg_tensor((0.1 * rng.standard_normal(c))
                                    .astype(np.float32)))

    c = x.shape[1]
    if op.name == "batch_norm":
        rm = (0.1 * rng.standard_normal(c)).astype(np.float32)
        rv = rng.uniform(0.5, 1.5, c).astype(np.float32)
        return [pkg_tensor(rm), pkg_tensor(rv)], affine(c)
    if op.name == "layer_norm":
        return [[x.shape[-1]]], affine(x.shape[-1])
    if op.name in ("group_norm", "instance_norm"):
        return [], affine(c)
    return [], {}


# -- convolutions, pools and sampled losses over an NCHW stage [N, C, H, W]
# (ResNet-50's stages on the card, [2, 4, 8, 8] in the CPU tests) ---------
def weight(cout, cin, k):
    """A conv weight [cout(s), cin(s), k, k] of the stage ``s``'s channels
    (``cout``/``cin`` multiply them), scaled by 1 / sqrt(fan_in)."""
    def make(rng, s):
        co, ci = int(s[1] * cout), int(s[1] * cin)
        return (rng.standard_normal((co, ci, k, k))
                / np.sqrt(ci * k * k)).astype(np.float32)
    return make


def channel_bias(rng, s):
    return (0.1 * rng.standard_normal(s[1])).astype(np.float32)


def nhwc(rng, s):
    return normal(rng, (s[0], s[2], s[3], s[1]))


def rows_of(rng, s):
    """Features [N * H, C]: one row a sample of a sampled loss."""
    return normal(rng, (s[0] * s[2], s[1]))


def _classes(s):
    return s[2] * s[3]


def class_labels(rng, s):
    return rng.integers(0, _classes(s), (s[0] * s[2], 1)).astype(np.int64)


def class_weight(rng, s):
    return (0.1 * rng.standard_normal((_classes(s), s[1]))).astype(
        np.float32)


def class_bias(rng, s):
    return (0.1 * rng.standard_normal(_classes(s))).astype(np.float32)


def node_weight(rng, s):
    return (0.1 * rng.standard_normal((_classes(s) - 1, s[1]))).astype(
        np.float32)


def node_bias(rng, s):
    return (0.1 * rng.standard_normal(_classes(s) - 1)).astype(np.float32)


class StageOp(Op):
    """A row whose call also takes the stage shape's class count (the
    sampled losses)."""

    def call(self, pkg, x, label, w, b):
        return [self.fn(pkg)(x, label, int(w.shape[0]) + 1, w, b,
                             **dict(self.kw, **v)) for v in self.variants]


# the conv and pool rows of a ResNet-50 stage; "sum" rows add
# C * k * k products an output
CONV_POOL = [
    Op("conv2d", [normal, weight(1, 1, 3), channel_bias], dict(padding=1),
       ns=N, family=R, amp="white", acc="sum", label="conv2d_3x3"),
    Op("conv2d", [normal, weight(4, 1, 1)], ns=N, family=R, amp="white",
       acc="sum", label="conv2d_1x1_expand"),
    Op("conv2d", [normal, weight(2, 1, 3)], dict(stride=2, padding="SAME"),
       ns=N, family=R, amp="white", acc="sum", label="conv2d_3x3_s2_same"),
    Op("conv2d", [normal, weight(1, 0.5, 3)], dict(padding=[0, 1, 1, 0],
                                                   groups=2),
       ns=N, family=R, amp="white", acc="sum",
       label="conv2d_3x3_grouped_asym"),
    Op("conv2d", [nhwc, weight(1, 1, 3)], dict(padding=1,
                                               data_format="NHWC"),
       ns=N, family=R, amp="white", acc="sum", label="conv2d_3x3_nhwc"),
    Op("conv2d_transpose", [normal, weight(1, 1, 2), channel_bias],
       dict(stride=2), ns=N, family=R, amp="white", acc="sum",
       label="conv2d_transpose_2x2_s2"),
    Op("max_pool2d", [normal], dict(kernel_size=3, stride=2, padding=1),
       ns=N, family=R, label="max_pool2d_3x3_s2"),
    Op("max_pool2d", [normal], dict(kernel_size=2, return_mask=True),
       ns=N, family=R, label="max_pool2d_mask"),
    Op("avg_pool2d", [normal], dict(kernel_size=3, stride=2, padding=1,
                                    ceil_mode=True),
       ns=N, family=R, acc="mean", label="avg_pool2d_3x3_ceil"),
    Op("avg_pool2d", [normal], dict(kernel_size=2, exclusive=False),
       ns=N, family=R, acc="mean", label="avg_pool2d_2x2"),
    # the adaptive pool means one axis at a time in the input's dtype: a
    # bf16 output is a mean of W means of H, each rounded, and one
    # rounding that falls the other way moves it by an O(1) value's ulp
    # over W; its error grows as a sum's over the H * W inputs, not
    # shrinks as a mean's
    Op("adaptive_avg_pool2d", [normal], dict(output_size=1), ns=N,
       family=R, acc="sum", label="adaptive_avg_pool2d_1"),
    Op("adaptive_max_pool2d", [normal], dict(output_size=3), ns=N,
       family=R, label="adaptive_max_pool2d_3"),
]

# sampled losses over [N * H, C] features and H * W classes
SAMPLED = [
    StageOp("hsigmoid_loss", [rows_of, class_labels, node_weight,
                              node_bias], ns=N, family=R, acc="sum"),
    Op("nce", [rows_of, class_labels, class_weight, class_bias],
       dict(num_neg_samples=5, seed=7), ns=N, family=R, acc="sum"),
]
