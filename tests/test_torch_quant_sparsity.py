"""paddle_tpu_torch's quantization (QAT, PTQ, int8 execution), 2:4
sparsity and distributions against the JAX package's.

- **Int8 execution.** On the same int8 operands the port's s32
  accumulators equal the JAX package's (``lax.dot_general`` and
  ``lax.conv_general_dilated`` with ``preferred_element_type=int32``)
  bit for bit, NHWC, grouped, strided, dilated, string and asymmetric
  padding included; the int8 payloads and scales are bit-equal, the
  dequantized outputs too (the same f32 operations in the same order).
  The card's padded ``torch._int_mm`` is held against an int64 product
  on the CPU wherever PyTorch has it there.
- **Fake quantization.** Every function of the table against JAX within
  rtol 1e-5, atol 1e-6: the reconstructed values are at most an ulp
  apart (XLA's fusion of ``x + (q - x)``), where a level moved by a
  rounding would be ``scale / 127`` apart; the straight-through gradient
  is the identity in both.
- **The whole slice.** A small ResNet (a stem, a residual block with
  BatchNorm, a strided 1x1 convolution, a linear head) goes QAT (3 SGD
  steps), PTQ (2 calibration batches) and `convert_to_int8` in both
  packages from one state dict: QAT losses within rtol 1e-5, scales
  within rtol 1e-5 (QAT) and 1e-6 (PTQ), the int8 weights bit-equal,
  the int8 logits within 1e-5 of the logits' largest magnitude.  QAT
  runs with the BatchNorm statistics frozen (the layers in eval mode,
  as QAT fine-tuning often does): under the suite's
  ``--xla_backend_optimization_level=0`` the JAX package's train-mode
  BatchNorm backward lands up to 1e-2 of the largest gradient off the
  port's here, and at optimization level 2 the two agree to 1e-7
  (ROADMAP.md Queue 3 records the same flag's convolution gradients).
- **Sparsity.** `create_mask` equals JAX's on inputs with ties and
  zeros; after `prune_model` and `decorate(SGD)` steps the masks hold
  and the parameters match JAX's within rtol 1e-6.
- **Distributions.** ``log_prob``, ``probs``, ``entropy`` and
  ``kl_divergence`` (and their gradients) within rtol 1e-6, atol 1e-6;
  draws come from each package's own generator and are held in
  distribution: sample means and variances of 200000 draws within 5
  standard errors, Categorical counts by a chi-square test.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.distribution  # noqa: F401
import paddle_tpu.quantization as JQ
import paddle_tpu.sparsity as JS
import paddle_tpu_torch as T
import paddle_tpu_torch.quantization as TQ
import paddle_tpu_torch.quantization.int8 as TQ8
import paddle_tpu_torch.sparsity as TS
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_tensor_api import (_public, _tensors, assert_close, jax_ref,
                                   port_grads, rng)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def f32(a):
    return np.asarray(a, np.float32)


def nrm(r, *shape):
    return f32(r.standard_normal(shape))


def jnp_(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# ---------------------------------------------------------------------------
# int8 execution
# ---------------------------------------------------------------------------
def half_levels(r, scale, shape):
    """Values at exact round-half points of the int8 grid (``(k + 0.5)
    * scale / 127``) and ordinary ones, and the scale itself: the cases
    a reciprocal-multiply division or another rounding would move."""
    k = r.integers(-126, 126, shape)
    v = (k + 0.5) * scale / 127.0
    v = np.where(r.uniform(size=shape) < 0.5, v,
                 r.uniform(-scale, scale, shape))
    v.flat[0] = scale
    return f32(v)


def test_quantize_act_and_weight_bit_equal():
    r = rng()
    x = half_levels(r, 3.0, (64, 32))
    s = f32(3.0)
    want = np.asarray(JQ.quantize_act(P.to_tensor(x), s))
    got = TQ.quantize_act(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)
    w = nrm(r, 32, 16)
    jq, js = JQ.quantize_weight(P.to_tensor(w), 1)
    tq, ts = TQ.quantize_weight(torch.from_numpy(w), 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(5, 13, 7), (17, 16, 8), (40, 1, 3),
                                   (3, 130, 9), (8, 120, 84)])
def test_padded_int_mm_is_exact(shape):
    """The card's product: ``torch._int_mm`` after zero padding (M > 16,
    every dim a multiple of 16) equals the int64 product; (8, 120, 84) is
    LeNet's fc2, which cuBLASLt refused at multiples of 8."""
    if not hasattr(torch, "_int_mm"):
        pytest.skip("torch._int_mm is not in this PyTorch")
    m, k, n = shape
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    try:
        got = TQ8.padded_int_mm(a, b)
    except RuntimeError as e:  # a CPU build without the int8 product
        pytest.skip(f"torch._int_mm on the CPU: {e}")
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.long(), a.long() @ b.long())


def _jax_linear_acc(layer, x):
    import jax
    import jax.numpy as jnp

    qx = JQ.quantize_act(P.to_tensor(x), layer.act_scale._array)
    return np.asarray(jax.lax.dot_general(
        qx, layer.qweight._array,
        dimension_numbers=(((qx.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


def _jax_conv_acc(layer, x):
    """The JAX package's own accumulator call (`Int8Conv2D.forward`)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.functional.conv import _pair, _padding

    qx = JQ.quantize_act(P.to_tensor(x), layer.act_scale._array)
    nhwc = layer._data_format not in ("NCHW", "NCL", "NCDHW")
    dn = ("NHWC", "OIHW", "NHWC") if nhwc else ("NCHW", "OIHW", "NCHW")
    return np.asarray(jax.lax.conv_general_dilated(
        qx, layer.qweight._array, window_strides=tuple(_pair(
            layer._stride, 2)), padding=_padding(layer._padding, 2),
        rhs_dilation=tuple(_pair(layer._dilation, 2)),
        feature_group_count=max(layer._groups, 1), dimension_numbers=dn,
        preferred_element_type=jnp.int32))


def test_int8_linear_accumulator_bit_equal():
    r = rng()
    w, b, x = nrm(r, 24, 12), nrm(r, 12), half_levels(r, 2.5, (3, 5, 24))
    jl = JQ.Int8Linear(P.to_tensor(w), P.to_tensor(b), f32(2.5))
    tl = TQ.Int8Linear(torch.from_numpy(w), torch.from_numpy(b),
                       torch.tensor(2.5))
    np.testing.assert_array_equal(tl.qweight.numpy(), jnp_(jl.qweight))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tl.accumulate(xt).numpy(),
                                  _jax_linear_acc(jl, x))
    np.testing.assert_array_equal(tl(xt).numpy(),
                                  jnp_(jl(P.to_tensor(x))))


CONVS = {  # (in, out, kernel, stride, padding, dilation, groups, format)
    "nchw": (4, 6, 3, 1, 1, 1, 1, "NCHW"),
    "nhwc": (4, 6, 3, 1, 1, 1, 1, "NHWC"),
    "grouped": (4, 6, 3, 1, 1, 1, 2, "NCHW"),
    "depthwise_nhwc": (4, 4, 3, 2, 1, 1, 4, "NHWC"),
    "stride2_dilation2": (3, 5, 3, 2, 2, 2, 1, "NCHW"),
    "same": (3, 5, 3, 2, "SAME", 1, 1, "NCHW"),
    "valid": (3, 5, 2, 1, "VALID", 1, 1, "NHWC"),
    "asymmetric": (3, 5, 3, 1, [0, 1, 0, 1], 1, 1, "NCHW"),
    "pairs": (3, 5, (3, 1), (1, 2), [(1, 0), (0, 2)], 1, 1, "NCHW"),
    "stem_7x7": (3, 8, 7, 2, 3, 1, 1, "NCHW"),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_accumulator_bit_equal(name):
    cin, cout, k, s, pad, dil, g, fmt = CONVS[name]
    r = rng()
    ks = k if isinstance(k, tuple) else (k, k)
    w, b = nrm(r, cout, cin // g, *ks), nrm(r, cout)
    shape = (2, cin, 9, 11) if fmt == "NCHW" else (2, 9, 11, cin)
    x = half_levels(r, 1.5, shape)
    args = (s, pad, dil, g, fmt)
    jl = JQ.Int8Conv2D(P.to_tensor(w), P.to_tensor(b), f32(1.5), *args)
    tl = TQ.Int8Conv2D(torch.from_numpy(w), torch.from_numpy(b),
                       torch.tensor(1.5), *args)
    np.testing.assert_array_equal(tl.qweight.numpy(), jnp_(jl.qweight))
    np.testing.assert_array_equal(tl.w_scale.numpy(), jnp_(jl.w_scale))
    xt = torch.from_numpy(x)
    TQ8.reset_counts()
    acc = tl.accumulate(xt)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), _jax_conv_acc(jl, x))
    np.testing.assert_array_equal(tl(xt).numpy(),
                                  jnp_(jl(P.to_tensor(x))))
    assert TQ8.counts() == {"linear": 0, "conv": 2, "cuda": 0}


def test_convert_raises_uncalibrated_and_export_waits_for_item_4():
    m = T.nn.Sequential(T.nn.Linear(4, 2))
    m.eval()
    TQ.ImperativePTQ().quantize(m)
    with pytest.raises(ValueError, match="calibrated"):
        TQ.convert_to_int8(m)
    # export is jit.save now: without an input_spec it raises, as the
    # JAX package's does (tests/test_torch_inference.py exports one)
    with pytest.raises(ValueError, match="input_spec"):
        TQ.ImperativeQuantAware().save_quantized_model(m, "x")


# ---------------------------------------------------------------------------
# fake quantization
# ---------------------------------------------------------------------------
class Q:
    def __init__(self, label, make, call, grad=False):
        self.label, self.make, self.call, self.grad = label, make, call, grad
        self.name = label.split("[")[0]

    def __repr__(self):
        return self.label


def q(pkg):
    return pkg.quantization


FAKE = [
    Q("fake_quantize_abs_max", lambda r: [half_levels(r, 2.0, (4, 6))],
      lambda p, x: q(p).fake_quantize_abs_max(x), grad=True),
    Q("fake_quantize_abs_max[4bit]", lambda r: [nrm(r, 4, 6)],
      lambda p, x: q(p).fake_quantize_abs_max(x, bit_length=4), grad=True),
    *[Q(f"fake_quantize_channel_wise_abs_max[axis{a}]",
        lambda r: [nrm(r, 5, 4, 3)],
        lambda p, x, a=a: q(p).fake_quantize_channel_wise_abs_max(
            x, quant_axis=a), grad=True) for a in (0, 1)],
    *[Q(f"fake_quantize_moving_average_abs_max[{lab}]",
        lambda r, s=s: [nrm(r, 4, 6), f32(s)],
        lambda p, x, st, kw=kw: q(p).fake_quantize_moving_average_abs_max(
            x, st, **kw), grad=True)
      for lab, s, kw in (("ema", 1.3, {}), ("first", 0.0, {}),
                         ("frozen", 0.7, {"update": False}),
                         ("frozen_unset", 0.0, {"update": False}),
                         ("running_max", 1.1, {"rate": None}),
                         ("4bit", 2.0, {"bit_length": 4, "rate": 0.5}))],
    Q("dequantize_abs_max", lambda r: [np.asarray(
        r.integers(-127, 128, (3, 4)), np.int8), f32(2.5)],
      lambda p, x, s: q(p).dequantize_abs_max(x, s, 127.0)),
    Q("dequantize_log", lambda r: [np.asarray(r.integers(0, 256, (3, 5)),
                                              np.uint8),
                                   f32(np.sort(r.uniform(0, 4, 128)))],
      lambda p, x, t: q(p).dequantize_log(x, t)),
    Q("moving_average_abs_max_scale", lambda r: [nrm(r, 4, 3)],
      lambda p, x: q(p).moving_average_abs_max_scale(x)),
    Q("moving_average_abs_max_scale[state]",
      lambda r: [nrm(r, 4, 3), f32(2.0), f32(3.5)],
      lambda p, x, st, ac: q(p).moving_average_abs_max_scale(
          x, st, ac, moving_rate=0.8)),
]


@pytest.mark.parametrize("case", FAKE, ids=repr)
def test_fake_quant_matches_jax(case):
    arrays = case.make(rng())
    want, _ = jax_ref(case, case.call, arrays, False)
    got = tab.flat(case.call(T, *_tensors(T, arrays)))
    assert_close(got, want, "ew", case.label)


@pytest.mark.parametrize("case", [c for c in FAKE if c.grad], ids=repr)
def test_fake_quant_gradient_is_straight_through(case):
    arrays = case.make(rng())
    _, jgrads = jax_ref(case, case.call, arrays, True)
    tgrads = port_grads(case.call, arrays)
    assert_close(tgrads[0], jgrads[0], "ew", case.label)


# ---------------------------------------------------------------------------
# the whole slice: QAT -> PTQ -> convert_to_int8 in both packages
# ---------------------------------------------------------------------------
def small_resnet(pkg):
    nn, F = pkg.nn, pkg.nn.functional

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(8, 8, 3, padding=1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(8)
            self.conv2 = nn.Conv2D(8, 8, 3, padding=1, bias_attr=False)
            self.bn2 = nn.BatchNorm2D(8)

        def forward(self, x):
            y = F.relu(self.bn1(self.conv1(x)))
            return F.relu(self.bn2(self.conv2(y)) + x)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2D(3, 8, 3, stride=2, padding=1)
            self.bn = nn.BatchNorm2D(8)
            self.block = Block()
            self.down = nn.Conv2D(8, 16, 1, stride=2)
            self.fc = nn.Linear(16, 10)

        def forward(self, x):
            y = self.block(F.relu(self.bn(self.stem(x))))
            y = F.relu(self.down(y))
            return self.fc(pkg.mean(y, axis=[2, 3]))

    return Net()


def _pair_of_nets(seed=0):
    P.seed(seed)
    jm = small_resnet(P)
    tm = small_resnet(T)
    missing, unexpected = tm.set_state_dict(
        {k: jnp_(v) for k, v in jm.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    return jm, tm


def _batches(n, seed=3):
    r = np.random.RandomState(seed)
    return [(r.rand(4, 3, 16, 16).astype(np.float32) * 2 - 0.5,
             r.randint(0, 10, (4,)).astype(np.int64)) for _ in range(n)]


def _scales(model, pkg):
    quant = pkg.quantization
    return {n: float(np.asarray(jnp_(s._act_scale)))
            for n, s in model.named_sublayers()
            if isinstance(s, (quant.QuantizedLinear, quant.QuantizedConv2D))}


def test_small_resnet_qat_ptq_int8_matches_jax():
    jm, tm = _pair_of_nets()
    # QAT: three SGD steps in train mode
    JQ.ImperativeQuantAware().quantize(jm)
    TQ.ImperativeQuantAware().quantize(tm)
    assert sorted(jm.state_dict()) == sorted(tm.state_dict())
    jopt = P.optimizer.SGD(0.05, parameters=jm.parameters())
    topt = T.optimizer.SGD(0.05, parameters=tm.parameters())
    for m, bn in ((jm, P.nn.BatchNorm2D), (tm, T.nn.BatchNorm2D)):
        m.train()
        for sub in m.sublayers():
            if isinstance(sub, bn):
                sub.eval()
    for x, y in _batches(3):
        jl = P.nn.functional.cross_entropy(jm(P.to_tensor(x)),
                                           P.to_tensor(y))
        tl = T.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                           torch.from_numpy(y))
        np.testing.assert_allclose(tl.item(), float(jnp_(jl)), rtol=1e-5)
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl.backward()
        topt.step()
        topt.clear_grad()
    js, ts = _scales(jm, P), _scales(tm, T)
    assert js.keys() == ts.keys() and len(ts) == 5
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)

    # PTQ on a fresh pair, then int8 execution
    jm, tm = _pair_of_nets(seed=1)
    calib = _batches(2, seed=5)
    JQ.ImperativePTQ().quantize(jm, lambda m: [m(P.to_tensor(x))
                                               for x, _ in calib])
    TQ.ImperativePTQ().quantize(tm, lambda m: [m(torch.from_numpy(x))
                                               for x, _ in calib])
    js, ts = _scales(jm, P), _scales(tm, T)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, err_msg=k)
    x = _batches(1, seed=9)[0][0]
    fq = tm(torch.from_numpy(x))
    JQ.convert_to_int8(jm)
    TQ.convert_to_int8(tm)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for k in jsd:
        if k.endswith("qweight"):
            np.testing.assert_array_equal(tsd[k].numpy(), jnp_(jsd[k]), k)
    TQ8.reset_counts()
    want = jnp_(jm(P.to_tensor(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert TQ8.counts() == {"linear": 1, "conv": 4, "cuda": 0}
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the integer model keeps the fake-quant model's top-1
    assert (got.argmax(1) == fq.detach().numpy().argmax(1)).mean() >= 0.75


# ---------------------------------------------------------------------------
# sparsity
# ---------------------------------------------------------------------------
def tied_weights(r, shape):
    """Magnitudes quantized to 0.5 with zeros: many ties inside a group
    of four, which numpy's argsort order decides."""
    return f32(np.round(r.uniform(-1.5, 1.5, shape) * 2) / 2)


@pytest.mark.parametrize("shape,n,m", [((8, 12), 2, 4), ((6, 5, 3), 2, 4),
                                       ((7, 9), 1, 4), ((4, 16), 4, 8)])
def test_create_mask_equals_jax_with_ties(shape, n, m):
    w = tied_weights(rng(), shape)
    want = JS.create_mask(P.to_tensor(w), n=n, m=m)
    got = TS.create_mask(torch.from_numpy(w), n=n, m=m)
    np.testing.assert_array_equal(got, want)
    for x in (w, w * want):
        for pkg_fn in (JS.check_mask, TS.check_mask):
            assert pkg_fn(x, n, m) == JS.check_mask(x, n, m)
        assert TS.check_mask(torch.from_numpy(x), n, m) == \
            JS.check_mask(x, n, m)
        assert TS.calculate_density(torch.from_numpy(x)) == \
            pytest.approx(JS.calculate_density(x), abs=1e-12)


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def test_prune_and_decorate_match_jax():
    P.seed(4)
    jm = _mlp(P)
    tm = _mlp(T)
    tm.set_state_dict({k: jnp_(v) for k, v in jm.state_dict().items()})
    JS.set_excluded_layers(["2.weight"], jm)
    TS.set_excluded_layers(["2.weight"], tm)
    jmask = JS.prune_model(jm)
    tmask = TS.prune_model(tm)
    JS.reset_excluded_layers(jm)
    TS.reset_excluded_layers(tm)
    assert sorted(jmask) == sorted(tmask) == ["0.weight"]
    np.testing.assert_array_equal(tmask["0.weight"], jmask["0.weight"])
    jopt = JS.decorate(P.optimizer.SGD(0.1, parameters=jm.parameters()),
                       jm)
    topt = TS.decorate(T.optimizer.SGD(0.1, parameters=tm.parameters()),
                       tm)
    r = np.random.RandomState(0)
    for _ in range(3):
        x = r.rand(5, 8).astype(np.float32)
        jl = (jm(P.to_tensor(x)) ** 2).mean()
        tl = (tm(torch.from_numpy(x)) ** 2).mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl.backward()
        topt.step()
        topt.clear_grad()
        w = tm[0].weight.detach()
        assert TS.check_mask(w) and torch.equal(
            w == 0, torch.from_numpy(tmask["0.weight"] == 0) | (w == 0))
        assert ((w != 0).numpy() <= tmask["0.weight"].astype(bool)).all()
    for (k, jv), tv in zip(jm.state_dict().items(),
                           tm.state_dict().values()):
        np.testing.assert_allclose(tv.numpy(), jnp_(jv), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert TS.ASPHelper._masks[tm]["0.weight"].device == \
        tm[0].weight.device
    with pytest.raises(ValueError):
        TS.decorate(topt)


def test_masks_and_exclusions_leave_with_the_model():
    import gc
    import weakref

    T.seed(5)
    m = _mlp(T)
    TS.set_excluded_layers(["2.weight"], m)
    TS.prune_model(m)
    gone = weakref.ref(TS.ASPHelper._masks[m]["0.weight"])
    assert sorted(TS.ASPHelper._masks[m]) == ["0.weight"]
    del m
    gc.collect()
    assert gone() is None
    # a later model (at any address) inherits neither masks nor exclusions
    fresh = _mlp(T)
    assert fresh not in TS.ASPHelper._masks
    dense = {k: v.detach().clone() for k, v in fresh.state_dict().items()}
    opt = TS.decorate(T.optimizer.SGD(0.0, parameters=fresh.parameters()),
                      fresh)
    (fresh(torch.rand(3, 8)) ** 2).mean().backward()
    opt.step()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, dense[k]), k
    assert sorted(TS.prune_model(fresh)) == ["0.weight", "2.weight"]


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------
def _dists(pkg, a):
    D = pkg.distribution
    t = (lambda v: P.to_tensor(v)) if pkg is P else torch.from_numpy
    return dict(
        normal=(D.Normal(t(a["loc"]), t(a["scale"])),
                D.Normal(t(a["loc2"]), t(a["scale2"]))),
        uniform=(D.Uniform(t(a["low"]), t(a["high"])), None),
        categorical=(D.Categorical(t(a["logits"])),
                     D.Categorical(t(a["logits2"]))))


def _dist_arrays():
    r = rng()
    return dict(loc=nrm(r, 3), scale=f32(r.uniform(0.5, 2, 3)),
                loc2=nrm(r, 3), scale2=f32(r.uniform(0.5, 2, 3)),
                low=f32([-1.0, 0.0, 2.0]), high=f32([0.5, 3.0, 2.5]),
                logits=nrm(r, 2, 5), logits2=nrm(r, 2, 5),
                value=f32([-0.5, 1.0, 2.2]),
                ids=np.asarray([4, 1], np.int64))


@pytest.mark.parametrize("kind", ["normal", "uniform", "categorical"])
def test_distribution_densities_match_jax(kind):
    a = _dist_arrays()
    (jd, jo), (td, to) = _dists(P, a)[kind], _dists(T, a)[kind]
    val = a["ids"] if kind == "categorical" else a["value"]
    pairs = [(jd.log_prob(P.to_tensor(val)),
              td.log_prob(torch.from_numpy(val))),
             (jd.probs(P.to_tensor(val)), td.probs(torch.from_numpy(val))),
             (jd.entropy(), td.entropy())]
    if jo is not None:
        pairs.append((jd.kl_divergence(jo), td.kl_divergence(to)))
    for i, (w, g) in enumerate(pairs):
        np.testing.assert_allclose(g.detach().numpy(), jnp_(w), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{kind}[{i}]")


def test_distribution_gradients_match_jax():
    a = _dist_arrays()
    jl, js = P.to_tensor(a["loc"], stop_gradient=False), \
        P.to_tensor(a["scale"], stop_gradient=False)
    tl, ts = (torch.from_numpy(a["loc"]).requires_grad_(),
              torch.from_numpy(a["scale"]).requires_grad_())
    jn, tn = P.distribution.Normal(jl, js), T.distribution.Normal(tl, ts)
    jo = P.distribution.Normal(P.to_tensor(a["loc2"]),
                               P.to_tensor(a["scale2"]))
    to = T.distribution.Normal(torch.from_numpy(a["loc2"]),
                               torch.from_numpy(a["scale2"]))
    jy = (jn.log_prob(P.to_tensor(a["value"])).sum() + jn.entropy().sum()
          + jn.kl_divergence(jo).sum())
    ty = (tn.log_prob(torch.from_numpy(a["value"])).sum()
          + tn.entropy().sum() + tn.kl_divergence(to).sum())
    jg = P.grad([jy], [jl, js])
    tg = torch.autograd.grad([ty], [tl, ts])
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), jnp_(w), rtol=1e-6, atol=1e-6)


DRAWS = 200_000


def test_distribution_draws_in_distribution():
    a = _dist_arrays()
    gen = torch.Generator().manual_seed(0)
    dn, _ = _dists(T, a)["normal"]
    x = dn.sample((DRAWS,), generator=gen)
    assert x.shape == (DRAWS, 3)
    se_mean = a["scale"] / np.sqrt(DRAWS)
    assert (np.abs(x.mean(0).numpy() - a["loc"]) < 5 * se_mean).all()
    var = a["scale"] ** 2
    assert (np.abs(x.var(0).numpy() - var)
            < 5 * var * np.sqrt(2.0 / DRAWS)).all()
    rs = T.distribution.Normal(torch.from_numpy(a["loc"]).requires_grad_(),
                               torch.from_numpy(a["scale"]))
    assert rs.rsample((4,)).requires_grad
    du, _ = _dists(T, a)["uniform"]
    u = du.sample((DRAWS,), generator=gen).numpy()
    lo, hi = a["low"], a["high"]
    assert ((u >= lo) & (u < hi) | (lo == hi)).all()
    se = (hi - lo) / np.sqrt(12 * DRAWS)
    assert (np.abs(u.mean(0) - (lo + hi) / 2) < 5 * se).all()
    dc, _ = _dists(T, a)["categorical"]
    ids = dc.sample((DRAWS,), generator=gen).numpy()
    assert ids.shape == (DRAWS, 2) and ids.dtype == np.int64
    probs = np.exp(a["logits"]) / np.exp(a["logits"]).sum(-1, keepdims=True)
    for row in range(2):
        counts = np.bincount(ids[:, row], minlength=5)
        exp = probs[row] * DRAWS
        chi2 = ((counts - exp) ** 2 / exp).sum()
        assert chi2 < 18.5, (row, chi2)    # p = 0.001 at 4 dof
    # the JAX package's draws have the same shapes and dtypes
    jd = _dists(P, a)
    assert tuple(jd["normal"][0].sample((7,)).shape) == (7, 3)
    assert tuple(jd["categorical"][0].sample((7,)).shape) == (7, 2)


def test_every_public_name_has_a_counterpart():
    """Each public name of the JAX modules of quantization, sparsity and
    distribution is in the port's module of the same name (the only
    refusal: `save_quantized_model`, which waits for item 4)."""
    import paddle_tpu.quantization.int8 as JQ8

    for jmod, tmod in ((JQ, TQ), (JQ8, TQ8), (JS, TS),
                       (P.distribution, T.distribution)):
        want = _public(jmod) | set(getattr(jmod, "__all__", ()))
        want -= {"Tensor", "unwrap", "dispatch", "Layer"}
        assert want <= set(dir(tmod)), sorted(want - set(dir(tmod)))
    for cls in ("Normal", "Uniform", "Categorical"):
        for meth in ("sample", "entropy", "log_prob", "probs"):
            assert hasattr(getattr(T.distribution, cls), meth)
    assert hasattr(T.distribution.Normal, "rsample")
    for nm in ("metric", "distribution", "quantization", "sparsity",
               "text"):
        assert hasattr(T, nm) and hasattr(P, nm), nm
