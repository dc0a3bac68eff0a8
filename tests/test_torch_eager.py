"""paddle_tpu_torch's eager core against the JAX package's.

Tensors (`to_tensor`'s dtype rules, places), autograd (``grad`` with
double grad, ``backward`` with ``retain_graph``, unused inputs,
``PyLayer``), ``FLAGS_check_nan_inf``, the flags this slice registers,
the initializers (on the distribution: mean, std, bounds, and exactly
for Constant, Assign, Dirac and Bilinear), ``GPT(cfg)``'s init, dropout
(keep rate and scale on the distribution, same-seed determinism), the
DataLoader's order under ``np.random.seed`` and ``save``/``load`` across
the two packages, bit for bit.  Inputs come from numpy seeds and go
through both packages; tolerances are stated per test.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import autograd as JAG
from paddle_tpu import io as JIO
from paddle_tpu.core import flags as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.functional import common as JFC

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import autograd as TAG
from paddle_tpu_torch import io as TIO
from paddle_tpu_torch.core import dispatch as TD
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.core import framework as TFW
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.nn import initializer as TI

GRAD_TOL = 1e-6


# ---------------------------------------------------------------------------
# tensors and places
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [
    np.zeros(3), [1.5, 2.0], 2.5, np.zeros(2, np.float16), [True, False],
    np.ones((2, 2), np.float32)],
    ids=["f64_numpy", "float_list", "float", "f16", "bool", "f32"])
def test_to_tensor_dtype_rules_match_jax(data):
    """float64 data without a dtype takes the default dtype (float32);
    every other float and bool dtype is kept; an explicit dtype wins.
    ``stop_gradient=False`` is a leaf that requires grad."""
    want = paddle.to_tensor(data)
    got = tpaddle.to_tensor(data, place="cpu")
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not got.requires_grad
    t = tpaddle.to_tensor(data, dtype="float32", place=tpaddle.CPUPlace(),
                          stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad and t.is_leaf


def test_to_tensor_integers_and_places(monkeypatch):
    """Integers keep 64 bits (the JAX package, run without x64, narrows
    them to int32); a tensor is copied; places map to torch devices, the
    TPU and XPU places raise; no place means the card."""
    assert tpaddle.to_tensor([1, 2], place="cpu").dtype == torch.int64
    assert paddle.to_tensor([1, 2]).dtype == np.int32
    src = torch.ones(2)
    t = tpaddle.to_tensor(src, place="cpu")
    t += 1
    assert float(src.sum()) == 2.0
    assert tpaddle.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    for cls in (tpaddle.TPUPlace, tpaddle.XPUPlace):
        with pytest.raises(ValueError, match="no .* backend"):
            cls(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaddle.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaddle.to_tensor([1.0], place="gpu:0")
    assert tpaddle.is_tensor(t) and not tpaddle.is_tensor(np.ones(1))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _pair(a):
    return (paddle.to_tensor(a, stop_gradient=False),
            tpaddle.to_tensor(a, place="cpu", stop_gradient=False))


def test_grad_and_double_grad_match_jax():
    """d/dx and d/dy of sum(x^3 * y), then d/dx of sum(dx) through
    ``create_graph=True``; ``.grad`` stays untouched; an unused input
    gets zeros (None with ``allow_unused``)."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(a), _pair(b)
    jz, tz = _pair(a)
    jo, to = (jx ** 3 * jy).sum(), (tx ** 3 * ty).sum()
    jg = paddle.grad(jo, [jx, jy, jz], create_graph=True)
    tg = tpaddle.grad(to, [tx, ty, tz], create_graph=True)
    for j, t in zip(jg, tg):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(),
                                   atol=GRAD_TOL)
    assert float(tg[2].abs().sum()) == 0.0
    assert tx.grad is None and ty.grad is None
    jgg = paddle.grad(jg[0].sum(), [jx])[0]
    tgg = tpaddle.grad(tg[0].sum(), [tx])[0]
    np.testing.assert_allclose(tgg.numpy(), jgg.numpy(), atol=GRAD_TOL)
    np.testing.assert_allclose(tgg.numpy(), 6 * a * b, atol=1e-5)
    assert tpaddle.grad((tx * 2).sum(), [tz], allow_unused=True) == [None]


def test_backward_retain_graph_accumulates_as_jax():
    """Two ``backward`` calls on one graph (the first retaining it): the
    leaves' ``.grad`` accumulate to twice the gradient, in both
    packages; ``grad_tensors`` weighs the output."""
    rng = np.random.RandomState(1)
    a = rng.randn(4).astype(np.float32)
    w = rng.randn(4).astype(np.float32)
    jx, tx = _pair(a)
    jo, to = paddle.exp(jx) * 3, torch.exp(tx) * 3
    JAG.backward([jo], [paddle.to_tensor(w)], retain_graph=True)
    TAG.backward([to], [torch.from_numpy(w)], retain_graph=True)
    JAG.backward([jo], [paddle.to_tensor(w)])
    TAG.backward([to], [torch.from_numpy(w)])
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), 6 * np.exp(a) * w,
                               rtol=1e-5)
    with pytest.raises(RuntimeError):
        TAG.backward([to])  # the graph was freed
    s = (tx * tx).sum()
    s.backward()  # a scalar's own backward, torch's, is Paddle's
    assert tx.grad is not None


def _pylayers():
    class JCube(JAG.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            return x ** 3 * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3 * x * x * 0.5  # a deliberately halved gradient

    class TCube(TAG.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            return x ** 3 * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3 * x * x * 0.5

    return JCube, TCube


def test_pylayer_matches_jax():
    """A custom op with a non-tensor argument: forward values and the
    gradient its ``backward`` returns (not autograd's), in both."""
    JCube, TCube = _pylayers()
    a = np.random.RandomState(2).randn(6).astype(np.float32)
    jx, tx = _pair(a)
    jy, ty = JCube.apply(jx, 2.0), TCube.apply(tx, 2.0)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=1e-6)
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), 1.5 * a * a, rtol=1e-6)
    with tpaddle.no_grad():
        assert not TCube.apply(tx, 2.0).requires_grad
        assert not tpaddle.is_grad_enabled()
    assert tpaddle.is_grad_enabled()


# ---------------------------------------------------------------------------
# FLAGS_check_nan_inf and the flags of this slice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["log_negative", "div_zero", "finite"])
def test_check_nan_inf_raises_where_jax_raises(op):
    """With the flag on, an op whose output holds NaN or Inf raises
    FloatingPointError in both packages, a finite one does not; with it
    off nothing raises and the port installs no mode."""
    a = np.array([-1.0, 2.0], np.float32)
    fns = {"log_negative": (lambda x: paddle.log(x), torch.log),
           "div_zero": (lambda x: x / 0.0, lambda x: x / 0.0),
           "finite": (lambda x: x * 2.0, lambda x: x * 2.0)}
    jfn, tfn = fns[op]
    jx, tx = paddle.to_tensor(a), torch.from_numpy(a)
    assert TD.active_mode() is None
    paddle.set_flags({"check_nan_inf": True})
    TF.set_flags({"check_nan_inf": True})
    try:
        assert TD.active_mode() is not None
        if op == "finite":
            jfn(jx), tfn(tx)
        else:
            with pytest.raises(FloatingPointError):
                jfn(jx)
            with pytest.raises(FloatingPointError, match="NaN or Inf"):
                tfn(tx)
    finally:
        paddle.set_flags({"check_nan_inf": False})
        TF.set_flags({"check_nan_inf": False})
    assert TD.active_mode() is None
    assert tfn(tx).shape == (2,)


def test_check_nan_inf_mode_is_suspended():
    """`dispatch.suspended` (what a CUDA-graph capture runs under) takes
    the mode off the stack and puts it back."""
    TF.set_flags({"check_nan_inf": True})
    try:
        with TD.suspended():
            assert TD.active_mode() is None
            torch.log(torch.tensor([-1.0]))  # no check inside
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([-1.0]))
    finally:
        TF.set_flags({"check_nan_inf": False})


NEW_FLAGS = ["check_nan_inf", "benchmark", "deterministic", "amp_dtype",
             "log_level", "eager_jit_ops", "eager_cache_size",
             "eager_dispatch_report", "use_rbg_rng"]


@pytest.mark.parametrize("name", NEW_FLAGS)
def test_new_flags_registered_with_jax_defaults(name):
    """Each flag under JAX's name and default.  The working ones take a
    value (and do what it says); ``eager_jit_ops``, ``eager_cache_size``
    and ``use_rbg_rng`` refuse any other value with ValueError naming the
    reason; ``eager_dispatch_report`` installs the mode and counts ops."""
    assert TF.flag(name) == JF.flag(name)
    other = {"check_nan_inf": True, "benchmark": True,
             "deterministic": True, "amp_dtype": "float16", "log_level": 2,
             "eager_jit_ops": False, "eager_cache_size": 16,
             "eager_dispatch_report": True, "use_rbg_rng": False}[name]
    if name in ("eager_jit_ops", "eager_cache_size", "use_rbg_rng"):
        with pytest.raises(ValueError, match="torch"):
            TF.set_flags({name: other})
    else:
        TF.set_flags({name: other})
        try:
            if name == "benchmark":
                assert TD.active_mode() is not None
                assert float(torch.ones(2).sum()) == 2.0
            elif name == "eager_dispatch_report":
                assert TD.active_mode() is not None
                TD.reset_dispatch_stats()
                torch.ones(2).sum()
                assert TD.dispatch_stats()["sum"]["calls"] == 1
            elif name == "deterministic":
                assert torch.are_deterministic_algorithms_enabled()
            elif name == "amp_dtype":
                with tpaddle.amp.auto_cast():
                    x = TFn.linear(torch.ones(2, 3), torch.ones(3, 4))
                assert x.dtype == torch.float16
            elif name == "log_level":
                assert logging.getLogger("paddle_tpu_torch").level == \
                    logging.DEBUG
        finally:
            TF.set_flags({name: JF.flag(name)})
    assert TF.flag(name) == JF.flag(name)
    assert TD.active_mode() is None
    assert not torch.are_deterministic_algorithms_enabled()


# ---------------------------------------------------------------------------
# initializers, GPT(cfg), dropout
# ---------------------------------------------------------------------------
SHAPE = (200, 300)  # fan_in 200, fan_out 300


def _theory(name):
    """(mean, std, low, high) each initializer draws at `SHAPE`."""
    xu = np.sqrt(6.0 / 500)
    ku = np.sqrt(2.0) * np.sqrt(3.0 / 200)
    return {
        "Uniform": (0.0, 0.5 / np.sqrt(3), -0.5, 0.5),
        "Normal": (0.3, 0.2, None, None),
        "TruncatedNormal": (0.3, 0.2 * 0.8796, 0.3 - 0.4, 0.3 + 0.4),
        "XavierUniform": (0.0, xu / np.sqrt(3), -xu, xu),
        "XavierNormal": (0.0, np.sqrt(2.0 / 500), None, None),
        "KaimingUniform": (0.0, ku / np.sqrt(3), -ku, ku),
        "KaimingNormal": (0.0, np.sqrt(2.0 / 200), None, None),
    }[name]


def _make(mod, name):
    return {"Uniform": lambda: mod.Uniform(-0.5, 0.5),
            "Normal": lambda: mod.Normal(0.3, 0.2),
            "TruncatedNormal": lambda: mod.TruncatedNormal(0.3, 0.2),
            }.get(name, lambda: getattr(mod, name)())()


@pytest.mark.parametrize("name", ["Uniform", "Normal", "TruncatedNormal",
                                  "XavierUniform", "XavierNormal",
                                  "KaimingUniform", "KaimingNormal"])
def test_random_initializers_distribution(name):
    """60,000 draws of each: mean within 0.01 of theory (and of JAX's
    draw), std within 2% of theory (and within 3% of JAX's), bounds
    held."""
    mean, std, lo, hi = _theory(name)
    tpaddle.seed(3)
    got = _make(TI, name)._init(SHAPE, torch.float32, "cpu").numpy()
    paddle.seed(3)
    want = np.asarray(_make(JI, name)._init(SHAPE, np.float32))
    for x in (got, want):
        assert abs(x.mean() - mean) < 0.01
        assert abs(x.std() - std) < 0.02 * std
    assert abs(got.std() - want.std()) < 0.03 * std
    if lo is not None:
        assert got.min() >= lo - 1e-6 and got.max() <= hi + 1e-6


def test_orthogonal_initializer():
    """Orthonormal rows of a [20, 50] draw, times the gain."""
    w = TI.Orthogonal(gain=2.0)._init((20, 50), torch.float32, "cpu")
    np.testing.assert_allclose((w @ w.T).numpy(), 4.0 * np.eye(20),
                               atol=1e-4)


@pytest.mark.parametrize("name", ["Constant", "Assign", "Dirac", "Bilinear"])
def test_deterministic_initializers_exact(name):
    """Constant, Assign (a numpy array reshaped), Dirac (groups 2) and
    Bilinear equal JAX's values exactly; ``init(param)`` fills a
    parameter in place."""
    shape = (4, 2, 3, 3)
    val = np.arange(72, dtype=np.float32) / 7
    make = {"Constant": lambda m: m.Constant(0.375),
            "Assign": lambda m: m.Assign(val),
            "Dirac": lambda m: m.Dirac(groups=2),
            "Bilinear": lambda m: m.Bilinear()}[name]
    want = np.asarray(make(JI)._init(shape, np.float32))
    got = make(TI)._init(shape, torch.float32, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    p = torch.nn.Parameter(torch.zeros(shape))
    assert make(TI)(p) is p
    np.testing.assert_array_equal(p.detach().numpy(), want)


def test_gpt_init_draws_jax_s_distribution():
    """``GPT(cfg)`` without weights, from ``seed``: the JAX package's
    init — wte N(0, 0.02) (its vocab-parallel embedding) or N(0, 1), wpe
    N(0, 1), Xavier-uniform qkv/fc1, the residual projections N(0,
    0.02 / sqrt(2L)), LayerNorms 1 and 0; one seed draws the same
    weights twice.  Stds within 5%."""
    kw = dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
              max_seq_len=256)
    for parallel, wte_std in ((True, 0.02), (False, 1.0)):
        tpaddle.seed(1)
        m = TGPT(TGPTConfig(**kw, use_parallel_layers=parallel),
                 device="cpu")
        p = m.params()
        assert abs(float(p["wte"].std()) - wte_std) < 0.05 * wte_std
    assert abs(float(p["wpe"].std()) - 1.0) < 0.05
    blk = p["blocks"][1]
    resid = 0.02 / np.sqrt(8)
    assert abs(float(blk["out_w"].std()) - resid) < 0.05 * resid
    assert abs(float(blk["fc2_w"].std()) - resid) < 0.05 * resid
    limit = np.sqrt(6.0 / (64 + 192))
    assert float(blk["qkv_w"].abs().max()) <= limit
    assert abs(float(blk["qkv_w"].std()) - limit / np.sqrt(3)) < \
        0.05 * limit
    assert float(blk["ln1_w"].min()) == float(blk["ln1_w"].max()) == 1.0
    assert float(blk["qkv_b"].abs().max()) == 0.0
    tpaddle.seed(1)
    again = TGPT(TGPTConfig(**kw, use_parallel_layers=False), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_distribution_and_seed(mode):
    """p = 0.3 over 100,000 elements: the keep rate within 0.01 of 0.7
    in both packages, kept elements scaled exactly (1 / 0.7 upscaled, 1
    downscaled), eval mode the identity (upscale) or the scale 0.7
    (downscale); one seed draws the same mask twice, another seed
    another; an ``axis`` mask is constant along the other axes."""
    x = np.ones((100, 1000), np.float32)
    tpaddle.seed(7)
    y = TFn.dropout(torch.from_numpy(x), 0.3, mode=mode).numpy()
    jy = np.asarray(JFC.dropout(paddle.to_tensor(x), 0.3, mode=mode)._array)
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    for out in (y, jy):
        kept = out != 0
        assert abs(kept.mean() - 0.7) < 0.01
        np.testing.assert_allclose(out[kept], np.float32(scale), rtol=1e-6)
    tpaddle.seed(7)
    y2 = TFn.dropout(torch.from_numpy(x), 0.3, mode=mode).numpy()
    assert np.array_equal(y, y2)
    tpaddle.seed(8)
    assert not np.array_equal(
        y, TFn.dropout(torch.from_numpy(x), 0.3, mode=mode).numpy())
    ev = TFn.dropout(torch.from_numpy(x), 0.3, training=False, mode=mode)
    np.testing.assert_allclose(ev.numpy(), 0.7 if scale == 1.0 else 1.0,
                               rtol=1e-6)
    ax = TFn.dropout(torch.ones(6, 50, 4), 0.5, axis=1).numpy()
    assert (ax == ax[:1, :, :1]).all()


def test_dropout_layer_in_a_gpt_trains_deterministically():
    """A TINY GPT with ``dropout=0.1``: two forwards under one seed give
    equal logits, another seed other logits; eval mode has no dropout."""
    cfg = TGPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=4, max_seq_len=32, dropout=0.1)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 64, (2, 16)))
    m = TGPT.random(cfg, seed=0, device="cpu")
    outs = []
    for s in (5, 5, 6):
        tpaddle.seed(s)
        outs.append(m(ids).detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    m.eval()
    assert torch.equal(m(ids), m(ids))


def test_generator_is_per_device_and_reseeded():
    g = TFW.seed(11)
    cpu = g.for_device("cpu")
    assert g.for_device(torch.device("cpu")) is cpu
    a = torch.rand(3, generator=cpu)
    TFW.seed(11)
    assert torch.equal(torch.rand(3, generator=TFW.generator_for("cpu")), a)


# ---------------------------------------------------------------------------
# DataLoader order, save/load across packages
# ---------------------------------------------------------------------------
def test_dataloader_order_matches_jax_under_np_seed():
    """A shuffled `TensorDataset` of 23 rows in batches of 5 (the last
    short): after one ``np.random.seed`` each package draws the same
    order; `random_split` too; ``num_workers > 0`` names its slice."""
    rows = np.arange(23 * 2, dtype=np.int32).reshape(23, 2)
    labels = np.arange(23, dtype=np.int64)
    np.random.seed(4)
    want = [tuple(np.asarray(t._array) for t in b)
            for b in JIO.DataLoader(JIO.TensorDataset([rows, labels]),
                                    batch_size=5, shuffle=True)]
    np.random.seed(4)
    got = [tuple(t.numpy() for t in b)
           for b in TIO.DataLoader(TIO.TensorDataset([rows, labels]),
                                   places="cpu", batch_size=5, shuffle=True)]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    np.random.seed(5)
    js = JIO.random_split(JIO.TensorDataset([rows]), [10, 13])
    np.random.seed(5)
    ts = TIO.random_split(TIO.TensorDataset([rows]), [10, 13])
    assert [s.indices for s in ts] == [s.indices for s in js]
    # workers (threads here; processes in test_torch_elastic_data.py)
    # give the same batches in the same order
    np.random.seed(4)
    threaded = [tuple(t.numpy() for t in b)
                for b in TIO.DataLoader(TIO.TensorDataset([rows, labels]),
                                        places="cpu", batch_size=5,
                                        shuffle=True, num_workers=2,
                                        multiprocess_mode="thread")]
    assert len(threaded) == len(got)
    for g, w in zip(threaded, got):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    dist = TIO.DistributedBatchSampler(TIO.TensorDataset([rows]), 4,
                                       num_replicas=2, rank=1)
    jdist = JIO.DistributedBatchSampler(JIO.TensorDataset([rows]), 4,
                                        num_replicas=2, rank=1)
    assert list(dist) == list(jdist)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "i": rng.randint(0, 9, (5,)).astype(np.int32),
            "nested": {"b": rng.randn(2).astype(np.float32)},
            "step": 7, "lr": {"last_epoch": 3, "last_lr": 0.25}}


def test_save_load_crosses_packages_bit_for_bit(tmp_path):
    """A nested object of f32, int32 and bf16 tensors and plain values
    saved by each package loads in the other with equal bits, dtypes,
    structure and stop_gradient."""
    import ml_dtypes

    tree = _tree(0)
    bf = np.random.RandomState(1).randn(4).astype(ml_dtypes.bfloat16)
    jobj = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in tree.items() if k != "nested"}
    jobj["nested"] = {"b": paddle.to_tensor(tree["nested"]["b"],
                                            stop_gradient=False)}
    jobj["bf"] = paddle.Tensor(bf)
    paddle.save(jobj, str(tmp_path / "j.pd"))
    got = tpaddle.load(str(tmp_path / "j.pd"), device="cpu")
    assert got["step"] == 7 and got["lr"] == tree["lr"]
    assert got["i"].dtype == torch.int32 and got["bf"].dtype == torch.bfloat16
    assert got["nested"]["b"].requires_grad and not got["w"].requires_grad
    assert got["bf"].view(torch.int16).numpy().tobytes() == bf.tobytes()
    tpaddle.save(got, str(tmp_path / "t.pd"))
    back = paddle.load(str(tmp_path / "t.pd"))
    for k in ("w", "i", "bf"):
        a, b = np.asarray(back[k]._array), np.asarray(jobj[k]._array)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert not back["nested"]["b"].stop_gradient
    assert tpaddle.load(str(tmp_path / "t.pd"),
                        return_numpy=True)["w"].dtype == np.float32


def test_model_and_optimizer_state_cross_packages(tmp_path):
    """A TINY GPT's ``state_dict`` saved by the port loads into the JAX
    GPT (``set_state_dict``) with equal bits, and the JAX GPT's into the
    port's; an AdamW ``state_dict`` after an eager step keeps JAX's keys
    and round-trips."""
    from paddle_tpu.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch import optimizer as TO

    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=32, use_parallel_layers=False)
    tm = TGPT.random(TGPTConfig(**kw), seed=2, device="cpu")
    tpaddle.save(tm.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.seed(0)
    jm = GPT(GPTConfig(**kw))
    missing, unexpected = jm.set_state_dict(
        paddle.load(str(tmp_path / "m.pdparams")))
    assert not missing and not unexpected
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        assert np.asarray(jsd[k]._array).tobytes() == v.numpy().tobytes()
    paddle.save(jsd, str(tmp_path / "j.pdparams"))
    other = TGPT.random(TGPTConfig(**kw), seed=9, device="cpu")
    assert other.set_state_dict(tpaddle.load(str(tmp_path / "j.pdparams"),
                                             device="cpu")) == ([], [])
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 other.parameters()))
    opt = TO.AdamW(TO.lr.StepDecay(0.1, 2), parameters=tm.parameters())
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 1 and sd["LR_Scheduler"]["last_epoch"] == 0
    assert {"param0.moment1", "param0.moment2", "param0.beta1_pow",
            "param0.beta2_pow"} <= set(sd)
    tpaddle.save(sd, str(tmp_path / "o.pdopt"))
    opt2 = TO.AdamW(TO.lr.StepDecay(0.1, 2), parameters=other.parameters())
    opt2.set_state_dict(tpaddle.load(str(tmp_path / "o.pdopt"),
                                     device="cpu"))
    sd2 = opt2.state_dict()
    assert sorted(sd2) == sorted(sd)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd
               if isinstance(sd[k], torch.Tensor))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels K3/K4 and CUDA "
                    "graphs have no CPU mode")
    return torch.device("cuda")


_CARD_CFG = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
                 max_seq_len=128, use_parallel_layers=False)


@pytest.mark.cuda
def test_cuda_eager_loop_matches_train_step(cuda_device):
    """A head_dim-64 GPT on the card under bf16 AMP: 4 steps of the dygraph
    loop (AdamW, warmup-cosine, global-norm clip) and of `jit.TrainStep`
    from the same weights give bit-equal losses and parameters; K3 and
    K4 launch num_layers times a step on the eager path."""
    from paddle_tpu_torch import amp, jit, nn, optimizer
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = TGPTConfig(**_CARD_CFG)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 96, (2, 2, 64))).to(cuda_device)

    def recipe(m):
        sched = optimizer.lr.LinearWarmup(optimizer.lr.CosineAnnealingDecay(
            1e-3, T_max=10), 2, 0.0, 1e-3)
        return sched, optimizer.AdamW(
            sched, parameters=m.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(1.0))

    def loss_fn(m, x, y):
        with amp.auto_cast(dtype="bfloat16"):
            logits = m(x)
        return nn.functional.cross_entropy(logits, y)

    a = TGPT.random(cfg, seed=1, device=cuda_device)
    b = TGPT.random(cfg, seed=1, device=cuda_device)
    sa, oa = recipe(a)
    sb, ob = recipe(b)
    step = jit.train_step(b, loss_fn, ob)
    n0 = fa.flash_attention_cuda_dkv.launches
    la, lb = [], []
    for _ in range(4):
        loss = loss_fn(a, ids[0], ids[1])
        loss.backward()
        oa.step()
        oa.clear_grad()
        sa.step()
        la.append(float(loss))
        lb.append(float(step(ids[0], ids[1])))
        sb.step()
    assert la == lb
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert fa.flash_attention_cuda_dkv.launches - n0 == \
        2 * 4 * cfg.num_layers


@pytest.mark.cuda
def test_cuda_check_nan_inf_and_dropout(cuda_device):
    """On the card: a captured serve with ``FLAGS_check_nan_inf`` on takes
    its graphs (the mode is off the stack while they are captured) and
    gives the flag-off tokens; a NaN raises; a dropout mask drawn inside
    a capture raises; one seed draws one mask on the card."""
    from paddle_tpu_torch.inference import serving as TS

    cfg = TGPTConfig(**_CARD_CFG)
    m = TGPT.random(cfg, seed=2, device=cuda_device)
    prompts = [[1, 2, 3, 4, 5], list(range(7, 40))]

    def serve():
        eng = TS.DecodeEngine(m, max_batch_size=2, max_seq_len=128,
                              page_size=16)
        return eng.generate(prompts, 6), eng.graph_captures()

    want, _ = serve()
    TF.set_flags({"check_nan_inf": True})
    try:
        got, graphs = serve()
        with pytest.raises(FloatingPointError):
            torch.log(-torch.ones(3, device=cuda_device))
    finally:
        TF.set_flags({"check_nan_inf": False})
    assert got == want and graphs >= 2
    x = torch.ones(1000, device=cuda_device)
    tpaddle.seed(4)
    d1 = TFn.dropout(x, 0.5)
    tpaddle.seed(4)
    assert torch.equal(d1, TFn.dropout(x, 0.5))
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g):
            TFn.dropout(x, 0.5)
