"""paddle_tpu_torch LayerNorm and its kernel route against the JAX package.

K5's plain version (`ops.layer_norm.layer_norm`, the route of every CPU
tensor and of every call with ``FLAGS_use_pallas_layernorm`` off) is held
against the TPU kernel `_ln_kernel` run in interpret mode
(`_fwd_pallas`) and against `_fwd_xla`, on the same inputs made with
numpy; then a tiny GPT trained with the flag on against the JAX
`TrainStep` with the flag on.  Kernel K5 itself is checked on the card
only (`cuda` marker).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu import jit as JJ
from paddle_tpu import optimizer as JO
from paddle_tpu.core import flags as JF
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.ops.pallas import layer_norm as JLN
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_loss_fn
from paddle_tpu_torch.ops import layer_norm as TLN

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=32, use_parallel_layers=False, dropout=0.0)
LR = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


@pytest.fixture
def layernorm_flag():
    """Turns FLAGS_use_pallas_layernorm on in both packages, and back."""
    TF.set_flags({"use_pallas_layernorm": True})
    paddle.set_flags({"FLAGS_use_pallas_layernorm": True})
    yield
    TF.set_flags({"use_pallas_layernorm": False})
    paddle.set_flags({"FLAGS_use_pallas_layernorm": False})


def _inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, w, b


def _within(got, want, dtype):
    """f32: 1e-5 (the same f32 statistics summed in another order).
    bf16: one output ulp, |d| <= 2**-7 |want| + 1e-6 (both compute in f32
    and round once to bf16)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(16, 128), (37, 768), (8, 4096),
                                    (5, 100)])
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_plain_matches_jax(rows, d, dtype, against, request):
    """The plain version against `_fwd_pallas` (the TPU kernel in
    interpret mode: row tiles of up to 256 rows) and `_fwd_xla`."""
    if against == "pallas":
        request.getfixturevalue("interpret_pallas")
    x, w, b = _inputs(rows, d, rows + d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jfn = JLN._fwd_pallas if against == "pallas" else JLN._fwd_xla
    want = jfn(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b),
               1e-5)
    got = TLN.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                         torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt and want.dtype == jdt
    _within(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("flag", [False, True])
def test_cpu_tensors_take_the_plain_version(flag):
    """With the flag off every call, and with it on every CPU call, runs
    `layer_norm`: the same values, no K5 launch."""
    x, w, b = map(torch.from_numpy, _inputs(6, 64, 1))
    TF.set_flags({"use_pallas_layernorm": flag})
    try:
        before = TLN.layer_norm_cuda.launches
        got = TLN.fused_layer_norm(x, w, b, 1e-5)
    finally:
        TF.set_flags({"use_pallas_layernorm": False})
    assert torch.equal(got, TLN.layer_norm(x, w, b, 1e-5))
    assert TLN.layer_norm_cuda.launches == before


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """K5 takes f32 or bf16 rows of a width it holds, on the card only; it
    raises on anything else and never computes a CPU answer itself."""
    x, w, b = map(torch.from_numpy, _inputs(4, 64, 2))
    with pytest.raises(ValueError, match="CUDA"):
        TLN.layer_norm_cuda(x, w, b, 1e-5)
    with pytest.raises(ValueError, match="float32 or bfloat16 x"):
        TLN.layer_norm_cuda(x.half(), w, b, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        TLN.layer_norm_cuda(x[:, :60].to(torch.bfloat16), w[:60], b[:60],
                            1e-5)
    with pytest.raises(ValueError, match="up to 16384"):
        z = torch.zeros(2, 16388)
        TLN.layer_norm_cuda(z, z[0], z[0], 1e-5)
    with pytest.raises(ValueError, match="one dtype"):
        TLN.layer_norm_cuda(x, w, b.to(torch.bfloat16), 1e-5)
    with pytest.raises(ValueError, match="rank"):
        TLN.layer_norm_cuda(x[None], w, b, 1e-5)


def _models(seed):
    tm = TGPT.random(TGPTConfig(**TINY), seed=seed, device="cpu")
    paddle.seed(seed)
    m = GPT(GPTConfig(**TINY))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m, tm


def test_train_step_with_the_flag_matches_jax(layernorm_flag):
    """Three AdamW steps of the tiny GPT with FLAGS_use_pallas_layernorm
    on in both packages, from the same weights and batch: losses and
    parameters within 1e-5 (f32; the two differ in summation order
    only), as `test_torch_training.test_train_step_matches_jax`."""
    assert TF.flag("use_pallas_layernorm") and \
        JF.flag("use_pallas_layernorm")
    m, tm = _models(seed=2)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 32)).astype(np.int32)
    jstep = JJ.train_step(m, jax_gpt_loss_fn, JO.AdamW(
        learning_rate=LR, parameters=m.parameters(), weight_decay=0.01))
    tstep = TJ.train_step(tm, gpt_loss_fn, TO.AdamW(
        learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01))
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(tokens),
                                         paddle.to_tensor(labels))._array)))
        tl.append(float(tstep(torch.from_numpy(tokens),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert tl[-1] < tl[0]
    jparams = {n: np.asarray(p.numpy()) for n, p in m.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n],
                                   atol=1e-5)


def test_gradient_is_the_same_with_the_flag(layernorm_flag):
    """The backward stays composed: on the CPU the flag changes neither
    the values nor the gradients."""
    x, w, b = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(6, 96, 3))
    g = torch.from_numpy(np.random.RandomState(4).randn(6, 96).astype(
        np.float32))
    on = TLN.fused_layer_norm(x, w, b, 1e-5)
    grads_on = torch.autograd.grad(on, (x, w, b), g)
    TF.set_flags({"use_pallas_layernorm": False})
    off = TLN.fused_layer_norm(x, w, b, 1e-5)
    grads_off = torch.autograd.grad(off, (x, w, b), g)
    assert torch.equal(on, off)
    for a, c in zip(grads_on, grads_off):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# kernel K5 on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k5_matches_reference(cuda_device, dtype):
    """K5 against the plain version on the card at widths of each of its
    launch shapes (one warp a row, 4 and 16 warps a row), with f32 and
    with bf16 weights; tolerances as `_within`."""
    tdt = getattr(torch, dtype)
    for rows, d in ((3, 64), (1000, 768), (257, 2048), (64, 4096),
                    (9, 16384 if dtype == "float32" else 32768)):
        x, w, b = (torch.from_numpy(a).to(cuda_device)
                   for a in _inputs(rows, d, d))
        x = x.to(tdt)
        for wd in (torch.float32, torch.bfloat16):
            before = TLN.layer_norm_cuda.launches
            got = TLN.layer_norm_cuda(x, w.to(wd), b.to(wd), 1e-5)
            want = TLN.layer_norm(x, w.to(wd), b.to(wd), 1e-5)
            torch.cuda.synchronize()
            assert TLN.layer_norm_cuda.launches == before + 1
            assert got.dtype == tdt
            _within(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    dtype)


@pytest.mark.cuda
def test_cuda_flag_routes_forward_to_k5(cuda_device, layernorm_flag):
    """With the flag on, `fused_layer_norm` of a CUDA tensor launches K5
    once per call and its composed gradient matches the flag-off one."""
    x, w, b = (torch.from_numpy(a).to(cuda_device).requires_grad_()
               for a in _inputs(64, 768, 5))
    before = TLN.layer_norm_cuda.launches
    on = TLN.fused_layer_norm(x, w, b, 1e-5)
    assert TLN.layer_norm_cuda.launches == before + 1
    gon = torch.autograd.grad(on.sum(), (x, w, b))
    TF.set_flags({"use_pallas_layernorm": False})
    off = TLN.fused_layer_norm(x, w, b, 1e-5)
    goff = torch.autograd.grad(off.sum(), (x, w, b))
    assert TLN.layer_norm_cuda.launches == before + 1
    _within(on.detach().cpu().numpy(), off.detach().cpu().numpy(),
            "float32")
    for a, c in zip(gon, goff):
        assert torch.equal(a, c)
