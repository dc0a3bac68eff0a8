"""paddle_tpu_torch GPT training against the JAX package.

The pieces of the train path — `cross_entropy`, `fused_layer_norm`'s
gradient, `auto_cast`'s dtypes, `AdamW.apply_gradients` — and then the
whole slice: a tiny GPT through the port's `jit.TrainStep` against
`paddle_tpu.jit.TrainStep` from the same weights and the same batch,
made with numpy.  Both sides run on the CPU, where the port's attention
is the composed form and the JAX package's is its XLA reference.
Tolerances are stated per test.  Serving's step functions are held to
recording no autograd graph now that the model's parameters train.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as JA
from paddle_tpu import jit as JJ
from paddle_tpu import optimizer as JO
from paddle_tpu.core import flags as JF
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.nn import functional as JFn
from paddle_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_fln
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import (params_from_numpy,
                                                params_to_numpy)
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_loss_fn
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.nn.layer import Dropout
from paddle_tpu_torch.ops.layer_norm import fused_layer_norm

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=32, use_parallel_layers=False, dropout=0.0)
LR = 1e-4


# ---------------------------------------------------------------------------
# cross entropy, LayerNorm, auto_cast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(dtype, reduction):
    """Values and gradients of the hard-label path, with two rows at
    ``ignore_index``.  f32 2e-5; bf16 2e-2 on the loss (the bf16 shift
    rounds the exp-sum terms, in the same places in both) and 1e-2 on
    the bf16 gradients (values below 1, rounded to bf16 at different
    points: two bf16 ulps)."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 5, 97) * 3).astype(np.float32)
    labels = rng.randint(0, 97, (3, 5)).astype(np.int32)
    labels[0, 1] = labels[2, 4] = -100
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(x):
        return JFn.cross_entropy(paddle.Tensor(x), paddle.to_tensor(labels),
                                 reduction=reduction)._array

    want, jvjp = jax.vjp(jloss, jnp.asarray(logits).astype(jdt))
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    got = TFn.cross_entropy(x, torch.from_numpy(labels), reduction=reduction)
    cot = np.asarray(np.random.RandomState(1).rand(*np.shape(want)),
                     np.float32)
    got.backward(torch.from_numpy(cot))
    (jgrad,) = jvjp(jnp.asarray(cot).astype(want.dtype))
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(jgrad, np.float32),
                               atol=1e-2 if dtype == "bfloat16" else 2e-6)
    if reduction == "none":
        assert float(got[0, 1].detach()) == float(got[2, 4].detach()) == 0.0


def test_cross_entropy_unported_forms_raise():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="slice"):
        TFn.cross_entropy(x, torch.zeros(2, 4), soft_label=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_norm_gradient_matches_jax(dtype):
    """dx, dw, db of the custom VJP (statistics recomputed in f32).  f32
    1e-5; bf16 dx 2e-2 (rounded to bf16 once, in both)."""
    rng = np.random.RandomState(2)
    x = (rng.randn(6, 48) * 2 + 1).astype(np.float32)
    w = (rng.rand(48) + 0.5).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    g = rng.randn(6, 48).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out, vjp = jax.vjp(lambda a, c, d: jax_fln(a, c, d, 1e-5),
                       jnp.asarray(x).astype(jdt), jnp.asarray(w),
                       jnp.asarray(b))
    want = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = fused_layer_norm(tx, tw, tb, 1e-5)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out, np.float32), atol=atol)
    for t, wnt in zip((tx, tw, tb), want):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(wnt, np.float32),
                                   atol=atol * 10 if t is not tx else atol)


def _record_dtypes(model):
    """Forward hooks noting the output dtype of qkv, out_proj and fc1 of
    block 0, and of the model (the logits)."""
    seen = {}
    blk = model.blocks[0]
    for name, mod in (("qkv", blk.qkv), ("attention_in", blk.out_proj),
                      ("fc1", blk.fc1), ("logits", model)):
        if name == "attention_in":
            mod.register_forward_hook(
                lambda m, i, o, n=name: seen.__setitem__(n, i[0].dtype))
        else:
            mod.register_forward_hook(
                lambda m, i, o, n=name: seen.__setitem__(n, o.dtype))
    return seen


@pytest.mark.parametrize("enable", [True, False])
def test_auto_cast_dtypes_at_qkv_attention_and_logits(enable):
    """Under bf16 auto_cast the WHITE ops (linear, attention, the tied
    head's matmul) run in bf16 while the residual stream and the
    parameters stay f32; without it everything is f32."""
    tm = TGPT.random(TGPTConfig(**TINY), seed=0, device="cpu")
    seen = _record_dtypes(tm)
    ids = torch.randint(0, 256, (2, 8), generator=torch.Generator().
                        manual_seed(0))
    with TA.auto_cast(enable=enable, dtype="bfloat16"):
        logits = tm(ids)
        assert TA.is_auto_cast_enabled() == enable
    assert not TA.is_auto_cast_enabled()
    want = torch.bfloat16 if enable else torch.float32
    assert seen == {"qkv": want, "attention_in": want, "fc1": want,
                    "logits": want}
    assert logits.dtype == want
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    # BLACK widens half precision to f32, and no policy keeps dtypes
    with TA.auto_cast():
        x = torch.zeros(2, dtype=torch.bfloat16)
        assert TA.cast_inputs(TA.BLACK, x)[0].dtype == torch.float32
        assert TA.cast_inputs(None, x)[0].dtype == torch.bfloat16


def _adamw_pair(wd):
    return (JO.AdamW(learning_rate=1e-2, weight_decay=wd),
            TO.AdamW(learning_rate=1e-2, weight_decay=wd))


@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_adamw_apply_gradients_matches_jax(wd):
    """Three staged updates of random arrays; f32 within 1e-6 (the
    moments' rounding differs by fused multiply-adds)."""
    rng = np.random.RandomState(3)
    shapes = {"a": (4, 5), "b": (7,), "c": (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in
              shapes.items()}
    jopt, topt = _adamw_pair(wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jopt.init_state(jp), topt.init_state(tp)
    for step in range(1, 4):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in
                 shapes.items()}
        grads["b"] = None if step == 2 else grads["b"]
        jp, jst = jopt.apply_gradients(
            jp, {k: None if g is None else jnp.asarray(g)
                 for k, g in grads.items()}, jst,
            jnp.asarray(1e-2, jnp.float32), step)
        topt.apply_gradients(
            tp, {k: None if g is None else torch.from_numpy(g)
                 for k, g in grads.items()}, tst, 1e-2, step)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(tst[k]["moment2"].numpy(),
                                   np.asarray(jst[k]["moment2"]), rtol=1e-5)
        assert tst[k]["beta1_pow"].dtype == torch.float32
        np.testing.assert_allclose(float(tst[k]["beta2_pow"]),
                                   float(jst[k]["beta2_pow"]), rtol=1e-7)


def test_optimizer_learning_rate_constant_or_scheduled():
    """A float is the constant learning rate; an `LRScheduler` is read at
    each `get_lr`, as the JAX package's optimizers do."""
    class Halving(TO.lr.LRScheduler):
        def get_lr(self):
            return self.base_lr * 0.5 ** self.last_epoch

    assert TO.AdamW(learning_rate=3e-4).get_lr() == 3e-4
    sched = Halving(1.0)
    opt = TO.AdamW(learning_rate=sched)
    assert opt.get_lr() == 1.0
    sched.step()
    assert opt.get_lr() == 0.5


# ---------------------------------------------------------------------------
# the whole slice: TrainStep against the JAX TrainStep
# ---------------------------------------------------------------------------
def _amp_loss(jax_side):
    def loss_fn(m, tokens, labels):
        ctx = JA.auto_cast if jax_side else TA.auto_cast
        with ctx(enable=True, dtype="bfloat16"):
            logits = m(tokens)
        ce = JFn.cross_entropy if jax_side else TFn.cross_entropy
        return ce(logits, labels, reduction="mean")
    return loss_fn


def _models(seed):
    """The port's tiny GPT (GPT-2 init from ``seed``) and a JAX GPT with
    the same weights."""
    tm = TGPT.random(TGPTConfig(**TINY), seed=seed, device="cpu")
    paddle.seed(seed)
    m = GPT(GPTConfig(**TINY))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m, tm


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "bf16_amp"])
def test_train_step_matches_jax(use_amp):
    """Three AdamW steps of the tiny GPT (2 layers, hidden 64, 4 heads,
    vocab 256, B=2, S=32) from the same weights and batch.

    f32: losses within 1e-5 and parameters within 1e-5; the two differ
    only in summation order.  bf16 AMP: losses within 2e-2 (bf16 rounds
    the activations and logits at ~2**-8); parameters within 10 * lr at
    most and 1e-5 on average — Adam normalizes each update to about lr,
    so a gradient near zero whose bf16 rounding differs in sign (the
    key bias's, which softmax cancels) moves its parameter up to 2 * lr
    apart a step."""
    m, tm = _models(seed=1)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 32)).astype(np.int32)
    jstep = JJ.train_step(m, _amp_loss(True) if use_amp else jax_gpt_loss_fn,
                          JO.AdamW(learning_rate=LR,
                                   parameters=m.parameters(),
                                   weight_decay=0.01))
    tstep = TJ.train_step(tm, _amp_loss(False) if use_amp else gpt_loss_fn,
                          TO.AdamW(learning_rate=LR,
                                   parameters=tm.parameters(),
                                   weight_decay=0.01))
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(tokens),
                                         paddle.to_tensor(labels))._array)))
        loss = tstep(torch.from_numpy(tokens), torch.from_numpy(labels))
        assert loss.dtype == torch.float32 and not loss.requires_grad
        tl.append(float(loss))
    assert all(p.grad is None for p in tm.parameters())
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=2e-2 if use_amp else 1e-5)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, JS._extract_gpt_params(m)))
    got = jax.tree_util.tree_leaves(params_to_numpy(tm.params()))
    diffs = [np.abs(g - w) for g, w in zip(got, want)]
    if use_amp:
        assert max(float(d.max()) for d in diffs) <= 10 * LR
        assert float(np.concatenate([d.ravel() for d in diffs]).mean()) \
            <= 1e-5
    else:
        assert max(float(d.max()) for d in diffs) <= 1e-5


def test_forward_logits_match_jax():
    """The cacheless forward in f32, within 1e-5."""
    m, tm = _models(seed=2)
    ids = np.random.RandomState(4).randint(0, 256, (2, 20)).astype(np.int32)
    want = np.asarray(m(paddle.to_tensor(ids))._array)
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# weights, flags, dropout, serving
# ---------------------------------------------------------------------------
def test_params_round_trip_and_train():
    m, tm = _models(seed=3)
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    leaves = params_from_numpy(tree, device="cpu", requires_grad=True)
    assert leaves["wte"].requires_grad and leaves["wte"].is_leaf
    back = params_to_numpy(TGPT.from_params(TGPTConfig(**TINY),
                                            leaves).params())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert not params_from_numpy(tree, device="cpu")["wte"].requires_grad


@pytest.mark.parametrize("name,other", [("use_pallas_attention", "1"),
                                        ("use_pallas_layernorm", True)])
def test_attention_and_layernorm_flags_default_only(name, other):
    """use_pallas_attention keeps its default; use_pallas_layernorm is
    ported (kernel K5): the flag is set, and a `TrainStep` runs with it
    (on the CPU every LayerNorm takes the plain version)."""
    assert TF.flag(name) == JF.flag(name)
    if name == "use_pallas_layernorm":
        TF.set_flags({name: other})
        try:
            assert TF.flag(name) is True
            tm = TGPT.random(TGPTConfig(**TINY), seed=5, device="cpu")
            step = TJ.train_step(tm, gpt_loss_fn, TO.AdamW(
                learning_rate=LR, parameters=tm.parameters()))
            ids = torch.from_numpy(np.random.RandomState(0).randint(
                0, 256, (2, 8)).astype(np.int32))
            assert np.isfinite(float(step(ids, ids)))
        finally:
            TF.set_flags({name: JF.flag(name)})
        return
    with pytest.raises(NotImplementedError, match="slice"):
        TF.set_flags({name: other})
    TF.set_flags({name: JF.flag(name)})


def test_dropout_in_training_raises():
    """Dropout with p > 0 is ported: in training it zeroes elements and
    scales the rest by 1 / (1 - p) (rates and seeds:
    tests/test_torch_eager.py); in eval mode and at p == 0 it is the
    identity.  What raises is decoding under live dropout: ``generate``
    and `DecodeEngine` refuse a model in train mode with
    ``cfg.dropout > 0``, as the JAX package's do."""
    d = Dropout(0.1)
    x = torch.ones(64)
    y = d(x)
    assert bool(((y == 0) | torch.isclose(y, torch.tensor(1 / 0.9))).all())
    d.eval()
    assert d(x) is x
    assert Dropout(0.0)(x) is x
    tm = TGPT.random(TGPTConfig(**dict(TINY, dropout=0.1)), seed=0,
                     device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="eval"):
        tm.generate(ids, max_new_tokens=2)
    with pytest.raises(ValueError, match="eval"):
        TS.DecodeEngine(tm, device="cpu", max_batch_size=1, max_seq_len=32,
                        page_size=16)
    tm.eval()
    assert tm.generate(ids, max_new_tokens=2).shape == (1, 2)


@pytest.mark.parametrize("mixed", [False, True])
def test_serve_steps_record_no_autograd_graph(mixed):
    """With the model's parameters trainable and passed straight in, a
    serve step still writes its K/V pages and returns tokens without an
    autograd graph."""
    tm = TGPT.random(TGPTConfig(**TINY), seed=4, device="cpu")
    params = tm.params()
    for t in jax.tree_util.tree_leaves(params):
        t.requires_grad_()
    pages = [torch.zeros(2, 4, 6, 16, 16) for _ in range(2)]
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    kw = dict(num_heads=4, head_dim=16, eps=1e-5,
              sampling=dict(sampler="greedy"))
    if mixed:
        toks = TS._gpt_mixed_step(
            params, *pages, bt, torch.tensor([0, 0], dtype=torch.int32),
            torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
            torch.tensor([3, 2], dtype=torch.int32),
            torch.tensor([2, 1], dtype=torch.int32),
            torch.tensor([True, True]), None, **kw)
    else:
        toks = TS._gpt_decode_step(
            params, *pages, bt, torch.tensor([3, 5], dtype=torch.int32),
            torch.tensor([7, 9], dtype=torch.int32),
            torch.tensor([True, True]), None, **kw)
    assert toks.grad_fn is None and not toks.requires_grad
    for p in pages:
        assert p.grad_fn is None and not p.requires_grad
        assert float(p.abs().sum()) > 0  # the step did write K/V
