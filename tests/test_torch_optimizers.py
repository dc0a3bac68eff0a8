"""The ten optimizers of paddle_tpu_torch.optimizer beside Adam/AdamW
(`SGD`, `Momentum`, `Adagrad`, `Adadelta`, `Adamax`, `RMSProp`, `Lamb`,
`Lars`, `Ftrl`, `Dpsgd`) against the JAX package's.

Each takes `STEPS` steps of a tiny GPT (2 layers, hidden 32, vocab 64,
batch 4 x 16) from the same weights and batches in both packages,
through the dygraph loop (``loss.backward(); opt.step();
opt.clear_grad()``) and through ``jit.TrainStep``: losses within
`LOSS_TOL`, parameters and the eager slots within `PARAM_TOL` (f32
updates whose reductions and fused multiply-adds round in another
order).  One exception: the key part of each ``qkv`` bias, whose
gradient is zero but for rounding (softmax does not see a shift shared
by every key), so both packages update it from rounding noise, which the
normalizing optimizers (Adagrad, Adamax, ...) scale up to about ``lr`` a
step: there the bound is ``2 * lr * STEPS``.  An optimizer ``state_dict`` saved by either package loads into
the other's optimizer, which then steps as the original.  `Dpsgd` with
``sigma=0`` (clipping alone) is the JAX package's update; with noise it
is checked in distribution only (the generators differ).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as JJ
from paddle_tpu import optimizer as JO
from paddle_tpu.framework import io as JIO
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.nn.layer.layers import Parameter as JParameter
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.framework import io as TIO
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_loss_fn

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, use_parallel_layers=False, dropout=0.0)
STEPS = 5
LOSS_TOL = 1e-5
PARAM_TOL = 2e-5

# name -> keyword arguments, the same in both packages
OPTIMIZERS = {
    "SGD": dict(learning_rate=0.05, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.02, momentum=0.9, use_nesterov=True,
                     weight_decay=0.01),
    "Adagrad": dict(learning_rate=0.01),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "Adamax": dict(learning_rate=0.002),
    "RMSProp": dict(learning_rate=0.005, momentum=0.5, centered=True),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01),
    "Lars": dict(learning_rate=0.1),
    "Ftrl": dict(learning_rate=0.05, l1=0.001, l2=0.001),
    "Dpsgd": dict(learning_rate=0.05, clip=1.0, batch_size=4.0, sigma=0.0),
}


def _batches():
    rng = np.random.RandomState(11)
    return [(rng.randint(0, 64, (4, 16)).astype(np.int32),
             rng.randint(0, 64, (4, 16)).astype(np.int32))
            for _ in range(STEPS)]


def _models(seed=3):
    tm = TGPT.random(TGPTConfig(**CFG), seed=seed, device="cpu")
    m = GPT(GPTConfig(**CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m, tm


def _check_params(m, tm, lr):
    named = dict(tm.named_parameters())
    h = CFG["hidden_size"]
    for name, p in m.named_parameters():
        got, want = named[name].detach().numpy(), np.asarray(p.numpy())
        if name.endswith("qkv.bias"):
            keys = slice(h, 2 * h)
            np.testing.assert_allclose(got[keys], want[keys],
                                       atol=2 * lr * STEPS, err_msg=name)
            got, want = np.delete(got, np.s_[keys]), \
                np.delete(want, np.s_[keys])
        np.testing.assert_allclose(got, want, atol=PARAM_TOL, err_msg=name)


def _jnum(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_loop_matches_jax(name):
    """`STEPS` dygraph steps: losses, parameters and every slot of the
    optimizer's ``state_dict`` (the same keys)."""
    m, tm = _models()
    jopt = getattr(JO, name)(parameters=m.parameters(), **OPTIMIZERS[name])
    topt = getattr(TO, name)(parameters=tm.parameters(), **OPTIMIZERS[name])
    jl, tl = [], []
    for x, y in _batches():
        loss = jax_gpt_loss_fn(m, paddle.to_tensor(x), paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(_jnum(loss)))
        loss = gpt_loss_fn(tm, torch.from_numpy(x).long(),
                           torch.from_numpy(y).long())
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL)
    assert tl[-1] != tl[0]
    _check_params(m, tm, OPTIMIZERS[name]["learning_rate"])
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for k in jsd:
        if k == "step":
            assert tsd[k] == jsd[k] == STEPS
            continue
        assert tsd[k].dtype == torch.float32
        np.testing.assert_allclose(tsd[k].numpy(), _jnum(jsd[k]),
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_step_matches_jax(name):
    """`STEPS` steps of each package's ``jit.TrainStep``: losses and
    parameters."""
    m, tm = _models()
    jstep = JJ.train_step(m, jax_gpt_loss_fn, getattr(JO, name)(
        parameters=m.parameters(), **OPTIMIZERS[name]))
    tstep = TJ.train_step(tm, gpt_loss_fn, getattr(TO, name)(
        parameters=tm.parameters(), **OPTIMIZERS[name]))
    jl, tl = [], []
    for x, y in _batches():
        jl.append(float(_jnum(jstep(paddle.to_tensor(x),
                                    paddle.to_tensor(y))._array)))
        tl.append(float(tstep(torch.from_numpy(x).long(),
                              torch.from_numpy(y).long())))
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL)
    _check_params(m, tm, OPTIMIZERS[name]["learning_rate"])


def _small_params(rng):
    return [rng.randn(4, 6).astype(np.float32),
            rng.randn(6).astype(np.float32)]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_dict_crosses_packages(name, tmp_path):
    """Two steps in each package on small parameters with the same random
    gradients; each package's ``state_dict``, saved by its ``paddle.save``,
    loads through the other's ``paddle.load`` into a fresh optimizer over
    the other's parameters, and the third step of every pair agrees
    (1e-6)."""
    rng = np.random.RandomState(5)
    arrays = _small_params(rng)
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in arrays]
             for _ in range(3)]
    kw = OPTIMIZERS[name]
    jps = [JParameter(a) for a in arrays]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    jopt = getattr(JO, name)(parameters=jps, **kw)
    topt = getattr(TO, name)(parameters=tps, **kw)

    def jstep(opt, ps, gs):
        for p, g in zip(ps, gs):
            p.grad = paddle.to_tensor(g)
        opt.step()

    def tstep(opt, ps, gs):
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        opt.step()

    for gs in grads[:2]:
        jstep(jopt, jps, gs)
        tstep(topt, tps, gs)
    JIO.save(jopt.state_dict(), str(tmp_path / "j.pdopt"))
    TIO.save(topt.state_dict(), str(tmp_path / "t.pdopt"))
    # JAX state -> port optimizer over the port's parameters, and back
    tps2 = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    topt2 = getattr(TO, name)(parameters=tps2, **kw)
    topt2.set_state_dict(TIO.load(str(tmp_path / "j.pdopt"), device="cpu"))
    jps2 = [JParameter(np.asarray(p.numpy())) for p in jps]
    jopt2 = getattr(JO, name)(parameters=jps2, **kw)
    jopt2.set_state_dict(JIO.load(str(tmp_path / "t.pdopt")))
    for pair in ((jopt, jps, jstep), (jopt2, jps2, jstep),
                 (topt, tps, tstep), (topt2, tps2, tstep)):
        pair[2](pair[0], pair[1], grads[2])
    for a, b, c, d in zip(jps, jps2, tps, tps2):
        want = np.asarray(a.numpy())
        for got in (np.asarray(b.numpy()), c.detach().numpy(),
                    d.detach().numpy()):
            np.testing.assert_allclose(got, want, atol=1e-6)


def test_dpsgd_noise_in_distribution():
    """``sigma=2`` on zero gradients: each package's update is its noise
    times ``-lr``; both samples (200k draws) have mean 0 and deviation
    ``clip * sigma / batch_size`` within 2% (a sample deviation's error is
    ~0.2% here), and the port's draws follow the seed: equal under one
    ``paddle.seed``, other under another."""
    n, lr, clip, sigma, batch = 200_000, 1.0, 1.5, 2.0, 8.0
    std = clip * sigma / batch
    kw = dict(learning_rate=lr, clip=clip, batch_size=batch, sigma=sigma)

    def port_draw(seed):
        tpaddle.seed(seed)
        p = torch.nn.Parameter(torch.zeros(n))
        opt = TO.Dpsgd(parameters=[p], **kw)
        p.grad = torch.zeros(n)
        opt.step()
        return -p.detach().numpy() / lr

    jp = JParameter(np.zeros(n, np.float32))
    jopt = JO.Dpsgd(parameters=[jp], **kw)
    jp.grad = paddle.to_tensor(np.zeros(n, np.float32))
    jopt.step()
    jax_noise = -np.asarray(jp.numpy()) / lr
    a, b = port_draw(1), port_draw(1)
    assert np.array_equal(a, b) and not np.array_equal(a, port_draw(2))
    for sample in (a, jax_noise):
        assert abs(sample.mean()) < 4 * std / np.sqrt(n)
        assert abs(sample.std() / std - 1) < 0.02
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(a, qs), np.quantile(jax_noise, qs),
                               atol=0.02 * std * 2)
