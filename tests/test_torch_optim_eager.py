"""paddle_tpu_torch's eager optimizer, LR schedules, clips and
regularizers against the JAX package's.

Every scheduler's rate over 30 steps (1e-12: the same host float
arithmetic); the three gradient clips and the two regularizers through
the eager ``step()`` of `Adam`/`AdamW` on small parameters with random
gradients made with numpy (1e-6: f32 updates whose rounding differs by
fused multiply-adds); the ``ParamAttr.learning_rate`` multiplier; the
optimizer's ``state_dict`` keys and round trip; and the JAX package's
asymmetry, kept: the staged ``apply_gradients`` (`jit.TrainStep`'s) does
not read a parameter's own regularizer, the eager step does.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu import regularizer as JR
from paddle_tpu.framework.param_attr import ParamAttr as JParamAttr
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu.utils import clip as JC
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch import regularizer as TR
from paddle_tpu_torch.framework import ParamAttr
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.utils import clip as TC

SCHED_TOL = 1e-12
STEP_TOL = 1e-6

# name -> a factory of one scheduler, given each package's `lr` module
SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(d_model=64, warmup_steps=5,
                                         learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([4, 9, 20],
                                                   [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.5, decay_steps=12,
                                                     end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, cycle=True),
    "LinearWarmup": lambda lr: lr.LinearWarmup(0.3, warmup_steps=6,
                                               start_lr=0.0, end_lr=0.3),
    "LinearWarmup_cosine": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(3e-4, T_max=20), 10, 0.0, 3e-4),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.5, milestones=[3, 11,
                                                                    17]),
    "StepDecay": lambda lr: lr.StepDecay(0.5, step_size=4, gamma=0.5),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 2 else 0.99),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(
        0.5, T_max=13, eta_min=0.01),
    "OneCycleLR": lambda lr: lr.OneCycleLR(0.1, total_steps=25),
    "CyclicLR": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=4,
                                       step_size_down=6, mode="triangular2"),
    "CyclicLR_exp": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=3,
                                           mode="exp_range", exp_gamma=0.97),
    "ReduceOnPlateau": lambda lr: lr.ReduceOnPlateau(0.5, patience=2,
                                                     factor=0.5, cooldown=1),
}
# the metric ReduceOnPlateau reads at each step: falls, then stalls
PLATEAU_METRICS = [1.0 - 0.1 * min(i, 6) + 0.001 * (i % 3)
                   for i in range(30)]


def _run_sched(s, plateau):
    out = []
    for i in range(30):
        out.append(s())
        if plateau:
            s.step(PLATEAU_METRICS[i])
        else:
            s.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    """30 rates of each scheduler, then its ``state_dict`` restored into
    a fresh one continues the same rates."""
    plateau = name == "ReduceOnPlateau"
    js, ts = SCHEDULERS[name](JO.lr), SCHEDULERS[name](TO.lr)
    want, got = _run_sched(js, plateau), _run_sched(ts, plateau)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCHED_TOL)
    assert len(set(np.round(got, 12))) > 1  # the rate moved
    if not plateau:
        fresh = SCHEDULERS[name](TO.lr)
        fresh.set_state_dict(ts.state_dict())
        assert fresh() == ts()
        fresh.step()
        ts.step()
        assert math.isclose(fresh(), ts(), abs_tol=SCHED_TOL)


def _params(rng):
    return [rng.randn(4, 6).astype(np.float32),
            rng.randn(6).astype(np.float32),
            rng.randn(3, 2).astype(np.float32)]


def _eager_pair(case, arrays):
    """JAX Parameters and torch Parameters over the same arrays, and each
    package's optimizer for ``case``."""
    jps = [JParameter(a) for a in arrays]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    kind, arg = case
    sides = []
    for mod, reg, clip, ps in ((JO, JR, JC, jps), (TO, TR, TC, tps)):
        kw = dict(learning_rate=0.05, parameters=ps)
        if kind == "clip":
            kw["grad_clip"] = getattr(clip, arg[0])(*arg[1:])
        elif kind == "weight_decay":
            kw["weight_decay"] = getattr(reg, arg[0])(arg[1])
        elif kind == "param_regularizer":
            for p in ps[:2]:  # the third keeps the optimizer's decay
                p.regularizer = getattr(reg, arg[0])(arg[1])
            kw["weight_decay"] = 0.02
        opt = (mod.AdamW if kind == "adamw" else mod.Adam)(**kw)
        sides.append((ps, opt))
    return sides


CASES = {
    "clip_by_value": ("clip", ("ClipGradByValue", 0.3)),
    "clip_by_norm": ("clip", ("ClipGradByNorm", 0.8)),
    "clip_by_global_norm": ("clip", ("ClipGradByGlobalNorm", 1.5)),
    "l2_decay": ("weight_decay", ("L2Decay", 0.1)),
    "l1_decay_as_weight_decay": ("weight_decay", ("L1Decay", 0.1)),
    "l1_param_regularizer": ("param_regularizer", ("L1Decay", 0.2)),
    "l2_param_regularizer": ("param_regularizer", ("L2Decay", 0.2)),
    "adamw": ("adamw", None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_step_matches_jax(name):
    """Three eager ``step()``s of each case, new gradients each step (one
    parameter without a gradient in step 2), the gradients cleared after
    each; parameters and moments within `STEP_TOL` of JAX's."""
    rng = np.random.RandomState(7)
    arrays = _params(rng)
    (jps, jopt), (tps, topt) = _eager_pair(CASES[name], arrays)
    for step in range(3):
        grads = [rng.randn(*a.shape).astype(np.float32) * 2 for a in arrays]
        for i, (jp, tp, g) in enumerate(zip(jps, tps, grads)):
            live = not (step == 1 and i == 1)
            jp.grad = paddle.Tensor(g) if live else None
            tp.grad = torch.from_numpy(g) if live else None
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        assert all(p.grad is None for p in tps)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   atol=STEP_TOL)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(jsd) == sorted(tsd)
    assert tsd["step"] == jsd["step"] == 3
    for k in jsd:
        if k != "step":
            np.testing.assert_allclose(tsd[k].numpy(), jsd[k].numpy(),
                                       rtol=1e-5, atol=STEP_TOL)


def test_clip_arrays_and_pairs_agree():
    """Each clip's staged form (``clip_arrays``) and eager form
    (``__call__`` on pairs) give the same gradients, None passing
    through, and equal JAX's staged form."""
    rng = np.random.RandomState(8)
    grads = [rng.randn(5, 3).astype(np.float32) * 3, None,
             rng.randn(7).astype(np.float32)]
    for name, args in (("ClipGradByValue", (0.5,)),
                       ("ClipGradByNorm", (1.0,)),
                       ("ClipGradByGlobalNorm", (2.0,))):
        tg = [None if g is None else torch.from_numpy(g) for g in grads]
        staged = getattr(TC, name)(*args).clip_arrays(tg)
        pairs = getattr(TC, name)(*args)([(i, g) for i, g in enumerate(tg)])
        want = getattr(JC, name)(*args).clip_arrays(
            [None if g is None else paddle.Tensor(g)._array for g in grads])
        for s, (_, p), w in zip(staged, pairs, want):
            if w is None:
                assert s is None and p is None
                continue
            assert torch.equal(s, p)
            np.testing.assert_allclose(s.numpy(), np.asarray(w), atol=1e-6)


def test_param_attr_learning_rate_and_regularizer():
    """A `Linear` whose weight has ``ParamAttr(learning_rate=0.5,
    regularizer=L2Decay(0.3))``, against JAX's, through two eager AdamW
    steps; the multiplier is also read by the staged form."""
    rng = np.random.RandomState(9)
    w = rng.randn(3, 4).astype(np.float32)

    def attr(mod_attr, reg):
        return mod_attr(learning_rate=0.5, regularizer=reg.L2Decay(0.3))

    jl = paddle.nn.Linear(3, 4, weight_attr=attr(JParamAttr, JR))
    tl = Linear(3, 4, weight_attr=attr(ParamAttr, TR), device="cpu")
    assert tl.weight.optimize_attr == {"learning_rate": 0.5}
    jl.weight.set_value(w)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    jopt = JO.AdamW(0.1, parameters=jl.parameters())
    topt = TO.AdamW(0.1, parameters=tl.parameters())
    for _ in range(2):
        g = rng.randn(3, 4).astype(np.float32)
        jl.weight.grad = paddle.Tensor(g)
        tl.weight.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
    np.testing.assert_allclose(tl.weight.detach().numpy(), jl.weight.numpy(),
                               atol=STEP_TOL)
    mults = TO.optimizer.collect_lr_mults(dict(tl.named_parameters()))
    assert mults == {"weight": 0.5, "bias": 1.0}


def test_staged_form_ignores_param_regularizer_as_jax_does():
    """The same parameter and gradient through the staged
    ``apply_gradients`` and the eager ``step()`` of each package: the
    staged update equals an update without the parameter's regularizer,
    the eager one differs from it — in both packages alike."""
    rng = np.random.RandomState(10)
    a = rng.randn(6).astype(np.float32)
    g = rng.randn(6).astype(np.float32)
    out = {}
    for side in ("jax", "torch"):
        mod, reg = (JO, JR) if side == "jax" else (TO, TR)
        if side == "jax":
            p = JParameter(a)
            p.regularizer = reg.L2Decay(0.5)
            opt = mod.Adam(0.1, parameters=[p])
            new, _ = opt.apply_gradients({"p": p._array},
                                         {"p": paddle.Tensor(g)._array},
                                         opt.init_state({"p": p}), 0.1, 1)
            staged = np.asarray(new["p"])
            p.grad = paddle.Tensor(g)
            opt.step()
            eager = p.numpy()
        else:
            p = torch.nn.Parameter(torch.from_numpy(a.copy()))
            p.regularizer = reg.L2Decay(0.5)
            opt = mod.Adam(0.1, parameters=[p])
            q = torch.from_numpy(a.copy())
            opt.apply_gradients({"p": q}, {"p": torch.from_numpy(g)},
                                opt.init_state({"p": q}), 0.1, 1)
            staged = q.numpy()
            p.grad = torch.from_numpy(g)
            opt.step()
            eager = p.detach().numpy()
        out[side] = staged, eager
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], atol=STEP_TOL)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=STEP_TOL)
    plain = TO.Adam(0.1)
    q = torch.from_numpy(a.copy())
    plain.apply_gradients({"p": q}, {"p": torch.from_numpy(g)},
                          plain.init_state({"p": q}), 0.1, 1)
    assert np.array_equal(out["torch"][0], q.numpy())
    assert not np.allclose(out["torch"][1], q.numpy(), atol=1e-4)


def test_optimizer_lr_and_minimize():
    """``set_lr`` on a constant rate (refused under a scheduler, as in
    JAX), and ``minimize(loss)`` = backward, step, clear_grad."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = TO.Adam(0.1, parameters=[p])
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    with pytest.raises(RuntimeError, match="LRScheduler"):
        TO.Adam(TO.lr.StepDecay(0.1, 2), parameters=[p]).set_lr(0.3)
    before = p.detach().clone()
    _, pairs = opt.minimize((p * p).sum())
    assert p.grad is None and pairs[0][1] is None
    assert torch.allclose(p.detach(), before - 0.2 * torch.sign(before))
    with pytest.raises(ValueError, match="parameters"):
        TO.Adam(0.1).step()
