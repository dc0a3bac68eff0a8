"""paddle_tpu_torch's fleet meta-optimizers against the JAX package's
(the counterparts of tests/test_meta_optimizers.py).

Each wrapper runs in both packages over the same parameters (a [4, 6]
matrix and a [6] vector, from numpy) with the same random gradients,
and the parameters are held equal after every step (1e-6: f32 updates
that round in another order); world size 1, where the collectives are
the identity in both.  Then the JAX tests' own scenarios, and the
`StrategyCompiler` chains.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import meta_optimizers as JM
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.distributed import fleet as TF
from paddle_tpu_torch.distributed.fleet import meta_optimizers as TM

TOL = 1e-6
STEPS = 6

# name -> (wrapper factory given (package's module, inner optimizer),
#          the inner optimizer's name and keywords)
CASES = {
    "gradient_merge": (lambda M, o: M.GradientMergeOptimizer(
        o, k_steps=3, avg=True), "SGD", dict(learning_rate=0.1)),
    "gradient_merge_sum_adam": (lambda M, o: M.GradientMergeOptimizer(
        o, k_steps=2, avg=False), "Adam", dict(learning_rate=0.01)),
    "local_sgd": (lambda M, o: M.LocalSGDOptimizer(o, k_steps=2),
                  "Momentum", dict(learning_rate=0.05)),
    "dgc": (lambda M, o: M.DGCOptimizer(o, rampup_begin_step=1,
                                        sparsity=0.75),
            "SGD", dict(learning_rate=0.1)),
    "fp16_allreduce": (lambda M, o: M.FP16AllReduceOptimizer(o), "SGD",
                       dict(learning_rate=0.1)),
    "lookahead": (lambda M, o: M.LookaheadOptimizer(o, alpha=0.3, k=2),
                  "Adam", dict(learning_rate=0.05)),
    "model_average": (lambda M, o: M.ModelAverage(
        o, average_window_rate=0.5, min_average_window=2,
        max_average_window=3), "SGD", dict(learning_rate=0.1)),
}


def _pair(name):
    rng = np.random.RandomState(4)
    arrays = [rng.randn(4, 6).astype(np.float32),
              rng.randn(6).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in arrays]
             for _ in range(STEPS)]
    wrap, inner, kw = CASES[name]
    jps = [JParameter(a) for a in arrays]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    jopt = wrap(JM, getattr(JO, inner)(parameters=jps, **kw))
    topt = wrap(TM, getattr(TO, inner)(parameters=tps, **kw))
    return jps, tps, jopt, topt, grads


def _equal(jps, tps, tol=TOL):
    for j, t in zip(jps, tps):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_matches_jax(name):
    jps, tps, jopt, topt, grads = _pair(name)
    tol = 1e-2 if name == "fp16_allreduce" else TOL  # bf16 gradients
    for gs in grads:
        for p, g in zip(jps, gs):
            p.grad = paddle.to_tensor(g)
        for p, g in zip(tps, gs):
            p.grad = torch.from_numpy(g.copy())
        jopt.step()
        topt.step()
        _equal(jps, tps, tol)
    if name == "fp16_allreduce":  # the bf16 rounding itself is equal
        _equal(jps, tps, 0.0)
    if name == "model_average":
        with jopt.apply(), topt.apply():
            _equal(jps, tps)
        _equal(jps, tps)


def test_ema_matches_jax():
    rng = np.random.RandomState(6)
    arrays = [rng.randn(5).astype(np.float32)]
    jp, tp = JParameter(arrays[0]), torch.nn.Parameter(
        torch.from_numpy(arrays[0].copy()))
    jema = JM.ExponentialMovingAverage(decay=0.9, parameters=[jp])
    tema = TM.ExponentialMovingAverage(decay=0.9, parameters=[tp])
    for _ in range(4):
        v = rng.randn(5).astype(np.float32)
        jp._array = paddle.to_tensor(v)._array
        with torch.no_grad():
            tp.copy_(torch.from_numpy(v))
        jema.update()
        tema.update()
    with jema.apply(), tema.apply():
        _equal([jp], [tp])
        shadow = tp.detach().clone()
    _equal([jp], [tp])
    assert not torch.equal(shadow, tp.detach())


def _param(value=1.0, shape=(4,)):
    return torch.nn.Parameter(torch.full(shape, float(value)))


def test_jax_scenarios():
    """tests/test_meta_optimizers.py's expectations, on the port."""
    p = _param()
    opt = TM.GradientMergeOptimizer(TO.SGD(0.1, parameters=[p]), k_steps=2)
    p.grad = torch.full((4,), 1.0)
    opt.step()
    assert torch.allclose(p, torch.ones(4))
    p.grad = torch.full((4,), 3.0)
    opt.step()
    assert torch.allclose(p, torch.full((4,), 0.8))

    p = _param(shape=(10,))
    opt = TM.DGCOptimizer(TO.SGD(1.0, parameters=[p]), sparsity=0.9)
    g = torch.zeros(10)
    g[3], g[7] = 5.0, 1.0
    p.grad = g
    opt.step()
    assert p[3].item() == pytest.approx(-4.0) and p[7].item() == 1.0
    p.grad = torch.zeros(10)
    opt.step()
    assert p[7].item() != 1.0

    p = _param(0.0)
    opt = TM.LookaheadOptimizer(TO.SGD(1.0, parameters=[p]), alpha=0.5, k=2)
    for _ in range(2):
        p.grad = torch.full((4,), -1.0)
        opt.step()
    assert torch.allclose(p, torch.ones(4))

    p = _param(0.0)
    opt = TM.ModelAverage(TO.SGD(1.0, parameters=[p]))
    for _ in range(2):
        p.grad = torch.full((4,), -1.0)
        opt.step()
    with opt.apply():
        assert torch.allclose(p, torch.full((4,), 1.5))
    assert torch.allclose(p, torch.full((4,), 2.0))

    # ZeRO-1 over a sharding group of one rank: the inner update, whole
    p = _param(0.0)
    opt = TM.DygraphShardingOptimizer(optimizer=TO.SGD(0.1, parameters=[p]))
    p.grad = torch.full((4,), 2.0)
    opt.step()
    assert torch.allclose(p, torch.full((4,), -0.2))
    assert opt.slot_bytes() == 0  # SGD keeps no slot


@pytest.mark.parametrize("switches", [
    dict(gradient_merge=True, dgc=True, localsgd=True, lookahead=True),
    dict(localsgd=True, fp16_allreduce=True),
    dict(lamb=True, lookahead=True),
    dict(lars=True),
])
def test_strategy_compiler_matches_jax(switches):
    """The same chain (names, classes, order) from the same strategy."""
    chains = {}
    for M, O, S, ps in ((JM, JO, JStrategy, [JParameter(np.ones(4,
                                                                np.float32))]),
                        (TM, TO, TF.DistributedStrategy, [_param()])):
        st = S()
        st.gradient_merge_configs = {"k_steps": 2, "avg": True}
        for k, v in switches.items():
            setattr(st, k, v)
        opt, applied = M.StrategyCompiler().generate_optimizer(
            O.SGD(learning_rate=0.1, parameters=ps, weight_decay=0.01), st)
        kinds = []
        while True:
            kinds.append(type(opt).__name__)
            if not hasattr(opt, "_inner") or "Optimizer" == \
                    type(opt).__name__:
                break
            if not isinstance(opt, M.MetaOptimizerBase):
                break
            opt = opt.inner
        chains[M] = (applied, kinds)
    assert chains[TM] == chains[JM]


def test_fleet_distributed_optimizer_wires_compiler(monkeypatch):
    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    st = TF.DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2, "avg": True}
    TF.init(is_collective=True, strategy=st)
    opt = TF.distributed_optimizer(TO.SGD(0.1, parameters=[_param()]))
    assert isinstance(opt, TM.GradientMergeOptimizer)
    assert TF.worker_num() == 1 and TF.is_first_worker()
    TF.init(is_collective=True)
