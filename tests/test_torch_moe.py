"""The port's mixture of experts against the JAX package's
(paddle_tpu/distributed/fleet/meta_parallel/moe_layer.py).

``moe_gating`` on logits with clear margins (each row a permutation of
levels 0.5 apart, so no near-tie can flip a choice between the two
softmaxes), k = 1 and 2, with and without overflowing capacity: the
dispatch masks equal, combine and aux within 1e-6.  ``moe_forward`` and
its gradients (``jax.grad`` against autograd) within 1e-5.  ``MoELayer``
loaded from JAX's parameters: output and aux within 1e-5.

Expert parallelism runs on gloo ranks inside the shared jobs of
tests/torch_hybrid_runner.py (``_moe_ep_checks``: the 2-rank job of
test_torch_tensor_parallel.py and the 4-rank job of
test_torch_pipeline.py, started once a session): the explicit mode
against JAX's ``shard_map`` on as many CPU devices, tokens sharded and
replicated, at JAX's own tolerance (rtol 2e-4, atol 2e-5), with the
gradients of ``gate_w`` and ``w1`` of JAX's ``test_ep_gradients_flow``
loss (each rank backpropagates its share of that loss; the shares sum
to it); ``collective.alltoall`` exchanging each block once; and the
fleet mode (``ep_axis="mp"``, dp = 2 x mp = 2) against JAX's
``fleet.build_train_step`` within 1e-5 on losses and weights (the MSE
loss of JAX's tests/test_moe.py: under dp > 1 each rank gates its own
slice, which equals GSPMD's global gating while no expert overflows,
``capacity_factor=4.0``; the auxiliary loss, a product of means over
the batch, would differ, so it stays out of that loss, as in JAX's
test).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import MoELayer as JMoELayer
from paddle_tpu.distributed.fleet.meta_parallel import \
    moe_forward as jmoe_forward
from paddle_tpu.distributed.fleet.meta_parallel import \
    moe_gating as jmoe_gating

from paddle_tpu_torch.distributed.fleet.meta_parallel import (MoELayer,
                                                              moe_forward,
                                                              moe_gating)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_runner as R  # noqa: E402

GATE_TOL = 1e-6
FWD_TOL = 1e-5
EP_RTOL, EP_ATOL = 2e-4, 2e-5
FLEET_TOL = 1e-5


def _clear_logits(t, e, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(e) * 0.5 for _ in range(t)]).astype(
        np.float32) + rng.uniform(-0.05, 0.05, (t, e)).astype(np.float32)


@pytest.mark.parametrize("k,capacity", [(1, 6), (2, 8), (1, 2), (2, 3)])
def test_gating_matches_jax(k, capacity):
    logits = _clear_logits(16, 4, seed=k * 10 + capacity)
    jm, jc, ja = jax.jit(jmoe_gating, static_argnums=(1, 2))(
        jnp.asarray(logits), k, capacity)
    tm, tc, ta = moe_gating(torch.from_numpy(logits), k, capacity)
    assert tm.dtype == torch.bool and tuple(tm.shape) == (16, 4, capacity)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=GATE_TOL,
                               rtol=0)
    assert abs(float(ta) - float(ja)) <= GATE_TOL
    if capacity < 16 * k / 4:  # overflow: some token lost a slot
        assert int(tm.sum()) < 16 * k


def _moe_args(seed, t=12, h=8, f=16, e=4):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return (rng.randn(t, h).astype(f32), rng.randn(h, e).astype(f32),
            (rng.randn(e, h, f) * 0.3).astype(f32),
            (rng.randn(e, f) * 0.1).astype(f32),
            (rng.randn(e, f, h) * 0.3).astype(f32),
            (rng.randn(e, h) * 0.1).astype(f32))


@pytest.mark.parametrize("k", [1, 2])
def test_moe_forward_and_gradients_match_jax(k):
    args = _moe_args(3 + k)

    def jloss(*a):
        out, aux = jmoe_forward(*a, k=k, capacity_factor=1.0)
        return (out ** 2).mean() + 0.01 * aux, (out, aux)

    (jl, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
            *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, aux = moe_forward(*ts, k=k, capacity_factor=1.0)
    loss = (out ** 2).mean() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=FWD_TOL)
    assert abs(float(aux.detach()) - float(jaux)) <= FWD_TOL
    assert abs(float(loss.detach()) - float(jl)) <= FWD_TOL
    for name, t, g in zip(("x", "gate_w", "w1", "b1", "w2", "b2"), ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=FWD_TOL, rtol=FWD_TOL, err_msg=name)


def test_moe_layer_loads_jax_parameters():
    paddle.seed(0)
    jl = JMoELayer(hidden_size=16, intermediate_size=32, num_experts=4, k=2)
    tl = MoELayer(16, 32, 4, k=2, device="cpu")
    jp = {n: np.asarray(p.numpy()) for n, p in jl.named_parameters()}
    assert {n: list(p.shape) for n, p in tl.named_parameters()} == \
        {n: list(v.shape) for n, v in jp.items()}
    # the initializers: Normal(0, 0.02) weights, zero biases
    assert abs(float(tl.w1.detach().std()) - 0.02) < 2e-3
    assert float(tl.b1.detach().abs().max()) == 0.0
    assert float(tl.b2.detach().abs().max()) == 0.0
    tl.set_state_dict(jp)
    x = np.random.RandomState(5).randn(2, 6, 16).astype(np.float32)
    want = np.asarray(jl(paddle.to_tensor(x)).numpy())
    got = tl(torch.from_numpy(x))
    assert list(got.shape) == [2, 6, 16]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert abs(float(tl.aux_loss.detach())
               - float(jl.aux_loss.numpy())) <= FWD_TOL
    # without a group in scope the layer is the dense one, whatever its axis
    dense = MoELayer(16, 32, 4, k=2, ep_axis="mp", device="cpu")
    assert dense.ep_group() is None and list(dense.w1.shape) == [4, 16, 32]


# ---------------------------------------------------------------------------
# expert parallelism on gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    from test_torch_pipeline import pipe_job
    from test_torch_tensor_parallel import tp_job

    return {2: [r["moe_ep"] for r in tp_job(tmp_path_factory)],
            4: [r["moe_ep"] for r in pipe_job(tmp_path_factory)]}


def _jax_ep(n, layout):
    """JAX's shard_map over n CPU devices: out, per-device aux and the
    gradients of gate_w and w1 of test_ep_gradients_flow's loss."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from jax.experimental.shard_map import shard_map  # JAX's own call

    a = R.moe_inputs()
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    x = a["moe_x"][:n * R.MOE_T]
    ws = [a[f"moe_{k}"] for k in ("gw", "w1", "b1", "w2", "b2")]
    tok = P("ep") if layout == "sharded" else P()

    def per(xv, gw, w1, b1, w2, b2):
        out, aux = jmoe_forward(xv, gw, w1, b1, w2, b2, k=R.MOE_K,
                                capacity_factor=R.MOE_CF, axis_name="ep")
        return out, aux.reshape(1) if layout == "sharded" else aux

    fn = shard_map(per, mesh=mesh,
                   in_specs=(tok, P(), P("ep"), P("ep"), P("ep"), P("ep")),
                   out_specs=(tok, tok), check_rep=False)

    def loss(x, gw, w1, b1, w2, b2):
        out, aux = fn(x, gw, w1, b1, w2, b2)
        return (out ** 2).mean() + 0.01 * aux.mean(), (out, aux)

    (_, (out, aux)), (g_gw, g_w1) = jax.jit(jax.value_and_grad(
        loss, argnums=(1, 2), has_aux=True))(x, *ws)
    return (np.asarray(out), np.atleast_1d(np.asarray(aux)),
            np.asarray(g_gw), np.asarray(g_w1))


@pytest.mark.parametrize("layout", ["sharded", "replicated"])
@pytest.mark.parametrize("n", [2, 4])
def test_explicit_ep_matches_jax_shard_map(ep_ranks, n, layout):
    out, aux, g_gw, g_w1 = _jax_ep(n, layout)
    tol = dict(rtol=EP_RTOL, atol=EP_ATOL)
    for r, res in enumerate(ep_ranks[n]):
        got = res[layout]
        want_out = out[r * R.MOE_T:(r + 1) * R.MOE_T] \
            if layout == "sharded" else out
        np.testing.assert_allclose(got["out"], want_out, **tol)
        np.testing.assert_allclose(got["aux"], aux[r if layout == "sharded"
                                                   else 0], **tol)
        np.testing.assert_allclose(got["gw_grad"], g_gw, **tol)
        np.testing.assert_allclose(got["w1_grad"], g_w1, **tol)


@pytest.mark.parametrize("n", [2, 4])
def test_explicit_ep_state_and_alltoall(ep_ranks, n):
    """The experts cut by ``shard_state_dict`` and joined whole by
    ``full_state_dict``; ``alltoall`` moves each block once (its
    ``comm_stats`` bytes are the input's size) and sends the gradient
    back; each MoE forward moves its two ``[E, C, H]`` buffers."""
    a = R.moe_inputs()
    for r, res in enumerate(ep_ranks[n]):
        assert res["n"] == n and res["in_scope"]
        assert res["w1_local_shape"] == [R.MOE_E // n, R.MOE_H, R.MOE_F]
        for k, v in (("gate_weight", "gw"), ("w1", "w1"), ("b1", "b1"),
                     ("w2", "w2"), ("b2", "b2")):
            np.testing.assert_array_equal(res["full"][k], a[f"moe_{v}"])
        np.testing.assert_array_equal(
            res["alltoall"], [j * 10.0 + r for j in range(n)])
        np.testing.assert_array_equal(res["alltoall_tensor"].ravel(),
                                      res["alltoall"])
        assert res["alltoall_bytes"] == n * 4
        np.testing.assert_array_equal(res["alltoall_grad"],
                                      np.full((n, 1), float(r)))
        for t, got in zip((R.MOE_T, n * R.MOE_T), res["a2a_bytes"]):
            cap = max(1, math.ceil(t * R.MOE_K / R.MOE_E * R.MOE_CF))
            assert got == 2 * R.MOE_E * cap * R.MOE_H * 4


def test_fleet_mode_matches_jax_build_train_step(tmp_path_factory):
    """JAX's tests/test_moe.py:87 net under ``fleet.build_train_step`` at
    dp = 2 x mp = 2 (GSPMD shards the experts over mp) against the
    port's on four gloo ranks (each mp rank holds 2 of the 4 experts)."""
    from test_torch_pipeline import pipe_job

    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import topology as JT
    from paddle_tpu.optimizer import SGD

    ranks = [r["moe_fleet"] for r in pipe_job(tmp_path_factory)]
    a = R.moe_inputs()

    class Net(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = JMoELayer(hidden_size=8, intermediate_size=16,
                                 num_experts=4, k=2, capacity_factor=4.0,
                                 ep_axis="mp")
            self.head = jnn.Linear(8, 4)

        def forward(self, x):
            return self.head(self.moe(x))

    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                         "sp_degree": 1, "sharding_degree": 1}
    try:
        jfleet.init(strategy=st)
        model = Net()
        for name, p in model.named_parameters():
            p.set_value(a[f"moef.{name}"])
        step = jfleet.build_train_step(
            model, lambda m, x, y: ((m(x) - y) ** 2).mean(),
            SGD(learning_rate=0.01, parameters=model.parameters()))
        losses = [float(np.asarray(step(paddle.to_tensor(a["moef_x"][t]),
                                        paddle.to_tensor(a["moef_y"][t]))
                                   .numpy()))
                  for t in range(R.MOE_FLEET_STEPS)]
        params = {n: np.asarray(p.numpy())
                  for n, p in model.named_parameters()}
    finally:
        JT.set_hybrid_communicate_group(None)
    for res in ranks:
        assert res["missing"] == [] and res["w1_local_shape"] == [2, 8, 16]
        np.testing.assert_allclose(res["losses"], losses, rtol=FLEET_TOL,
                                   atol=FLEET_TOL)
        for n, v in params.items():
            np.testing.assert_allclose(res["params"][n], v, rtol=FLEET_TOL,
                                       atol=FLEET_TOL, err_msg=n)
