"""The port's ZeRO against the JAX package: the TINY GPT's
``ShardedTrainStep`` at stages 0-3 and stage 1 with offload on two
data-parallel gloo ranks, through ``fleet`` (``strategy.sharding``),
with a global-norm clip (against JAX's ``ShardedTrainStep`` at the same
stage on a dp = 2 mesh, as the plain stages are) and with Lamb (against
the port's data-parallel Lamb step); each rank's bytes at rest;
``DygraphShardingOptimizer`` in the dygraph loop.

One job of two ranks (`tests/torch_hybrid_runner.py:zero_worker`),
started once a session.  Tolerances: losses 1e-5 relative / 1e-6
absolute and parameters 1e-5 (AdamW's normalized step, as in
test_torch_tensor_parallel.py); the port's stages against its own stage
0 to 1e-6 (the same update, element by element); at-rest bytes at most
1/dp of the whole plus the padding and the per-piece scalar slots.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed import topology as JT
from paddle_tpu.distributed.fleet.sharded_step import \
    ShardedTrainStep as JShardedTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_runner as R  # noqa: E402
from torch_hybrid_common import shared_run  # noqa: E402

TOL = 1e-5
DP = 2


def _np(t):
    return np.asarray(t.numpy())


@pytest.fixture(scope="module")
def zero(tmp_path_factory):
    return shared_run(tmp_path_factory, "zero", R.zero_worker, DP,
                      lambda out: np.savez(out + ".npz", none=np.zeros(1)))


def _jax_run(stage, opt_fn):
    from paddle_tpu_torch.models.gpt import GPT as TGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

    JT.set_hybrid_communicate_group(None)
    tm = TGPT.random(TGPTConfig(**R.GPT_DENSE_CFG), seed=R.GPT_SEED,
                     device="cpu")
    m = JGPT(JGPTConfig(**R.GPT_DENSE_CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    step = JShardedTrainStep(m, jax_gpt_loss_fn, opt_fn(m.parameters()),
                             JT.build_mesh(dp=DP), zero_stage=stage,
                             donate=False)
    losses = [float(_np(step(paddle.to_tensor(x), paddle.to_tensor(y))))
              for x, y in R.gpt_batches()]
    return losses, {k: _np(p) for k, p in m.named_parameters()}


_ADAMW = lambda ps: JO.AdamW(R.LR, parameters=ps, weight_decay=0.01)  # noqa


@pytest.fixture(scope="module")
def jax_stage1():
    return _jax_run(1, _ADAMW)


def _check(run, want, ptol=TOL):
    losses, params = want
    np.testing.assert_allclose(run["losses"], losses, rtol=TOL, atol=1e-6)
    for k, v in params.items():
        np.testing.assert_allclose(run["params"][k], v, rtol=TOL, atol=ptol,
                                   err_msg=k)


@pytest.mark.parametrize("label", ["stage0", "stage1", "stage2",
                                   "stage1_offload", "fleet_stage2"])
def test_zero_stages_match_jax(zero, jax_stage1, label):
    for res in zero:
        _check(res["runs"][label], jax_stage1)
    if label == "fleet_stage2":
        assert zero[0]["runs"][label]["stage"] == 2


def test_zero3_matches_jax_stage3(zero):
    want = _jax_run(3, _ADAMW)
    for res in zero:
        _check(res["runs"]["stage3"], want)


@pytest.mark.parametrize("label", ["stage1", "stage2", "stage3",
                                   "stage1_offload", "fleet_stage2"])
def test_zero_stages_equal_port_data_parallel(zero, label):
    base = zero[0]["runs"]["stage0"]
    for res in zero:
        run = res["runs"][label]
        np.testing.assert_allclose(run["losses"], base["losses"],
                                   rtol=1e-6, atol=1e-7)
        for k, v in base["params"].items():
            np.testing.assert_allclose(run["params"][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_zero_clip_matches_jax_and_lamb_keeps_whole_parameters(zero):
    """A global-norm clip over ranges (stage 2) against JAX's clipped
    stage 1; Lamb, whose trust ratio reads whole-parameter norms, at
    stage 1 (ranges cut at parameter boundaries) against the port's
    data-parallel Lamb step, update for update."""
    clip = _jax_run(1, lambda ps: JO.AdamW(
        R.LR, parameters=ps, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5)))
    for res in zero:
        _check(res["runs"]["stage2_clip"], clip)
        _check(res["runs"]["stage0_clip"], clip)
        lamb, base = res["runs"]["stage1_lamb"], res["runs"]["stage0_lamb"]
        np.testing.assert_allclose(lamb["losses"], base["losses"],
                                   rtol=1e-6, atol=1e-7)
        for k, v in base["params"].items():
            np.testing.assert_allclose(lamb["params"][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_at_rest_bytes_are_a_dp_share(zero):
    for res in zero:
        runs = res["runs"]
        whole = runs["stage0"]["at_rest"]["params"]
        n_params = len(runs["stage0"]["params"])
        # AdamW: two moments of the parameter's size and two scalars
        full_slots = runs["stage0"]["at_rest"]["slots"]
        assert full_slots == 2 * whole + 8 * n_params
        pad = 4 * DP * 2 * (n_params + 1)
        scalars = 8 * 2 * (n_params + 1)
        for label in ("stage1", "stage2", "stage3"):
            rest = runs[label]["at_rest"]
            assert rest["slots"] <= 2 * whole / DP + pad + scalars, label
            assert rest["host_slots"] == 0
        assert runs["stage1"]["at_rest"]["params"] == whole
        assert runs["stage3"]["at_rest"]["params"] <= whole / DP + pad
        off = runs["stage1_offload"]["at_rest"]
        assert off["slots"] == 0
        assert off["host_slots"] == runs["stage1"]["at_rest"]["slots"]


def test_dygraph_sharding_optimizer(zero, jax_stage1):
    for r, res in enumerate(zero):
        runs = res["runs"]
        plain, sharded = runs["dygraph_plain"], runs["dygraph_sharded"]
        np.testing.assert_allclose(sharded["losses"], plain["losses"],
                                   rtol=1e-6, atol=1e-7)
        for k, v in plain["params"].items():
            np.testing.assert_allclose(sharded["params"][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        _check(sharded, jax_stage1)
        whole = runs["stage0"]["at_rest"]["params"]
        assert sharded["slot_bytes"] <= 2 * whole / DP + 4096
        assert res["sharding_world"] == DP
        assert res["mode"] == "sharding_parallel"
        assert res["sharding_reduced"] == [1.5, 1.5]
