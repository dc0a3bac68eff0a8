"""The port's tensor parallelism against the JAX package: mp_layers,
``distributed.split``, the TP MLP at mp = 2 and at dp = 2 x mp = 2
(against JAX's ``ShardedTrainStep``), the TINY GPT at mp = 2 (against
JAX's single-device ``TrainStep``), and the weights crossing both ways.

Ranks are gloo processes on the CPU (`tests/torch_hybrid_runner.py`):
a job of 2 ranks, and the dp = 2 x mp = 2 checks ride on
test_torch_pipeline.py's job of 4, each started once per test session
(`torch_hybrid_common.shared_run`); a rank that dies makes the other's
next subgroup all-reduce raise within 30 s.  Tolerances: the layers and the MLP
f32 1e-5 (the same products, summed in another order across ranks);
the GPT's losses 1e-5 relative / 1e-6 absolute and its parameters after
AdamW 1e-5 relative / 1e-5 absolute (AdamW's normalized step turns a
1e-9 difference in a near-zero gradient into ~1e-6); saved and restored
weights bit for bit.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed import topology as JT
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu.distributed.fleet.sharded_step import \
    ShardedTrainStep as JShardedTrainStep
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_runner as R  # noqa: E402
from torch_hybrid_common import shared_run  # noqa: E402

TOL = 1e-5


def _np(t):
    return np.asarray(t.numpy())


def _inputs():
    rng = np.random.RandomState(0)
    f = np.float32
    a = {"col_w": rng.randn(8, 16).astype(f), "col_b": rng.randn(16).astype(f),
         "row_w": rng.randn(16, 8).astype(f), "row_b": rng.randn(8).astype(f),
         "x": rng.randn(4, 8).astype(f), "x16": rng.randn(4, 16).astype(f),
         "emb_w": rng.randn(16, 8).astype(f),
         "ids": rng.randint(0, 16, (3, 5)).astype(np.int64),
         "logits": rng.randn(6, 16).astype(f),
         "labels": rng.randint(0, 16, (6,)).astype(np.int64)}
    rng = np.random.RandomState(31)
    a.update(mlp_w0=(rng.randn(8, 32) * 0.3).astype(f),
             mlp_b0=(rng.randn(32) * 0.1).astype(f),
             mlp_w1=(rng.randn(32, 4) * 0.3).astype(f),
             mlp_b1=(rng.randn(4) * 0.1).astype(f))
    rng = np.random.RandomState(9)
    a.update(mlp_x=rng.rand(16, 8).astype(f), mlp_y=rng.rand(16, 4).astype(f))
    return a


def _jax_gpt(seed):
    """The JAX GPT (parallel layers) over the port's ``GPT.random(seed)``
    weights."""
    from paddle_tpu_torch.models.gpt import GPT as TGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

    tm = TGPT.random(TGPTConfig(**R.GPT_DENSE_CFG), seed=seed, device="cpu")
    m = JGPT(JGPTConfig(**R.GPT_CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m


def _prepare_tp(out):
    a = _inputs()
    np.savez(out + ".npz", **a)
    paddle.save(_jax_gpt(R.GPT_SEED + 10).state_dict(), out + ".jax.pdparams")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return shared_run(tmp_path_factory, "tp", R.tp_worker, 2, _prepare_tp)


@pytest.fixture(scope="module")
def dpmp(tmp_path_factory):
    from test_torch_pipeline import pipe_job

    return [res["dpmp"] for res in pipe_job(tmp_path_factory)]


def _no_jax_hcg():
    JT.set_hybrid_communicate_group(None)


def test_hybrid_group_queries(tp, dpmp):
    for r, res in enumerate(tp):
        assert res["mp_rank"] == r and res["mp_world"] == 2
        assert res["mode"] == "tensor_parallel" and res["mp_ranks"] == [0, 1]
    want = {0: [0, 0], 1: [0, 1], 2: [1, 0], 3: [1, 1]}
    for g, res in enumerate(dpmp):
        assert res["coords"] == want[g]
        assert res["dp_ranks"] == [g % 2, g % 2 + 2]
        assert res["mp_ranks"] == [g - g % 2, g - g % 2 + 1]
        assert res["mode"] == "tensor_parallel"
        # averaged over the dp group only: ranks g and g + 2
        assert res["fused"] == [float(g % 2 + 2)] * 2


def test_parallel_linears_match_jax_layers(tp):
    a = _inputs()
    _no_jax_hcg()
    col = ColumnParallelLinear(8, 16, gather_output=False)
    row = RowParallelLinear(16, 8, input_is_parallel=True)
    col.weight.set_value(a["col_w"]), col.bias.set_value(a["col_b"])
    row.weight.set_value(a["row_w"]), row.bias.set_value(a["row_b"])
    x = paddle.to_tensor(a["x"], stop_gradient=False)
    y = row(col(x))
    (y * y).sum().backward()
    want_grads = {"col_weight": col.weight.grad, "col_bias": col.bias.grad,
                  "row_weight": row.weight.grad, "row_bias": row.bias.grad}
    gcol = ColumnParallelLinear(8, 16, gather_output=True)
    gcol.weight.set_value(a["col_w"]), gcol.bias.set_value(a["col_b"])
    srow = RowParallelLinear(16, 8, input_is_parallel=False)
    srow.weight.set_value(a["row_w"]), srow.bias.set_value(a["row_b"])
    for res in tp:
        np.testing.assert_allclose(res["layers_out"], _np(y), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res["layers_x_grad"], _np(x.grad),
                                   atol=1e-4, rtol=TOL)
        for k, g in want_grads.items():
            np.testing.assert_allclose(res["layers_grads"][k], _np(g),
                                       atol=1e-4, rtol=TOL, err_msg=k)
        assert res["layers_specs"]["col_weight"] == (None, "mp")
        assert res["layers_specs"]["row_weight"] == ("mp", None)
        assert res["layers_specs"]["row_bias"] == ()
        np.testing.assert_allclose(
            res["gather_output"], _np(gcol(paddle.to_tensor(a["x"]))),
            atol=TOL, rtol=TOL)
        np.testing.assert_allclose(
            res["split_input"], _np(srow(paddle.to_tensor(a["x16"]))),
            atol=TOL, rtol=TOL)


def test_vocab_embedding_and_parallel_cross_entropy(tp):
    a = _inputs()
    _no_jax_hcg()
    emb = VocabParallelEmbedding(16, 8)
    emb.weight.set_value(a["emb_w"])
    want_emb = _np(emb(paddle.to_tensor(a["ids"])))
    logits = paddle.to_tensor(a["logits"], stop_gradient=False)
    ce = ParallelCrossEntropy()(logits, paddle.to_tensor(a["labels"]))
    ce.sum().backward()
    ce_ign = ParallelCrossEntropy(ignore_index=3)(
        paddle.to_tensor(a["logits"]), paddle.to_tensor(a["labels"]))
    for res in tp:
        np.testing.assert_allclose(res["embedding"], want_emb, atol=0)
        np.testing.assert_allclose(res["parallel_ce"],
                                   _np(ce).reshape(-1), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res["parallel_ce_grad"], _np(logits.grad),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res["parallel_ce_ignore"],
                                   _np(ce_ign).reshape(-1), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("key", ["linear1", "linear0", "embedding"])
def test_split_builds_jax_layers(tp, key):
    """``split`` on each rank: the output equals the JAX layer's over the
    whole weights the ranks' blocks gather into."""
    a = _inputs()
    _no_jax_hcg()
    st = tp[0]["split"][key]["state"]
    if key == "linear1":
        layer = ColumnParallelLinear(8, 16, gather_output=True)
    elif key == "linear0":
        layer = RowParallelLinear(8, 16)
    else:
        layer = VocabParallelEmbedding(16, 8)
    for name, p in layer.named_parameters():
        p.set_value(st[name])
    inp = a["ids"] if key == "embedding" else a["x"]
    want = _np(layer(paddle.to_tensor(inp)))
    for res in tp:
        np.testing.assert_allclose(res["split"][key]["out"], want,
                                   atol=TOL, rtol=TOL)
        for name in st:
            np.testing.assert_array_equal(res["split"][key]["state"][name],
                                          st[name])
    assert "must equal the mesh mp degree 2" in tp[0]["split_bad_partitions"]


def _jax_tp_mlp(mesh_dp, mesh_mp):
    a = _inputs()
    net = jnn.Sequential(ColumnParallelLinear(8, 32, gather_output=False),
                         jnn.Tanh(),
                         RowParallelLinear(32, 4, input_is_parallel=True))
    for name, key in (("0.weight", "mlp_w0"), ("0.bias", "mlp_b0"),
                      ("2.weight", "mlp_w1"), ("2.bias", "mlp_b1")):
        dict(net.named_parameters())[name].set_value(a[key])
    mesh = JT.build_mesh(dp=mesh_dp, mp=mesh_mp)
    JT.set_hybrid_communicate_group(JT.HybridCommunicateGroup(mesh=mesh))
    try:
        step = JShardedTrainStep(
            net, lambda m, x, y: jnn.MSELoss()(m(x), y),
            JO.SGD(0.1, parameters=net.parameters()), mesh, donate=False)
        x, y = paddle.to_tensor(a["mlp_x"]), paddle.to_tensor(a["mlp_y"])
        losses = [float(_np(step(x, y))) for _ in range(3)]
    finally:
        _no_jax_hcg()
    return losses, {k: _np(p) for k, p in net.named_parameters()}


@pytest.mark.parametrize("layout", ["mp2", "dp2_mp2"])
def test_tp_mlp_training_matches_jax_sharded_step(tp, dpmp, layout):
    ranks = tp if layout == "mp2" else dpmp
    losses, params = _jax_tp_mlp(*((1, 2) if layout == "mp2" else (2, 2)))
    for res in ranks:
        np.testing.assert_allclose(res["mlp_losses"], losses, atol=TOL,
                                   rtol=TOL)
        for k, v in params.items():
            np.testing.assert_allclose(res["mlp_params"][k], v, atol=TOL,
                                       rtol=TOL, err_msg=k)


@pytest.mark.parametrize("stage", [2, 3])
def test_tp_mlp_under_zero_matches_jax(dpmp, stage):
    """dp = 2 x mp = 2 with ZeRO over the dp axis: each rank's ranges of
    its tensor-parallel blocks, the same steps as JAX's."""
    losses, params = _jax_tp_mlp(2, 2)
    for res in dpmp:
        got_losses, got_params = res["mlp_zero"][stage]
        np.testing.assert_allclose(got_losses, losses, atol=TOL, rtol=TOL)
        for k, v in params.items():
            np.testing.assert_allclose(got_params[k], v, atol=TOL, rtol=TOL,
                                       err_msg=k)


@pytest.fixture(scope="module")
def jax_gpt_run():
    _no_jax_hcg()
    m = _jax_gpt(R.GPT_SEED)
    opt = JO.AdamW(R.LR, parameters=m.parameters(), weight_decay=0.01)
    step = JTrainStep(m, jax_gpt_loss_fn, opt)
    losses = [float(_np(step(paddle.to_tensor(x), paddle.to_tensor(y))))
              for x, y in R.gpt_batches()]
    return losses, {k: _np(p) for k, p in m.named_parameters()}


def test_gpt_mp2_train_step_matches_jax(tp, jax_gpt_run):
    losses, params = jax_gpt_run
    for res in tp:
        assert res["gpt_heads_local"] == 1
        assert res["gpt_qkv_shape"] == [32, 48]  # q, k, v of one head
        assert res["gpt_full_logits_shape"] == [R.GPT_BATCH, 16, 64]
        np.testing.assert_allclose(res["gpt_step_losses"], losses,
                                   rtol=TOL, atol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(res["gpt_step_params"][k], v,
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_gpt_mp2_dygraph_loop_matches_jax(tp, jax_gpt_run):
    losses, _ = jax_gpt_run
    for res in tp:
        assert res["gpt_wrapper"] == "TensorParallel"
        np.testing.assert_allclose(res["gpt_dygraph_losses"], losses,
                                   rtol=TOL, atol=1e-6)


def test_gathered_save_loads_in_jax_bit_for_bit(tp):
    got = paddle.load(tp[0]["gpt_saved"])
    want = tp[0]["gpt_step_params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(got[k]), v, err_msg=k)
        np.testing.assert_array_equal(tp[1]["gpt_step_params"][k], v)


def test_jax_save_restores_into_shards(tp):
    """A JAX save cut into the ranks' blocks by the port's tensor-parallel
    rules (`gpt_tensor_parallel_rules`: qkv head-aligned, ``wte`` and fc2
    on their rows, norms whole), and the restored model's logits."""
    _no_jax_hcg()
    jm = _jax_gpt(R.GPT_SEED + 10)
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    x, _ = R.gpt_batches()[0]
    want_logits = _np(jm(paddle.to_tensor(x)))
    for r, res in enumerate(tp):
        assert res["restore_missing"] == []
        sh = res["restored_shards"]
        np.testing.assert_array_equal(
            sh["wte.weight"], state["wte.weight"][r * 32:(r + 1) * 32])
        qkv = state["blocks.0.qkv.weight"].reshape(32, 3, 2, 16)[:, :, r]
        np.testing.assert_array_equal(sh["blocks.0.qkv.weight"],
                                      qkv.reshape(32, 48))
        np.testing.assert_array_equal(
            sh["blocks.1.fc2.weight"],
            state["blocks.1.fc2.weight"][r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(sh["ln_f.weight"],
                                      state["ln_f.weight"])
        np.testing.assert_allclose(res["restored_logits"], want_logits,
                                   rtol=TOL, atol=1e-5)


def test_dead_rank_makes_the_subgroup_raise(monkeypatch, tmp_path):
    """A tensor-parallel rank that dies makes the other's next all-reduce
    over the mp subgroup raise within test_torch_distributed.py's bound
    (30 s), instead of hanging."""
    import json
    import time

    from paddle_tpu_torch import distributed as TD

    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "dead")
    procs = TD.spawn(R.dead_mp_rank_worker, args=(out,), nprocs=2,
                     join=False)
    deadline = time.monotonic() + 90
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        p.kill()
    assert not any(alive)
    assert [p.exitcode for p in procs] == [0, 3]
    got = json.load(open(f"{out}.0"))
    assert got["error"] is not None
    assert got["seconds"] < 30
