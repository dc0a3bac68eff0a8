"""paddle_tpu_torch.distributed against the JAX package, two gloo ranks
on the CPU.

Ranks are processes (`spawn`, `launch`) running the programs of
tests/torch_dist_dp_runner.py with ``PADDLE_DEVICE=cpu``; the JAX side
runs here, in one process.  The collectives against numpy (and, at
world size 1, against the JAX package's identity path); the tiny GPT's
dygraph loop through ``DataParallel`` (2 ranks x batch 4, 3 AdamW steps)
against the JAX package's single-process ``TrainStep`` on batch 8 from
the same weights; ``fleet``'s round trip and gradient merge (``k_steps=2``)
against the JAX ``ShardedTrainStep(grad_accum=2)``; recompute; the
launcher; a dead rank.  Tolerances: f32 losses 1e-5 and parameters 1e-5
(the same arithmetic in another summation order: the batch's mean is
taken as the mean of two rank means).
"""
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import distributed as JD
from paddle_tpu import jit as JJ
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed.fleet.sharded_step import \
    ShardedTrainStep as JShardedTrainStep
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu_torch import distributed as TD
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.distributed import parallel as TP
from paddle_tpu_torch.distributed.fleet.sharded_step import \
    ShardedTrainStep
from paddle_tpu_torch.distributed.spawn import SpawnError, free_port
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_loss_fn
from paddle_tpu_torch.parallel import mesh as TM

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_dp_runner as R  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
# a dead rank must make the others raise well inside this
DEAD_RANK_BOUND_S = 30.0


@pytest.fixture
def cpu_ranks(monkeypatch):
    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _spawn(fn, tmp_path, nprocs=2):
    out = str(tmp_path / fn.__name__)
    TD.spawn(fn, args=(out,), nprocs=nprocs)
    return [json.load(open(f"{out}.{r}")) for r in range(nprocs)]


def _jax_gpt(seed):
    """The JAX GPT with the port's ``GPT.random(seed)`` weights."""
    tm = TGPT.random(TGPTConfig(**R.GPT_CFG), seed=seed, device="cpu")
    m = GPT(GPTConfig(**R.GPT_CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m


def _jax_params(m):
    return {k: np.asarray(p.numpy()) for k, p in m.named_parameters()}


def _check_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), want[k],
                                   atol=PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def test_collectives_two_ranks_against_numpy(cpu_ranks, tmp_path):
    res = _spawn(R.collectives_worker, tmp_path)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    mine = [base * (r + 1) + r for r in range(2)]
    want = {"sum": mine[0] + mine[1], "max": np.maximum(*mine),
            "min": np.minimum(*mine), "prod": mine[0] * mine[1],
            "avg": (mine[0] + mine[1]) / 2}
    for r, got in enumerate(res):
        assert got["rank"] == r and got["world"] == 2
        for op, w in want.items():
            np.testing.assert_allclose(got[f"all_reduce_{op}"], w, rtol=0)
            assert got[f"all_reduce_{op}_same_object"]
        np.testing.assert_allclose(got["reduce"], want["sum"])
        np.testing.assert_allclose(got["all_gather"], mine)
        np.testing.assert_allclose(got["all_gather_stacked"], mine)
        assert got["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        np.testing.assert_allclose(got["broadcast"], mine[1])
        np.testing.assert_allclose(got["reduce_scatter"],
                                   [0 + 1 + 20 * r] * 3)
        full = np.arange(4) * 2 + 1
        np.testing.assert_allclose(got["reduce_scatter_chunk"],
                                   full[2 * r:2 * r + 2])
        np.testing.assert_allclose(got["scatter"], [float(r)] * 3)
        np.testing.assert_allclose(got["alltoall"],
                                   [[float(r)] * 2, [10.0 + r] * 2])
        np.testing.assert_allclose(got["alltoall_cat"],
                                   [r, r, 10 + r, 10 + r])
        np.testing.assert_allclose(got["p2p"], [7.0, 8.0] if r == 1 else
                                   [14.0, 16.0])
        assert got["group_sum"] == 3.0
        assert got["group_rank_nranks"] == [r, 2]


def test_world_size_one_is_jax_identity():
    """No process group: every collective is the JAX package's
    single-controller identity path."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jt, tt = paddle.to_tensor(x), torch.from_numpy(x.copy())
    for op in ("sum", "max", "min", "prod", "avg"):
        want = np.asarray(JD.all_reduce(jt, op=op).numpy())
        assert TD.all_reduce(tt, op=op) is tt
        np.testing.assert_array_equal(tt.numpy(), want)
    for fn in (JD.broadcast, JD.reduce):
        np.testing.assert_array_equal(np.asarray(fn(jt).numpy()), x)
    assert TD.broadcast(tt) is tt and TD.reduce(tt) is tt
    jl, tl = [], []
    JD.all_gather(jl, jt)
    TD.all_gather(tl, tt)
    assert len(jl) == len(tl) == 1
    jo, to = [], []
    JD.all_gather_object(jo, {"a": 1})
    TD.all_gather_object(to, {"a": 1})
    assert jo == to
    parts = [x[:1], x[1:]]
    jc = JD.alltoall([paddle.to_tensor(p) for p in parts], [])
    tc = TD.alltoall([torch.from_numpy(p) for p in parts], [])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc.numpy()))
    js = JD.scatter(jt, [paddle.to_tensor(p) for p in parts])
    ts = TD.scatter(tt, [torch.from_numpy(p) for p in parts])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    assert TD.reduce_scatter(tt) is tt
    assert TD.send(tt) is tt and TD.recv(tt) is tt
    assert TD.isend(tt).wait() and TD.irecv(tt).wait()
    TD.barrier()
    assert TD.get_world_size() == JD.get_world_size() == 1
    assert TD.get_rank() == JD.get_rank() == 0
    # split builds a tensor-parallel layer of one rank: the dense layer
    out = TD.split(tt, (3, 4), "linear", axis=1)
    JD.split(jt, (3, 4), "linear", axis=1)
    tl, jl = TD.split.last_layer, JD.split.last_layer
    jl.weight.set_value(tl.weight.detach().numpy())
    jl.bias.set_value(tl.bias.detach().numpy())
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jl(jt).numpy()), atol=1e-6)


def test_device_and_backend_rule(monkeypatch):
    """No card and no CPU request raises; the backend rule (shared with
    the serving mesh); a backend that fails to start raises, with no
    fallback to gloo."""
    monkeypatch.delenv("PADDLE_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP._rank_device(0, None)
    assert TP._rank_device(0, "cpu") == torch.device("cpu")
    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    assert TP._rank_device(1, None) == torch.device("cpu")
    assert TM.choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert TM.choose_backend(torch.device("cuda", 0), 2) == "nccl"
    assert TM.choose_backend(torch.device("cuda", 0), 3) == "gloo"

    import torch.distributed as dist

    def refuse(backend, **kw):
        raise RuntimeError(f"{backend} failed to start")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(TP, "_STATE", dict(initialized=False, device=None,
                                           backend=None))
    with pytest.raises(RuntimeError, match="gloo failed to start"):
        TP.init_parallel_env(coordinator_address="127.0.0.1:1",
                             num_processes=2, process_id=0, device="cpu")
    assert not TP.is_initialized()


# ---------------------------------------------------------------------------
# DataParallel, fleet, gradient merge
# ---------------------------------------------------------------------------
def test_data_parallel_gpt_matches_jax_train_step(cpu_ranks, tmp_path):
    """2 ranks x batch 4 through ``DataParallel`` against the JAX
    ``TrainStep`` on batch 8, 3 AdamW steps from the same weights: losses
    within 1e-5, final parameters within 1e-5, equal on both ranks; the
    broadcast at construction replaced rank 1's other weights; the
    gradients went out in several buckets; ``fused_allreduce_gradients``
    after the backward changed nothing."""
    res = _spawn(R.dp_gpt_worker, tmp_path)
    m = _jax_gpt(seed=1)
    step = JJ.train_step(m, jax_gpt_loss_fn,
                         JO.AdamW(learning_rate=R.LR,
                                  parameters=m.parameters(),
                                  weight_decay=0.01))
    want = [float(np.asarray(step(paddle.to_tensor(x),
                                  paddle.to_tensor(y))._array))
            for x, y in R.gpt_batches()]
    for got in res:
        np.testing.assert_allclose(got["losses"], want, atol=LOSS_TOL)
        _check_params(got["params"], _jax_params(m))
        assert all(got["unchanged_by_fused"])
        assert got["buckets"] > 2
        assert got["stats"]["backwards"] == R.GPT_STEPS
        assert got["stats"]["buckets"] == got["buckets"] * R.GPT_STEPS
        nparams = sum(int(np.prod(np.shape(v)))
                      for v in got["params"].values())
        assert got["stats"]["bytes"] == 4 * nparams * R.GPT_STEPS
    assert res[0]["params"] == res[1]["params"]


def test_fleet_round_trip_and_gradient_merge_match_jax(cpu_ranks, tmp_path):
    """``fleet.init`` with ``gradient_merge`` (``k_steps=2``) on 2 ranks:
    the round-trip queries, the meta-optimizer, ``DataParallel``, and
    ``build_train_step`` on the global batch 8 against the JAX
    ``ShardedTrainStep(grad_accum=2)`` over ``dp=2`` from the same
    weights (1e-5); ``fused_allreduce_gradients`` of a plain model
    averages once per call."""
    res = _spawn(R.fleet_worker, tmp_path)
    m = _jax_gpt(seed=1)
    mesh = JD.build_mesh(dp=2, devices=jax.devices()[:2])
    step = JShardedTrainStep(m, jax_gpt_loss_fn,
                             JO.AdamW(learning_rate=R.LR,
                                      parameters=m.parameters(),
                                      weight_decay=0.01),
                             mesh, grad_accum=2, donate=False)
    want = [float(np.asarray(step(paddle.to_tensor(x),
                                  paddle.to_tensor(y))._array))
            for x, y in R.gpt_batches()]
    for r, got in enumerate(res):
        assert got["worker_num"] == 2 and got["first"] == (r == 0)
        assert got["dp_world"] == 2 and got["mode"] == "data_parallel"
        assert got["merge_wrapped"] and got["dp_type"] == "DataParallel"
        np.testing.assert_allclose(got["losses"], want, atol=LOSS_TOL)
        _check_params(got["params"], _jax_params(m))
        assert got["fused_grads"] == [1.5, 1.5, 1.5, 1.5]


def test_unported_strategies_raise(monkeypatch):
    """What the port still refuses: expert parallelism and the parameter
    server (ROADMAP.md Queue 1, item 2).  The hybrid degrees, ZeRO and
    the pipeline build; a degree that does not fit the world is an
    error, not a refusal."""
    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    from paddle_tpu_torch.distributed import fleet

    for attr, value, match in (
            ("expert_parallel", True, "moe_layer"),
            ("a_sync", True, "distributed/ps")):
        st = fleet.DistributedStrategy()
        setattr(st, attr, value)
        with pytest.raises(NotImplementedError, match=match):
            fleet.init(is_collective=True, strategy=st)
    with pytest.raises(NotImplementedError, match="distributed/ps"):
        fleet.init(is_collective=False)
    with pytest.raises(NotImplementedError, match="distributed/ps"):
        fleet.fleet.init_server()
    with pytest.raises(ValueError, match="zero_stage"):
        ShardedTrainStep(torch.nn.Linear(2, 2), None, None, zero_stage=4)
    with pytest.raises(ValueError, match="world size 1"):
        TD.HybridCommunicateGroup(mp=2)
    hcg = TD.HybridCommunicateGroup()
    assert hcg.get_parallel_mode() == "data_parallel"
    assert hcg.is_first_stage() and hcg.is_last_stage()
    topo = TD.build_mesh(dp=2, mp=2)
    assert topo.shape == {"dp": 2, "pp": 1, "sp": 1, "mp": 2}
    assert topo.get_comm_list("mp") == [[0, 1], [2, 3]]


def _count_saved(fn):
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


@pytest.mark.parametrize("dropout,bf16", [(0.0, False), (0.1, False),
                                          (0.0, True)])
def test_recompute_numerics_and_saved_tensors(dropout, bf16):
    """The data-parallel step (world size 1) with ``recompute`` against
    without, 2 AdamW steps from the same weights and seed: bit-equal
    losses and parameters (the replay restores the dropout generators and
    the forward's ``auto_cast``), and fewer tensors saved for the
    backward."""
    from paddle_tpu_torch import amp

    def loss_fn(m, x, y):
        with amp.auto_cast(enable=bf16, dtype="bfloat16"):
            return gpt_loss_fn(m, x, y)

    cfg = dict(R.GPT_CFG, dropout=dropout, use_parallel_layers=True)
    x, y = R.gpt_batches()[0]
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    runs = {}
    for rc in (False, True):
        import paddle_tpu_torch as P

        m = TGPT.random(TGPTConfig(**cfg), seed=1, device="cpu")
        step = ShardedTrainStep(m, loss_fn,
                                TO.AdamW(R.LR, parameters=m.parameters()),
                                recompute=rc)
        P.seed(5)
        losses, saved = [], []
        for _ in range(2):
            loss, n = _count_saved(lambda: step(x, y))
            losses.append(float(loss))
            saved.append(n)
        runs[rc] = (losses, [p.detach().clone() for p in m.parameters()],
                    saved)
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                  runs[False][1]))
    assert runs[True][2][0] < runs[False][2][0]


# ---------------------------------------------------------------------------
# launch, failures
# ---------------------------------------------------------------------------
def test_launch_two_ranks_matches_single_process(cpu_ranks, tmp_path):
    """``launch --nproc_per_node 2`` of the MLP runner: both ranks see
    the same global losses, equal to one process on the whole batch."""
    from paddle_tpu_torch.distributed.launch import launch

    runner = os.path.join(REPO, "tests", "torch_dist_dp_runner.py")
    codes = launch(runner, [str(tmp_path / "out.pkl")], nproc_per_node=2,
                   start_port=free_port(), log_dir=str(tmp_path / "logs"),
                   env_extra={"PADDLE_DEVICE": "cpu", "OMP_NUM_THREADS": "1"})
    assert codes == [0, 0], "\n".join(
        open(tmp_path / "logs" / f).read()[-2000:]
        for f in sorted(os.listdir(tmp_path / "logs")))
    res = {}
    for r in range(2):
        with open(tmp_path / f"out.pkl.rank{r}", "rb") as f:
            res[r] = pickle.load(f)
    assert res[0]["world"] == 2
    np.testing.assert_allclose(res[0]["losses"], res[1]["losses"], rtol=0)
    model = R.build_mlp()
    opt = TO.SGD(learning_rate=0.1, parameters=model.parameters())
    single = []
    for x, y in R.batches():
        loss = torch.nn.functional.mse_loss(model(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        opt.clear_grad()
        loss.backward()
        opt.step()
        single.append(float(loss.detach()))
    np.testing.assert_allclose(res[0]["losses"], single, rtol=1e-4,
                               atol=1e-5)


def test_dead_rank_makes_the_others_raise(cpu_ranks, tmp_path):
    """Rank 1 exits after start-up: rank 0's all-reduce raises within
    `DEAD_RANK_BOUND_S` instead of hanging.  And ``spawn`` with a rank
    that raises terminates the other and raises `SpawnError`."""
    out = str(tmp_path / "dead")
    procs = TD.spawn(R.dead_rank_worker, args=(out,), nprocs=2, join=False)
    deadline = time.monotonic() + 3 * DEAD_RANK_BOUND_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        p.kill()
    assert not any(alive)
    assert [p.exitcode for p in procs] == [0, 3]
    got = json.load(open(f"{out}.0"))
    assert got["error"] is not None
    assert got["seconds"] < DEAD_RANK_BOUND_S

    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="rank 1 of 2"):
        TD.spawn(R.failing_worker, args=(str(tmp_path / "fail"),), nprocs=2)
    assert time.monotonic() - t0 < 45
