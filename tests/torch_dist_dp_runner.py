"""Rank programs of tests/test_torch_distributed.py, on the CPU over gloo
(the counterpart of tests/dist_dp_runner.py).

``python tests/torch_dist_dp_runner.py OUT`` is the script that
``paddle_tpu_torch.distributed.launch`` starts a rank: a small MLP
trained with SGD on the rank's shard of a fixed batch, its gradients
averaged with ``all_reduce(AVG)``, the global loss written to
``OUT.rank<r>``.  The module's other functions are `spawn` targets; each
writes its results as JSON to ``<out>.<rank>``.  Every rank runs on the
CPU (``PADDLE_DEVICE=cpu``) with one thread.
"""
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STEPS = 5
GLOBAL_BATCH = 8
FEAT = 16
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=16, use_parallel_layers=False, dropout=0.0)
GPT_BATCH = 8
GPT_STEPS = 3
LR = 1e-3


def build_mlp():
    torch.manual_seed(42)
    return torch.nn.Sequential(torch.nn.Linear(FEAT, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 1))


def batches():
    rng = np.random.default_rng(7)
    for _ in range(STEPS):
        x = rng.standard_normal((GLOBAL_BATCH, FEAT)).astype(np.float32)
        y = (x.sum(axis=1, keepdims=True) > 0).astype(np.float32)
        yield x, y


def gpt_batches():
    rng = np.random.RandomState(3)
    v, s = GPT_CFG["vocab_size"], GPT_CFG["max_seq_len"]
    return [(rng.randint(0, v, (GPT_BATCH, s)).astype(np.int64),
             rng.randint(0, v, (GPT_BATCH, s)).astype(np.int64))
            for _ in range(GPT_STEPS)]


def _setup():
    torch.set_num_threads(1)
    os.environ["PADDLE_DEVICE"] = "cpu"


def _dump(out, rank, res):
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


def _params(model):
    return {k: p.detach().numpy().tolist()
            for k, p in model.named_parameters()}


def main():
    """The launched rank: the MLP's DP run."""
    _setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    model = build_mlp()
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    losses = []
    shard = GLOBAL_BATCH // world
    for x, y in batches():
        xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
        ys = torch.from_numpy(y[rank * shard:(rank + 1) * shard])
        loss = torch.nn.functional.mse_loss(model(xs), ys)
        opt.clear_grad()
        loss.backward()
        for p in model.parameters():
            dist.all_reduce(p.grad, op=dist.ReduceOp.AVG)
        opt.step()
        gl = dist.all_reduce(loss.detach().clone(), op=dist.ReduceOp.AVG)
        losses.append(float(gl))
    with open(sys.argv[1] + f".rank{rank}", "wb") as f:
        pickle.dump({"rank": rank, "world": world, "losses": losses}, f)


def collectives_worker(out):
    """Every collective once, on values each rank can predict."""
    _setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    base = np.arange(6, dtype=np.float32).reshape(2, 3)

    def mine(rank):
        return base * (rank + 1) + rank

    res = {"rank": r, "world": n}
    for op in ("sum", "max", "min", "prod", "avg"):
        t = torch.from_numpy(mine(r))
        ret = dist.all_reduce(t, op=op)
        res[f"all_reduce_{op}"] = t.tolist()
        res[f"all_reduce_{op}_same_object"] = ret is t
    t = torch.from_numpy(mine(r))
    dist.reduce(t, dst=0)
    res["reduce"] = t.tolist()
    lst = []
    stacked = dist.all_gather(lst, torch.from_numpy(mine(r)))
    res["all_gather"] = [x.tolist() for x in lst]
    res["all_gather_stacked"] = stacked.tolist()
    objs = []
    dist.all_gather_object(objs, {"rank": r})
    res["all_gather_object"] = objs
    t = torch.from_numpy(mine(r))
    dist.broadcast(t, src=1)
    res["broadcast"] = t.tolist()
    outt = torch.zeros(3)
    dist.reduce_scatter(outt, [torch.full((3,), float(r + 10 * k))
                               for k in range(n)])
    res["reduce_scatter"] = outt.tolist()
    res["reduce_scatter_chunk"] = dist.reduce_scatter(
        torch.arange(4, dtype=torch.float32) + r).tolist()
    outt = torch.zeros(3)
    dist.scatter(outt, [torch.full((3,), float(k + 100 * r))
                        for k in range(n)], src=0)
    res["scatter"] = outt.tolist()
    got = []
    cat = dist.alltoall([torch.full((2,), float(10 * r + k))
                         for k in range(n)], got)
    res["alltoall"] = [x.tolist() for x in got]
    res["alltoall_cat"] = cat.tolist()
    buf = torch.zeros(2)
    if r == 0:
        dist.send(torch.tensor([7.0, 8.0]), dst=1)
        task = dist.irecv(buf, src=1)
        task.wait()
    else:
        dist.recv(buf, src=0)
        dist.isend(buf * 2, dst=0).wait()
    res["p2p"] = buf.tolist()
    g = dist.new_group([0, 1])
    t = torch.ones(1) * (r + 1)
    dist.all_reduce(t, group=g)
    res["group_sum"] = t.item()
    res["group_rank_nranks"] = [g.rank, g.nranks]
    dist.barrier()
    dist.wait(t)
    _dump(out, r, res)


def _gpt(seed):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    return GPT.random(GPTConfig(**GPT_CFG), seed=seed, device="cpu")


def dp_gpt_worker(out):
    """The dygraph loop of the tiny GPT through ``DataParallel``: batch
    ``GPT_BATCH / world`` a rank, AdamW; rank 1 starts from other weights
    that the broadcast at construction replaces.  Also: a script that
    calls ``fused_allreduce_gradients`` after the backward changes no
    gradient (each backward reduced once)."""
    _setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients
    from paddle_tpu_torch.models.gpt import gpt_loss_fn

    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    model = _gpt(seed=1 + r)
    dp = dist.DataParallel(model, comm_buffer_size=0.01,
                           last_comm_buffer_size=0.001)
    opt = optimizer.AdamW(LR, parameters=model.parameters(),
                          weight_decay=0.01)
    losses, unchanged = [], []
    s = GPT_BATCH // n
    for x, y in gpt_batches():
        loss = gpt_loss_fn(dp, torch.from_numpy(x[r * s:(r + 1) * s]),
                           torch.from_numpy(y[r * s:(r + 1) * s]))
        loss = dp.scale_loss(loss)
        loss.backward()
        dp.apply_collective_grads()
        before = [p.grad.clone() for p in model.parameters()]
        fused_allreduce_gradients(list(model.parameters()))
        unchanged.append(all(torch.equal(a, p.grad) for a, p in
                             zip(before, model.parameters())))
        opt.step()
        opt.clear_grad()
        gl = loss.detach().clone()
        dist.all_reduce(gl, op="avg")
        losses.append(float(gl))
    _dump(out, r, {"losses": losses, "params": _params(model),
                   "unchanged_by_fused": unchanged,
                   "stats": dp.reducer_stats,
                   "buckets": len(dp._reducer.buckets)})


def fleet_worker(out):
    """``fleet.init`` with gradient merge (``k_steps=2``), its
    round-trip queries, ``distributed_optimizer``/``distributed_model``,
    and `build_train_step` on the global batch for ``GPT_STEPS`` steps;
    then ``fused_allreduce_gradients`` on a plain model's gradients."""
    _setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients
    from paddle_tpu_torch.models.gpt import gpt_loss_fn

    st = fleet.DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.init(is_collective=True, strategy=st)
    r = fleet.worker_index()
    hcg = fleet.get_hybrid_communicate_group()
    model = _gpt(seed=1)
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(LR, parameters=model.parameters(),
                        weight_decay=0.01))
    dp = fleet.distributed_model(model)
    fleet.barrier_worker()
    step = fleet.build_train_step(dp, gpt_loss_fn, opt)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in gpt_batches()]
    plain = torch.nn.Linear(3, 2)
    for p in plain.parameters():
        p.grad = torch.full_like(p, float(r + 1))
    fused_allreduce_gradients(list(plain.parameters()), hcg)
    twice = [float(p.grad.flatten()[0]) for p in plain.parameters()]
    fused_allreduce_gradients(list(plain.parameters()), hcg)
    twice += [float(p.grad.flatten()[0]) for p in plain.parameters()]
    _dump(out, r, {
        "worker_num": fleet.worker_num(), "first": fleet.is_first_worker(),
        "dp_world": hcg.get_data_parallel_world_size(),
        "mode": hcg.get_parallel_mode(),
        "merge_wrapped": isinstance(opt, GradientMergeOptimizer),
        "dp_type": type(dp).__name__, "losses": losses,
        "params": _params(model), "fused_grads": twice})


def dead_rank_worker(out):
    """Rank 1 exits mid-run; rank 0's next all-reduce must raise, and its
    seconds to the raise are written."""
    _setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(timeout=30)
    r = dist.get_rank()
    if r == 1:
        os._exit(3)
    time.sleep(0.5)
    t0 = time.monotonic()
    try:
        for _ in range(100):
            dist.all_reduce(torch.ones(1000))
        err = None
    except Exception as e:  # the backend's error, whatever its class
        err = f"{type(e).__name__}: {e}"[:300]
    _dump(out, r, {"error": err, "seconds": time.monotonic() - t0})
    os._exit(0)


def failing_worker(out):
    """Rank 1 raises; rank 0 sleeps on (spawn's watchdog must end it)."""
    _setup()
    if os.environ["PADDLE_TRAINER_ID"] == "1":
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)


if __name__ == "__main__":
    main()
