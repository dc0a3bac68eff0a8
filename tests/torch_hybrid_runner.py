"""Rank programs of the hybrid-parallel port tests
(tests/test_torch_tensor_parallel.py, test_torch_zero.py,
test_torch_pipeline.py, test_torch_ring_spmd.py), on the CPU over gloo.

Each function is a ``paddle_tpu_torch.distributed.spawn`` target: it
reads its inputs (numpy arrays the test made, from the JAX package or
from a seed) from ``<out>.npz``, runs several checks on its rank and
writes their results as one pickle to ``<out>.<rank>``, so a test file
starts few jobs.  Every rank runs on the CPU (``PADDLE_DEVICE=cpu``)
with one thread.  Nothing here imports JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=16, use_parallel_layers=True, dropout=0.0)
GPT_DENSE_CFG = dict(GPT_CFG, use_parallel_layers=False)
GPT_BATCH = 8
GPT_STEPS = 3
GPT_SEED = 5
LR = 1e-3
SPMD_CFG = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2,
                max_seq_len=16)
PIPE_HID = 8


def gpt_batches(steps=GPT_STEPS):
    rng = np.random.RandomState(3)
    v, s = GPT_CFG["vocab_size"], GPT_CFG["max_seq_len"]
    return [(rng.randint(0, v, (GPT_BATCH, s)).astype(np.int64),
             rng.randint(0, v, (GPT_BATCH, s)).astype(np.int64))
            for _ in range(steps)]


def _setup():
    torch.set_num_threads(1)
    os.environ["PADDLE_DEVICE"] = "cpu"


def _inputs(out):
    return dict(np.load(out + ".npz", allow_pickle=False))


def _dump(out, rank, res):
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def _np(t):
    return t.detach().float().cpu().numpy()


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=st)
    return fleet, fleet.get_hybrid_communicate_group()


def _mse(m, x, y):
    return torch.mean((m(x) - y) ** 2)


def _tp_mlp(a, group=None):
    """JAX's TP MLP (``ColumnParallelLinear(8, 32)``, tanh,
    ``RowParallelLinear(32, 4)``) over the test's whole weights."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.inference.weights import shard_state_dict

    net = torch.nn.Sequential(
        ColumnParallelLinear(8, 32, gather_output=False, device="cpu"),
        torch.nn.Tanh(),
        RowParallelLinear(32, 4, input_is_parallel=True, device="cpu"))
    shard_state_dict(net, {"0.weight": a["mlp_w0"], "0.bias": a["mlp_b0"],
                           "2.weight": a["mlp_w1"], "2.bias": a["mlp_b1"]},
                     group)
    return net


def _train_tp_mlp(a, hcg, zero_stage=0):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.sharded_step import \
        ShardedTrainStep
    from paddle_tpu_torch.inference.weights import full_state_dict

    group = hcg.get_model_parallel_group()
    net = _tp_mlp(a, group)
    opt = optimizer.SGD(0.1, parameters=net.parameters())
    step = ShardedTrainStep(net, _mse, opt, hcg=hcg, zero_stage=zero_stage)
    x, y = torch.from_numpy(a["mlp_x"]), torch.from_numpy(a["mlp_y"])
    losses = [float(step(x, y)) for _ in range(3)]
    step.sync_params()
    return losses, {k: _np(v) for k, v in
                    full_state_dict(net, group).items()}


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------
def tp_worker(out):
    """mp = 2: the layers and ``split`` against the test's JAX layers,
    the TP MLP's steps, the TINY GPT at mp = 2 (``build_train_step`` and
    the dygraph loop through ``distributed_model``), its gathered save,
    and a JAX save restored into the shards."""
    _setup()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective, split
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.inference.weights import (full_state_dict,
                                                    shard_state_dict)
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn

    a = _inputs(out)
    fleet, hcg = _fleet(mp=2)
    r = hcg.get_model_parallel_rank()
    group = hcg.get_model_parallel_group()
    res = {"mp_rank": r, "mode": hcg.get_parallel_mode(),
           "mp_world": hcg.get_model_parallel_world_size(),
           "mp_ranks": group.ranks}

    # -- the layers against the dense math --------------------------------
    col = ColumnParallelLinear(8, 16, gather_output=False, device="cpu")
    row = RowParallelLinear(16, 8, input_is_parallel=True, device="cpu")
    shard_state_dict(col, {"weight": a["col_w"], "bias": a["col_b"]})
    shard_state_dict(row, {"weight": a["row_w"], "bias": a["row_b"]})
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    y = row(col(x))
    (y ** 2).sum().backward()
    res["layers_out"] = _np(y)
    res["layers_x_grad"] = _np(x.grad)
    from paddle_tpu_torch.parallel.partition import join_leaf

    grads, specs = {}, {}
    for name, layer in (("col", col), ("row", row)):
        for pn, p in layer.named_parameters():
            spec = getattr(p, "mesh_axes", ())
            specs[f"{name}_{pn}"] = tuple(spec)
            gr = p.grad
            if "mp" in spec:
                gr = join_leaf(collective._gather(gr, group), spec, "mp")
            grads[f"{name}_{pn}"] = _np(gr)
    res["layers_grads"], res["layers_specs"] = grads, specs
    gcol = ColumnParallelLinear(8, 16, gather_output=True, device="cpu")
    shard_state_dict(gcol, {"weight": a["col_w"], "bias": a["col_b"]})
    res["gather_output"] = _np(gcol(torch.from_numpy(a["x"])))
    srow = RowParallelLinear(16, 8, input_is_parallel=False, device="cpu")
    shard_state_dict(srow, {"weight": a["row_w"], "bias": a["row_b"]})
    res["split_input"] = _np(srow(torch.from_numpy(a["x16"])))
    emb = VocabParallelEmbedding(16, 8, device="cpu")
    shard_state_dict(emb, {"weight": a["emb_w"]})
    ids = torch.from_numpy(a["ids"])
    res["embedding"] = _np(emb(ids))
    logits = torch.from_numpy(a["logits"])
    block = logits.shape[-1] // 2
    mine = logits[..., r * block:(r + 1) * block].clone().requires_grad_()
    ce = ParallelCrossEntropy()(mine, torch.from_numpy(a["labels"]))
    ce.sum().backward()
    res["parallel_ce"] = _np(ce)
    res["parallel_ce_grad"] = _np(torch.cat(collective._gather(
        mine.grad, group), -1))
    res["parallel_ce_ignore"] = _np(ParallelCrossEntropy(ignore_index=3)(
        mine.detach(), torch.from_numpy(a["labels"])))

    # -- paddle.distributed.split --------------------------------------------
    paddle.seed(7)
    xs = torch.from_numpy(a["x"])
    splits = {}
    for key, kw in (("linear1", dict(size=(8, 16), operation="linear",
                                    axis=1, num_partitions=2)),
                    ("linear0", dict(size=(8, 16), operation="linear",
                                    axis=0, num_partitions=2)),
                    ("embedding", dict(size=(16, 8), operation="embedding",
                                       num_partitions=2))):
        inp = ids if key == "embedding" else xs
        o = split(inp, **kw)
        st = full_state_dict(split.last_layer, group)
        splits[key] = {"out": _np(o), "state": {k: _np(v) for k, v in
                                                st.items()}}
    res["split"] = splits
    try:
        split(xs, size=(8, 16), operation="linear", axis=1,
              num_partitions=4)
        res["split_bad_partitions"] = None
    except ValueError as e:
        res["split_bad_partitions"] = str(e)

    # -- the TP MLP -----------------------------------------------------------
    res["mlp_losses"], res["mlp_params"] = _train_tp_mlp(a, hcg)

    # -- the TINY GPT at mp = 2 ----------------------------------------------
    cfg = GPTConfig(**GPT_CFG)
    batches = gpt_batches()
    model = GPT.random(cfg, seed=GPT_SEED, device="cpu")
    res["gpt_heads_local"] = model.blocks[0].num_heads
    res["gpt_qkv_shape"] = list(model.blocks[0].qkv.weight.shape)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        LR, parameters=model.parameters(), weight_decay=0.01))
    step = fleet.build_train_step(model, gpt_loss_fn, opt)
    res["gpt_step_losses"] = [float(step(torch.from_numpy(x),
                                         torch.from_numpy(y)))
                              for x, y in batches]
    state = full_state_dict(model)
    res["gpt_step_params"] = {k: _np(v) for k, v in state.items()}
    path = out + ".gathered.pdparams"
    if r == 0:
        paddle.save(state, path)
    res["gpt_saved"] = path
    res["gpt_full_logits_shape"] = list(model(torch.from_numpy(
        batches[0][0])).shape)

    model2 = GPT.random(cfg, seed=GPT_SEED, device="cpu")
    tp = fleet.distributed_model(model2)
    res["gpt_wrapper"] = type(tp).__name__
    opt2 = optimizer.AdamW(LR, parameters=model2.parameters(),
                           weight_decay=0.01)
    losses = []
    for x, y in batches:
        loss = gpt_loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        opt2.step()
        opt2.clear_grad()
        losses.append(float(loss.detach()))
    res["gpt_dygraph_losses"] = losses

    # a JAX save restored into the shards
    model3 = GPT.random(cfg, seed=GPT_SEED + 1, device="cpu")
    jax_state = paddle.load(out + ".jax.pdparams", return_numpy=True)
    missing = shard_state_dict(model3, jax_state)
    res["restore_missing"] = missing
    res["restored_shards"] = {k: _np(v) for k, v in
                              model3.state_dict().items()}
    res["restored_logits"] = _np(model3(torch.from_numpy(batches[0][0])))
    _dump(out, r, res)


def _dpmp_checks(a):
    """dp = 2 x mp = 2 (4 ranks): the TP MLP through ``ShardedTrainStep``
    (each dp rank its half of the batch; also at ZeRO stages 2 and 3 over
    the dp axis), the hybrid group's queries, and
    ``fused_allreduce_gradients`` over the dp group."""
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    fleet, hcg = _fleet(dp=2, mp=2)
    g = hcg.get_global_rank()
    res = {"coords": [hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank()],
           "dp_ranks": hcg.get_data_parallel_group().ranks,
           "mp_ranks": hcg.get_model_parallel_group().ranks,
           "mode": hcg.get_parallel_mode()}
    res["mlp_losses"], res["mlp_params"] = _train_tp_mlp(a, hcg)
    # ZeRO over the dp axis of tensor-parallel parameters
    res["mlp_zero"] = {s: _train_tp_mlp(a, hcg, zero_stage=s)
                       for s in (2, 3)}
    plain = torch.nn.Linear(3, 2)
    for p in plain.parameters():
        p.grad = torch.full_like(p, float(g + 1))
    fused_allreduce_gradients(list(plain.parameters()), hcg)
    res["fused"] = [float(p.grad.flatten()[0]) for p in plain.parameters()]
    return res


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------
def zero_worker(out):
    """dp = 2: the TINY GPT's ``ShardedTrainStep`` at ZeRO stages 0-3, stage
    1 with offload, stage 2 with a global-norm clip, Lamb at stage 1
    (ranges cut at parameter boundaries), through ``fleet`` with
    ``strategy.sharding``; each rank's at-rest bytes; then
    ``DygraphShardingOptimizer`` in the dygraph loop and
    ``sharding_reduce_gradients``."""
    _setup()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet as F
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.distributed.fleet.sharded_step import \
        ShardedTrainStep
    from paddle_tpu_torch.distributed.fleet.utils import \
        sharding_reduce_gradients
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn

    st = F.DistributedStrategy()
    st.sharding = True
    st.sharding_configs = {"stage": 2, "sharding_degree": 2,
                           "offload": False}
    F.init(is_collective=True, strategy=st)
    hcg = F.get_hybrid_communicate_group()
    r = hcg.get_sharding_parallel_rank()
    cfg = GPTConfig(**GPT_DENSE_CFG)
    batches = gpt_batches()
    res = {"sharding_world": hcg.get_sharding_parallel_world_size(),
           "mode": hcg.get_parallel_mode(), "runs": {}}

    def run(label, stage, offload=False, opt_fn=None, via_fleet=False):
        model = GPT.random(cfg, seed=GPT_SEED, device="cpu")
        opt = (opt_fn or (lambda ps: optimizer.AdamW(
            LR, parameters=ps, weight_decay=0.01)))(model.parameters())
        if via_fleet:
            step = F.build_train_step(model, gpt_loss_fn, opt)
        else:
            step = ShardedTrainStep(model, gpt_loss_fn, opt,
                                    zero_stage=stage, offload=offload,
                                    hcg=hcg)
        losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                  for x, y in batches]
        rest = step.at_rest_bytes()
        step.sync_params()
        res["runs"][label] = {
            "losses": losses, "at_rest": rest, "stage": step.zero_stage,
            "params": {k: _np(v) for k, v in model.named_parameters()}}

    run("stage0", 0)
    run("stage1", 1)
    run("stage2", 2)
    run("stage3", 3)
    run("stage1_offload", 1, offload=True)
    run("fleet_stage2", None, via_fleet=True)
    run("stage2_clip", 2, opt_fn=lambda ps: optimizer.AdamW(
        LR, parameters=ps, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5)))
    run("stage0_clip", 0, opt_fn=lambda ps: optimizer.AdamW(
        LR, parameters=ps, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5)))
    run("stage1_lamb", 1, opt_fn=lambda ps: optimizer.Lamb(
        1e-2, parameters=ps))
    run("stage0_lamb", 0, opt_fn=lambda ps: optimizer.Lamb(
        1e-2, parameters=ps))

    # the dygraph loop: DataParallel + DygraphShardingOptimizer against
    # DataParallel + AdamW
    for label, sharded in (("dygraph_plain", False),
                           ("dygraph_sharded", True)):
        model = GPT.random(cfg, seed=GPT_SEED, device="cpu")
        dp = F.distributed_model(model)
        if sharded:
            opt = DygraphShardingOptimizer(
                hcg, st, model.parameters(), optimizer.AdamW,
                learning_rate=LR, weight_decay=0.01)
        else:
            opt = optimizer.AdamW(LR, parameters=model.parameters(),
                                  weight_decay=0.01)
        losses = []
        n = hcg.get_data_parallel_world_size()
        s = GPT_BATCH // n
        for x, y in batches:
            loss = gpt_loss_fn(dp, torch.from_numpy(x[r * s:(r + 1) * s]),
                               torch.from_numpy(y[r * s:(r + 1) * s]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            g = loss.detach().clone()
            from paddle_tpu_torch.distributed import all_reduce
            all_reduce(g, op="avg")
            losses.append(float(g))
        res["runs"][label] = {
            "losses": losses,
            "slot_bytes": opt.slot_bytes() if sharded else None,
            "params": {k: _np(v) for k, v in model.named_parameters()}}
    lin = torch.nn.Linear(3, 2)
    for p in lin.parameters():
        p.grad = torch.full_like(p, float(r + 1))
    sharding_reduce_gradients(list(lin.parameters()), hcg)
    res["sharding_reduced"] = [float(p.grad.flatten()[0])
                               for p in lin.parameters()]
    _dump(out, r, res)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def _pipe_model(a, prefix, hid=PIPE_HID, n_blocks=6, num_stages=4):
    """tests/test_pipeline_parallel.py's model (six Linear(8, 8) layer
    descriptions, MSE loss) over the test's JAX weights."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)

    model = PipelineLayer(
        [LayerDesc(nn.Linear, hid, hid, device="cpu")
         for _ in range(n_blocks)], num_stages=num_stages,
        loss_fn=lambda out, y: ((out - y) ** 2).mean())
    own = model.state_dict()
    model.set_state_dict({k: a[f"{prefix}{k}"] for k in own})
    return model


def _pipe_run(a, prefix, hcg, opt, n_micro, steps, data):
    from paddle_tpu_torch.distributed.fleet.pipeline_step import \
        PipelineTrainStep

    model = _pipe_model(a, prefix)
    step = PipelineTrainStep(model, model._loss_fn, opt, hcg,
                             n_micro=n_micro)
    xs, ys = a[f"{data}_x"], a[f"{data}_y"]
    losses = [float(step(torch.from_numpy(xs[t]), torch.from_numpy(ys[t])))
              for t in range(steps)]
    return losses, step


def pipe_worker(out):
    """pp = 4 (4 ranks): `PipelineTrainStep` against the single-device run
    (Momentum, 8 micro-batches) and with Lamb; its send/receive counts;
    ``state_dict``; ``fleet`` routing and ``PipelineParallel.
    train_batch``; `pipeline_spmd_step` forward and gradient; then
    dp = 2 x pp = 2; ring attention at sp = 4; and the dp = 2 x mp = 2
    checks of test_torch_tensor_parallel.py (`_dpmp_checks`)."""
    _setup()
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet as F
    from paddle_tpu_torch.distributed.collective import all_reduce
    from paddle_tpu_torch.distributed.fleet.pipeline_step import \
        PipelineTrainStep
    from paddle_tpu_torch.distributed.topology import (
        HybridCommunicateGroup, set_hybrid_communicate_group)
    from paddle_tpu_torch.parallel import pipeline as PL
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    a = _inputs(out)
    st = F.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": 4}
    st.pipeline = True
    st.pipeline_configs = {"accumulate_steps": 8}
    F.init(is_collective=True, strategy=st)
    hcg = F.get_hybrid_communicate_group()
    g = hcg.get_global_rank()
    res = {"stage": hcg.get_stage_id(), "first": hcg.is_first_stage(),
           "last": hcg.is_last_stage(), "mode": hcg.get_parallel_mode()}

    losses, step = _pipe_run(a, "m0.", hcg, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=[]), 8, 4, "d0")
    res["momentum_losses"] = losses
    res["momentum_stats"] = step.stats
    res["stage_param_names"] = sorted(dict(
        step.model.named_parameters()))
    res["state_dict"] = {k: _np(v) for k, v in step.state_dict().items()}
    res["lamb_losses"], _ = _pipe_run(a, "m7.", hcg, optimizer.Lamb(
        learning_rate=0.01, parameters=[]), 8, 3, "d5")

    # fleet routes a PipelineLayer to the 1F1B step, and train_batch
    model = _pipe_model(a, "m13.")
    wrapped = F.distributed_model(model)
    res["wrapper"] = type(wrapped).__name__
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9, parameters=[])
    tb = [float(wrapped.train_batch((torch.from_numpy(a["d13_x"][t]),
                                     torch.from_numpy(a["d13_y"][t])), opt))
          for t in range(2)]
    res["train_batch_losses"] = tb
    res["train_batch_compiled"] = isinstance(wrapped._compiled_step,
                                             PipelineTrainStep)
    res["train_batch_state_len"] = len(wrapped.state_dict())
    routed = F.build_train_step(_pipe_model(a, "m11."),
                                lambda o, y: ((o - y) ** 2).mean(),
                                optimizer.SGD(0.1, parameters=[]))
    res["routed"] = type(routed).__name__

    # pipeline_spmd_step against the sequential reference, and its gradient
    w = torch.from_numpy(a["spmd_w"]).requires_grad_(True)
    xm = torch.from_numpy(a["spmd_x"])
    o = PL.pipeline_spmd_step(lambda p, h: torch.tanh(h @ p), w, xm, hcg)
    (o ** 2).sum().backward()
    grad = w.grad.clone()
    all_reduce(grad, group=hcg.get_pipe_parallel_group())
    res["spmd_out"] = _np(o)
    res["spmd_grad"] = _np(grad)

    # dp = 2 x pp = 2 on the same four ranks
    hcg2 = HybridCommunicateGroup(dp=2, pp=2)
    set_hybrid_communicate_group(hcg2)
    res["dp_pp_coords"] = [hcg2.get_data_parallel_rank(),
                           hcg2.get_stage_id()]
    model = _pipe_model(a, "m5.", num_stages=2)
    step = PipelineTrainStep(model, model._loss_fn, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=[]), hcg2, n_micro=4)
    res["dp_pp_losses"] = [float(step(torch.from_numpy(a["d3_x"][t]),
                                      torch.from_numpy(a["d3_y"][t])))
                           for t in range(3)]
    res["dp_pp_stats"] = step.stats

    # the GPT as a PipelineLayer (tied embedding shared by both stages)
    from paddle_tpu_torch.models.gpt import (GPT, GPTConfig,
                                             gpt_pipeline_layer)
    from paddle_tpu_torch.nn.functional.loss import cross_entropy

    cfg = GPTConfig(**GPT_DENSE_CFG)
    tree = GPT.random(cfg, seed=GPT_SEED, device="cpu").params()
    pl = gpt_pipeline_layer(cfg, tree, device="cpu")
    gstep = PipelineTrainStep(
        pl, lambda o, y: cross_entropy(o, y, reduction="mean"),
        optimizer.AdamW(LR, parameters=[], weight_decay=0.01), hcg2,
        n_micro=2)
    res["gpt_pipe_losses"] = [float(gstep(torch.from_numpy(x),
                                          torch.from_numpy(y)))
                              for x, y in gpt_batches()]
    state = gstep.state_dict()
    res["gpt_pipe_state"] = {k: _np(v) for k, v in state.items()}
    if g == 0:
        import paddle_tpu_torch as paddle

        paddle.save(state, out + ".pipe.pdparams")
    res["gpt_pipe_saved"] = out + ".pipe.pdparams"
    res["gpt_pipe_segments"] = pl.segment_parts

    # ring attention at sp = 4
    hcg3 = HybridCommunicateGroup(sp=4)
    set_hybrid_communicate_group(hcg3)
    res["ring4"] = _ring_checks(a, hcg3, "ring4", ring_attention)
    res["dpmp"] = _dpmp_checks(a)
    _dump(out, g, res)


def _ring_checks(a, hcg, prefix, ring_attention):
    out = {}
    for causal in (False, True):
        q, k, v = (torch.from_numpy(a[f"{prefix}_{n}"]).requires_grad_(True)
                   for n in "qkv")
        o = ring_attention(q, k, v, hcg, causal=causal)
        (o * torch.from_numpy(a[f"{prefix}_g"])).sum().backward()
        grads = []
        for t in (q, k, v):
            gr = t.grad.clone()
            from paddle_tpu_torch.distributed.collective import all_reduce
            all_reduce(gr, group=hcg.get_sequence_parallel_group())
            grads.append(_np(gr))
        out[causal] = {"out": _np(o), "grads": grads}
    return out


# ---------------------------------------------------------------------------
# ring attention and gpt_spmd
# ---------------------------------------------------------------------------
def spmd_worker(out):
    """(dp, pp, sp, mp) = (1, 2, 2, 2) on 8 ranks: `build_spmd_train_step`
    in f32 (two micro-batches) from the test's JAX parameters: the loss,
    the updated parameters gathered whole, the ring's K/V rotations;
    then ring attention at sp = 2 on the hybrid group's sp axis, and the
    flash-block ring at the JAX test's [1, 2, 1024, 64]."""
    _setup()
    from paddle_tpu_torch.distributed import fleet as F
    from paddle_tpu_torch.models import gpt_spmd as S
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    a = _inputs(out)
    F.init(is_collective=True, strategy=_strategy(pp=2, sp=2, mp=2))
    hcg = F.get_hybrid_communicate_group()
    g = hcg.get_global_rank()
    cfg = GPTConfig(**SPMD_CFG)
    whole = {k[len("p."):]: a[k] for k in a if k.startswith("p.")}
    local = S.shard_params(whole, hcg)
    step = S.build_spmd_train_step(cfg, hcg, num_micro=2, lr=0.1,
                                   compute_dtype=torch.float32)
    loss, new = step(local, torch.from_numpy(a["tokens"]),
                     torch.from_numpy(a["labels"]))
    res = {"coords": [hcg.axis_rank(ax) for ax in
                      ("dp", "pp", "sp", "mp")],
           "loss": float(loss),
           "local_shapes": {k: list(v.shape) for k, v in local.items()},
           "new_params": {k: _np(v) for k, v in
                          S.gather_params(new, hcg).items()},
           "pp_stats": step.link.stats,
           "reference_loss": float(S.reference_loss(cfg, whole,
                                                    a["tokens"],
                                                    a["labels"]))}
    loss_bf16, _ = S.build_spmd_train_step(cfg, hcg, num_micro=2, lr=0.1)(
        local, torch.from_numpy(a["tokens"]), torch.from_numpy(a["labels"]))
    res["loss_bf16"] = float(loss_bf16)
    res["ring2"] = _ring_checks(a, hcg, "ring2", ring_attention)
    res["flash_ring"] = _ring_checks(a, hcg, "flash", ring_attention)
    _dump(out, g, res)


def _strategy(**degrees):
    from paddle_tpu_torch.distributed import fleet as F

    st = F.DistributedStrategy()
    st.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return st


def dead_mp_rank_worker(out):
    """mp = 2, rank 1 exits after start-up: rank 0's next all-reduce over
    the tensor-parallel subgroup must raise; its seconds to the raise
    are written to ``<out>.0``."""
    import json
    import time

    _setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import \
        mp_allreduce

    dist.init_parallel_env(timeout=30)
    fleet, hcg = _fleet(mp=2)
    r = hcg.get_model_parallel_rank()
    if r == 1:
        os._exit(3)
    time.sleep(0.5)
    t0 = time.monotonic()
    try:
        for _ in range(100):
            mp_allreduce(torch.ones(1000), hcg.get_model_parallel_group())
        err = None
    except Exception as e:  # the backend's error, whatever its class
        err = f"{type(e).__name__}: {e}"[:300]
    with open(f"{out}.0", "w") as f:
        json.dump({"error": err, "seconds": time.monotonic() - t0}, f)
    os._exit(0)
