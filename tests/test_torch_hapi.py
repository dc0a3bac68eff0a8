"""paddle_tpu_torch's dygraph training loop and ``paddle.Model`` against
the JAX package's.

The TINY GPT (vocab 96, hidden 32, 2 layers, 4 heads, 32 positions) from
one weight tree in both packages: 5 eager steps of the loop
``loss.backward(); opt.step(); opt.clear_grad(); sched.step()`` over a
shuffled `DataLoader` (AdamW, `LinearWarmup(CosineAnnealingDecay)`,
`ClipGradByGlobalNorm`), and a 3-step ``Model.fit``; losses within
1e-5 (f32 on the CPU, sums in another order), parameters within the
bound each test states.  Then the rest of the high-level API: evaluate,
predict, the metric, callbacks, save/load, summary and flops.
"""
import json
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import io as JIO
from paddle_tpu import nn as JN
from paddle_tpu import optimizer as JO
from paddle_tpu.hapi import callbacks as JCB
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as TIO
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.hapi import callbacks as TCB
from paddle_tpu_torch.inference.weights import params_to_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# vocab, positions and MLP width chosen so the weights take five shapes
# (the JAX package's eager step compiles its update once a shape)
TINY = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, intermediate_size=96, use_parallel_layers=False,
            dropout=0.0)
LOSS_TOL = 1e-5
PEAK_LR = 1e-3


def _zeros(self, shape, dtype):
    return jnp.zeros(shape, dtype)


def _models(seed):
    """The port's TINY GPT (GPT-2 init from ``seed``) and a JAX GPT with
    the same weights.  The JAX GPT is built with its initializers drawing
    zeros: its own draws (a compile a shape) would be overwritten."""
    tm = TGPT.random(TGPTConfig(**TINY), seed=seed, device="cpu")
    with mock.patch.object(JI.Normal, "_init", _zeros), \
            mock.patch.object(JI.XavierUniform, "_init", _zeros), \
            mock.patch.object(JI.Constant, "_init", _zeros):
        m = GPT(GPTConfig(**TINY))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    return m, tm


def _data(n=10):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (n, 16)).astype(np.int32),
            rng.randint(0, 64, (n, 16)).astype(np.int32))


def _optimizer(mod, params):
    sched = mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(
        PEAK_LR, T_max=20), 2, 0.0, PEAK_LR)
    return sched, mod.AdamW(sched, parameters=params, weight_decay=0.01,
                            grad_clip=(JN if mod is JO else TN)
                            .ClipGradByGlobalNorm(1.0))


def _param_diffs(m, tm):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, JS._extract_gpt_params(m)))
    got = jax.tree_util.tree_leaves(params_to_numpy(tm.params()))
    return [float(np.abs(g - w).max()) for g, w in zip(got, want)]


def test_eager_loop_matches_jax():
    """5 eager steps over a shuffled loader (batch 2 of 10 rows, one
    ``np.random.seed`` for both).  Losses within `LOSS_TOL`; parameters
    within 10 x the peak rate at most (Adam moves a parameter about lr a
    step, and a near-zero gradient the two round apart in sign moves it
    up to 2 lr apart) and within 1e-5 for 90% of the leaves."""
    m, tm = _models(seed=3)
    jsched, jopt = _optimizer(JO, m.parameters())
    tsched, topt = _optimizer(TO, tm.parameters())
    tokens, labels = _data()
    np.random.seed(1)
    jloader = JIO.DataLoader(JIO.TensorDataset([tokens, labels]),
                             batch_size=2, shuffle=True)
    jl = []
    for x, y in jloader:
        loss = JN.functional.cross_entropy(m(x), y)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        jl.append(float(loss.numpy()))
    np.random.seed(1)
    tloader = tpaddle.io.DataLoader(TIO.TensorDataset([tokens, labels]),
                                    places="cpu", batch_size=2, shuffle=True)
    tl = []
    for x, y in tloader:
        loss = TN.functional.cross_entropy(tm(x), y)
        loss.backward()
        topt.step()
        topt.clear_grad()
        tsched.step()
        tl.append(float(loss.detach()))
        assert all(p.grad is None for p in tm.parameters())
    assert len(tl) == 5 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL)
    assert tsched.last_epoch == jsched.last_epoch == 5
    diffs = _param_diffs(m, tm)
    assert max(diffs) <= 10 * PEAK_LR
    assert np.mean([d <= 1e-5 for d in diffs]) >= 0.9


def test_fit_matches_jax():
    """``Model.fit`` for 3 steps (its fused `TrainStep`, the scheduler
    stepped by the `LRScheduler` callback) over a shuffled dataset, one
    ``np.random.seed`` for both: the logged losses within `LOSS_TOL`,
    parameters as in `test_eager_loop_matches_jax`."""
    m, tm = _models(seed=3)
    jsched, jopt = _optimizer(JO, m.parameters())
    tsched, topt = _optimizer(TO, tm.parameters())
    tokens, labels = _data()
    logged = {"jax": [], "torch": []}

    def recorder(base, side):
        class Rec(base):
            def on_train_batch_end(self, step, logs=None):
                logged[side].append(logs["loss"])
        return Rec()

    jmodel = paddle.Model(m)
    jmodel.prepare(jopt, JN.CrossEntropyLoss())
    tmodel = tpaddle.Model(tm)
    tmodel.prepare(topt, TN.CrossEntropyLoss())
    for model, ds, side, base in (
            (jmodel, JIO.TensorDataset([tokens, labels]), "jax",
             JCB.Callback),
            (tmodel, TIO.TensorDataset([tokens, labels]), "torch",
             TCB.Callback)):
        np.random.seed(2)
        model.fit(ds, batch_size=2, epochs=1, num_iters=3, verbose=0,
                  callbacks=[recorder(base, side)])
    assert len(logged["torch"]) == 3
    np.testing.assert_allclose(logged["torch"], logged["jax"], atol=LOSS_TOL)
    assert tsched.last_epoch == jsched.last_epoch == 3
    diffs = _param_diffs(m, tm)
    assert max(diffs) <= 10 * PEAK_LR
    assert np.mean([d <= 1e-5 for d in diffs]) >= 0.9


def test_model_evaluate_predict_and_metric():
    """``evaluate`` (loss and top-1/top-5 accuracy) and ``predict`` of a
    TINY GPT against JAX's on the same weights (1e-5), without grad."""
    m, tm = _models(seed=4)
    tokens, labels = _data(6)
    out = {}
    for side, api, io, mod in (("jax", paddle, JIO, paddle.metric),
                               ("torch", tpaddle, TIO, tpaddle.metric)):
        net = m if side == "jax" else tm
        model = api.Model(net)
        model.prepare(loss=(JN if side == "jax" else TN).CrossEntropyLoss(),
                      metrics=mod.Accuracy(topk=(1, 5)))
        ds = io.TensorDataset([tokens, labels])
        logs = model.evaluate(ds, batch_size=3, verbose=0)
        pred = model.predict(io.TensorDataset([tokens]), batch_size=3,
                             stack_outputs=True)[0]
        out[side] = (logs, pred)
    (jlogs, jpred), (tlogs, tpred) = out["jax"], out["torch"]
    assert sorted(tlogs) == sorted(jlogs) == ["acc_top1", "acc_top5", "loss"]
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k], jlogs[k], atol=LOSS_TOL)
    assert tpred.shape == (6, 16, 96)
    np.testing.assert_allclose(tpred, jpred, atol=LOSS_TOL)
    assert all(p.grad is None for p in tm.parameters())


def test_model_save_load_and_callbacks(tmp_path):
    """``Model.save`` writes ``.pdparams``/``.pdopt`` that JAX's
    ``Model.load`` reads; the port's ``load`` restores network and
    optimizer (the next fit step equals the saved model's);
    ``save(training=False)`` names its slice; `ModelCheckpoint`,
    `VisualDL` (JSONL) and `EarlyStopping` work in ``fit``."""
    _, tm = _models(seed=5)
    tokens, labels = _data(4)
    ds = TIO.TensorDataset([tokens, labels])
    opt = TO.AdamW(1e-3, parameters=tm.parameters())
    model = tpaddle.Model(tm)
    model.prepare(opt, TN.CrossEntropyLoss())
    stop = TCB.EarlyStopping(monitor="loss", patience=0)
    model.fit(ds, eval_data=ds, batch_size=2, epochs=3, verbose=0,
              save_dir=str(tmp_path / "ck"),
              callbacks=[TCB.VisualDL(str(tmp_path / "vdl")), stop])
    lines = (tmp_path / "vdl" / "train.jsonl").read_text().splitlines()
    assert len(lines) >= 2 and "loss" in json.loads(lines[0])
    assert (tmp_path / "ck" / "final.pdparams").exists()
    assert (tmp_path / "ck" / "epoch_0.pdparams").exists()
    model.save(str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="export slice"):
        model.save(str(tmp_path / "x"), training=False)
    jm, _ = _models(seed=6)
    jmodel = paddle.Model(jm)
    jmodel.prepare(JO.AdamW(1e-3, parameters=jm.parameters()),
                   JN.CrossEntropyLoss())
    jmodel.load(str(tmp_path / "m"))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(jm.state_dict()[k].numpy(), v.numpy())
    fresh = TGPT.random(TGPTConfig(**TINY), seed=7, device="cpu")
    m2 = tpaddle.Model(fresh)
    m2.prepare(TO.AdamW(1e-3, parameters=fresh.parameters()),
               TN.CrossEntropyLoss())
    m2.load(str(tmp_path / "m"))
    assert m2._optimizer.state_dict()["step"] == opt.state_dict()["step"]
    x, y = torch.from_numpy(tokens[:2]), torch.from_numpy(labels[:2])
    assert m2.train_batch([x], [y]) == model.train_batch([x], [y])


def test_summary_and_flops_match_jax():
    """Parameter counts and the FLOPs of a [2, 8] forward equal JAX's."""
    m, tm = _models(seed=8)
    want = paddle.summary(m)
    got = tpaddle.summary(tm)
    assert got == want
    assert got["total_params"] == sum(p.numel() for p in tm.parameters())
    assert tpaddle.flops(tm, [2, 8]) == paddle.flops(m, [2, 8])
    assert tm.training
