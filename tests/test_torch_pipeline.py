"""The port's pipeline parallelism against the JAX package, on
tests/test_pipeline_parallel.py's models: ``PipelineTrainStep`` at pp = 4
(Momentum, 8 micro-batches; Lamb) and at dp = 2 x pp = 2 against the
single-device run, its point-to-point counts, ``state_dict``, fleet's
routing and ``PipelineParallel.train_batch``, ``pipeline_spmd_step``'s
forward and gradient against JAX's, and the TINY GPT as a
``PipelineLayer`` with its tied embedding shared by both stages against
JAX's ``TrainStep``; and ring attention at sp = 4 (causal and full,
outputs and gradients) against JAX's ``ring_attention``.

One job of four gloo ranks (`tests/torch_hybrid_runner.py:pipe_worker`),
started once a session; it also runs test_torch_tensor_parallel.py's
dp = 2 x mp = 2 checks.  Tolerances: the pipeline models' losses JAX's
own (2e-5 relative, 1e-6 absolute; Lamb 2e-4 / 1e-5), parameters the
same; ``pipeline_spmd_step`` 1e-5; the GPT 1e-5 relative / 1e-6 absolute
on losses, 1e-5 on parameters; ring attention 1e-5 on outputs, 1e-4 on
gradients.
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.distributed import topology as JT
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.parallel import pipeline_spmd_step, ring_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_pipeline_parallel as JP  # noqa: E402
import torch_hybrid_runner as R  # noqa: E402
from torch_hybrid_common import shared_run  # noqa: E402

L, M = 4, 8


def _np(t):
    return np.asarray(t.numpy())


def _data(steps, batch, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(steps, batch, JP.HID).astype(np.float32),
            rng.randn(steps, batch, JP.HID).astype(np.float32))


def _ring_inputs(prefix, shape, seed):
    rng = np.random.RandomState(seed)
    return {f"{prefix}_{n}": rng.randn(*shape).astype(np.float32)
            for n in ("q", "k", "v", "g")}


def _inputs():
    a = {}
    for seed in (0, 5, 7, 11, 13):
        m = JP.make_pipeline_model(seed=seed)
        for k, v in m.state_dict().items():
            a[f"m{seed}.{k}"] = _np(v)
    for key, (steps, batch, seed) in {"d0": (4, 16, 1), "d3": (3, 16, 3),
                                      "d5": (3, 16, 5),
                                      "d13": (2, 16, 13)}.items():
        a[f"{key}_x"], a[f"{key}_y"] = _data(steps, batch, seed)
    rng = np.random.RandomState(3)
    a["spmd_w"] = (rng.randn(L, 8, 8) * 0.3).astype(np.float32)
    a["spmd_x"] = rng.randn(3, 2, 8).astype(np.float32)
    a.update(_ring_inputs("ring4", (2, 2, 32, 8), 4))
    from test_torch_tensor_parallel import _inputs as tp_inputs

    a.update({k: v for k, v in tp_inputs().items() if k.startswith("mlp")})
    return a


def pipe_job(tmp_path_factory):
    """The four-rank job (also read by test_torch_tensor_parallel.py)."""
    return shared_run(tmp_path_factory, "pipe", R.pipe_worker, L,
                      lambda out: np.savez(out + ".npz", **_inputs()))


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    return pipe_job(tmp_path_factory)


def _single(seed, key, steps, opt="momentum"):
    JT.set_hybrid_communicate_group(None)
    a = _inputs()
    model = JP.make_pipeline_model(seed=seed)
    if opt == "momentum":
        return JP._train_single(model, steps, a[f"{key}_x"],
                                a[f"{key}_y"]), model
    o = JO.Lamb(learning_rate=0.01, parameters=list(model.parameters()))
    losses = []
    for t in range(steps):
        out = model(paddle.to_tensor(a[f"{key}_x"][t]))
        loss = ((out - paddle.to_tensor(a[f"{key}_y"][t])) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, model


def test_pp4_matches_single_device(pipe):
    want, model = _single(0, "d0", 4)
    params = {k: _np(v) for k, v in model.state_dict().items()}
    for res in pipe:
        np.testing.assert_allclose(res["momentum_losses"], want, rtol=2e-5,
                                   atol=1e-6)
        assert sorted(res["state_dict"]) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(res["state_dict"][k], v, rtol=2e-5,
                                       atol=1e-6, err_msg=k)


def test_each_rank_builds_only_its_stage(pipe):
    # six descriptions over four stages: floor cuts at 1, 3, 4, 6
    for s, res in enumerate(pipe):
        assert res["stage"] == s
        assert res["first"] == (s == 0) and res["last"] == (s == L - 1)
        assert res["mode"] == "pipeline_parallel"
        idx = {0: [0], 1: [1, 2], 2: [3], 3: [4, 5]}[s]
        assert res["stage_param_names"] == sorted(
            f"run_function.{i}.{w}" for i in idx for w in ("bias", "weight"))


def test_p2p_count_and_volume(pipe):
    """Per step the 1F1B schedule sends each micro-batch's activation
    forward once a boundary and its gradient back once: 2 M (L - 1)
    transfers of the [2, 8] f32 activation over the pipeline (JAX's
    lockstep ring rotates 2 (M + 2 L - 1) times a step, every device
    sending each time); the activation's shape crosses once (two small
    messages a boundary, at the first step)."""
    steps, act = 4, 2 * JP.HID * 4
    total_sends = total_bytes = 0
    for s, res in enumerate(pipe):
        st = res["momentum_stats"]
        fwd = M * steps if s < L - 1 else 0
        bwd = M * steps if s > 0 else 0
        meta = 2 if s < L - 1 else 0
        assert st["sends"] == fwd + bwd + meta, (s, st)
        assert st["recvs"] == (M * steps if s > 0 else 0) + \
            (M * steps if s < L - 1 else 0) + (2 if s > 0 else 0), (s, st)
        total_sends += st["sends"] - meta
        total_bytes += st["bytes"]
    assert total_sends == 2 * M * (L - 1) * steps
    meta_bytes = (L - 1) * (8 + 8 * (2 + 2))
    assert total_bytes == 2 * M * (L - 1) * steps * act + meta_bytes


def test_lamb_pipeline_matches_single_device(pipe):
    want, _ = _single(7, "d5", 3, opt="lamb")
    for res in pipe:
        np.testing.assert_allclose(res["lamb_losses"], want, rtol=2e-4,
                                   atol=1e-5)


def test_dp_pp_composition(pipe):
    want, _ = _single(5, "d3", 3)
    for g, res in enumerate(pipe):
        assert res["dp_pp_coords"] == [g // 2, g % 2]
        np.testing.assert_allclose(res["dp_pp_losses"], want, rtol=2e-5,
                                   atol=1e-6)


def test_fleet_routes_and_train_batch(pipe):
    want, model = _single(13, "d13", 2)
    for res in pipe:
        assert res["wrapper"] == "PipelineParallel"
        assert res["routed"] == "PipelineTrainStep"
        assert res["train_batch_compiled"]
        assert res["train_batch_state_len"] == len(dict(
            model.named_parameters()))
        np.testing.assert_allclose(res["train_batch_losses"], want,
                                   rtol=2e-5, atol=1e-6)


def test_pipeline_spmd_step_matches_jax(pipe):
    a = _inputs()
    mesh = JT.build_mesh(pp=L)
    w, x = jnp.asarray(a["spmd_w"]), jnp.asarray(a["spmd_x"])

    def stage_fn(p, h):
        return jnp.tanh(h @ p)

    def loss(w):
        out = pipeline_spmd_step(stage_fn, w, x, mesh)
        return jnp.sum(out ** 2), out

    # one compiled program (eager shard_map dispatch compiles every op)
    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(w)
    out, grad = np.asarray(out), np.asarray(grad)
    for res in pipe:
        np.testing.assert_allclose(res["spmd_out"], out, atol=1e-5)
        np.testing.assert_allclose(res["spmd_grad"], grad, atol=1e-5)


def test_gpt_pipeline_layer_matches_jax_train_step(pipe):
    from paddle_tpu_torch.models.gpt import GPT as TGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

    JT.set_hybrid_communicate_group(None)
    tm = TGPT.random(TGPTConfig(**R.GPT_DENSE_CFG), seed=R.GPT_SEED,
                     device="cpu")
    m = JGPT(JGPTConfig(**R.GPT_DENSE_CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    step = JTrainStep(m, jax_gpt_loss_fn, JO.AdamW(
        R.LR, parameters=m.parameters(), weight_decay=0.01))
    want = [float(_np(step(paddle.to_tensor(x), paddle.to_tensor(y))))
            for x, y in R.gpt_batches()]
    params = {k: _np(v) for k, v in m.named_parameters()}
    nl = R.GPT_DENSE_CFG["num_layers"]

    def jax_name(k):
        if k.startswith("shared_layers.embed."):
            return k[len("shared_layers.embed."):]
        i, rest = k[len("run_function."):].split(".", 1)
        return rest if int(i) == nl + 1 else f"blocks.{int(i) - 1}.{rest}"

    for res in pipe:
        assert res["gpt_pipe_segments"] == [0, 2, 5]
        np.testing.assert_allclose(res["gpt_pipe_losses"], want, rtol=1e-5,
                                   atol=1e-6)
        st = res["gpt_pipe_state"]
        assert sorted(jax_name(k) for k in st) == sorted(params)
        for k, v in st.items():
            np.testing.assert_allclose(v, params[jax_name(k)], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_gathered_pipeline_save_loads_in_jax_bit_for_bit(pipe):
    """Every stage's parameters gathered (`PipelineTrainStep.state_dict`)
    and saved by rank 0 with ``framework.io``: the JAX package's
    ``paddle.load`` reads the whole model, bit for bit."""
    got = paddle.load(pipe[0]["gpt_pipe_saved"])
    want = pipe[0]["gpt_pipe_state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(got[k]), v, err_msg=k)
        np.testing.assert_array_equal(pipe[3]["gpt_pipe_state"][k], v)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sp4_matches_jax(pipe, causal):
    a = _inputs()
    mesh = JT.build_mesh(sp=4)
    q, k, v, g = (jnp.asarray(a[f"ring4_{n}"]) for n in "qkvg")

    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=causal), q, k, v)
        return out, vjp(g)

    out, grads = fwd_bwd(q, k, v, g)
    for res in pipe:
        got = res["ring4"][causal]
        np.testing.assert_allclose(got["out"], np.asarray(out), atol=1e-5)
        for gg, want in zip(got["grads"], grads):
            np.testing.assert_allclose(gg, np.asarray(want), atol=1e-4)
