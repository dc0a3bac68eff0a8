"""paddle_tpu_torch.incubate.checkpoint.auto_checkpoint against an
unbroken run, and against a job directory the JAX package wrote.

A run is a tiny GPT (dropout 0.1 where the port alone runs, so the
restored generators matter) with AdamW under ``train_epoch_range(4)``,
one step an epoch on a fixed batch.  An interruption is a run that stops
once epoch 1's checkpoint is written (at the start of epoch 2's body,
the kill point of a preempted job).  The resumed run starts from other
weights and another seed, resumes at epoch 2, and ends bit-equal to the
unbroken run (the CPU's arithmetic is deterministic).  What crosses from
the JAX package: ``meta.json``, the models' and optimizers' state dicts
(``model_<i>``, ``opt_<i>``: the same names and the pickle format of
``paddle.save``); its file has no generator states (``rng``), so the
crossing run has no dropout, and it ends within f32 rounding (1e-5) of
the JAX package's own resumed run — except the key part of each ``qkv``
bias, whose gradient is zero but for rounding (softmax does not see a
shift shared by every key), which AdamW's normalized step moves by up to
``lr`` a step from that noise: there the bound is ``2 * LR * EPOCHS``.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.incubate.checkpoint import auto_checkpoint as JACP
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as TACP
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_loss_fn

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, use_parallel_layers=True, dropout=0.0)
EPOCHS = 4
LR = 1e-2


@pytest.fixture
def acp_env(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_JOB_ID", "job")
    monkeypatch.setenv("PADDLE_EDL_CHECKPOINT_DIR", str(tmp_path))
    yield tmp_path / "job"
    TACP.unregister()
    JACP.unregister()


def _batch():
    rng = np.random.RandomState(9)
    return (rng.randint(0, 64, (4, 16)), rng.randint(0, 64, (4, 16)))


def _port_run(seed, dropout, stop_at=None):
    """One job: returns (epochs run, losses, parameters)."""
    tpaddle.seed(seed)
    model = TGPT(TGPTConfig(**dict(CFG, dropout=dropout)), device="cpu")
    opt = TO.AdamW(LR, parameters=model.parameters())
    TACP.register(model=model, optimizer=opt)
    x, y = (torch.from_numpy(a) for a in _batch())
    epochs, losses = [], []
    for epoch in TACP.train_epoch_range(EPOCHS):
        if epoch == stop_at:
            break
        epochs.append(epoch)
        loss = gpt_loss_fn(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    TACP.unregister()
    return epochs, losses, [p.detach().clone() for p in model.parameters()]


def test_resume_equals_unbroken_run(acp_env, monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_JOB_ID", "unbroken")
    epochs, losses, want = _port_run(seed=1, dropout=0.1)
    assert epochs == [0, 1, 2, 3]
    monkeypatch.setenv("PADDLE_JOB_ID", "job")
    first, _, _ = _port_run(seed=1, dropout=0.1, stop_at=2)
    assert first == [0, 1]
    meta = json.loads((acp_env / "meta.json").read_text())
    assert meta["epoch_no"] == 1 and set(meta) == {"epoch_no", "timestamp"}
    epochs, rest, got = _port_run(seed=7, dropout=0.1)
    assert epochs == [2, 3]
    assert rest == losses[2:]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert json.loads((acp_env / "meta.json").read_text())["epoch_no"] == 3
    # finished: a rerun trains no epoch
    assert _port_run(seed=7, dropout=0.1)[0] == []


def test_disabled_is_a_plain_range(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_RUNNING_ENV", raising=False)
    monkeypatch.setenv("PADDLE_EDL_CHECKPOINT_DIR", str(tmp_path))
    assert list(TACP.train_epoch_range(3)) == [0, 1, 2]
    assert not any(tmp_path.iterdir())


def _jax_run(stop_at=None):
    """The JAX package's job from the port's ``GPT.random(2)`` weights."""
    tm = TGPT.random(TGPTConfig(**CFG), seed=2, device="cpu")
    m = GPT(GPTConfig(**CFG))
    named = dict(tm.named_parameters())
    for name, p in m.named_parameters():
        p.set_value(named[name].detach().numpy())
    opt = JO.AdamW(learning_rate=LR, parameters=m.parameters())
    JACP.register(model=m, optimizer=opt)
    x, y = (paddle.to_tensor(a.astype(np.int32)) for a in _batch())
    epochs = []
    for epoch in JACP.train_epoch_range(EPOCHS):
        if epoch == stop_at:
            break
        epochs.append(epoch)
        loss = jax_gpt_loss_fn(m, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    JACP.unregister()
    return epochs, {k: np.asarray(p.numpy()) for k, p in
                    m.named_parameters()}


def test_job_written_by_jax_resumes_in_port(acp_env, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "jax_unbroken")
    _, want = _jax_run()
    monkeypatch.setenv("PADDLE_JOB_ID", "job")
    assert _jax_run(stop_at=2)[0] == [0, 1]
    epochs, _, got = _port_run(seed=7, dropout=0.0)
    assert epochs == [2, 3]
    names = [k for k, _ in TGPT.random(TGPTConfig(**CFG), seed=0,
                                       device="cpu").named_parameters()]
    h = CFG["hidden_size"]
    for name, g in zip(names, got):
        g, w = g.numpy(), want[name]
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(g[h:2 * h], w[h:2 * h],
                                       atol=2 * LR * EPOCHS, err_msg=name)
            g, w = np.delete(g, np.s_[h:2 * h]), np.delete(w, np.s_[h:2 * h])
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
