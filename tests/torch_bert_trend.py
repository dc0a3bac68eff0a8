"""Three AdamW steps of BERT pretraining in both packages, from one state.

    python tests/torch_bert_trend.py --hidden 768 --layers 2 --batch 16 \
        --seq 512 --lr 1e-4 1e-5

Builds the port's ``BertForPretraining`` (vocabulary 30522, dropout off,
f32, on the CPU), copies its state into the JAX package's, and runs
three AdamW(lr, weight decay 0.01) steps of each through its
``jit`` train step on one batch made as ``chip_smoke.py`` phase 22 (a)
makes it (every other row ends in seq / 16 padding tokens, 80 masked
positions a 512 tokens, random labels).  Prints each package's losses
for each learning rate: whether a rise of the loss on the repeated batch
is the model's and the optimizer's or the port's.
"""
from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu as P  # noqa: E402
import paddle_tpu_torch as T  # noqa: E402
from paddle_tpu.models import bert as JB  # noqa: E402
from paddle_tpu_torch.models import bert as TB  # noqa: E402


def batch(vocab, b, s):
    r = np.random.default_rng(0)
    p = max(s * 80 // 512, 1)
    ids = r.integers(3, vocab, (b, s))
    ids[1::2, -(s // 16):] = 0
    types = np.broadcast_to((np.arange(s) >= s // 2).astype(np.int64),
                            (b, s)).copy()
    return [ids, types, r.integers(0, s, (b, p)), r.integers(3, vocab, (b, p)),
            r.integers(0, 2, (b,)), np.ones((b, p), np.float32)]


def losses(cfg_kw, arrays, lr, steps=3):
    """Each package's losses over ``steps`` AdamW(lr) steps from the
    port's seed-0 state."""
    T.seed(0)
    tm = TB.BertForPretraining(TB.BertConfig(**cfg_kw), device="cpu").train()
    jm = JB.BertForPretraining(JB.BertConfig(**cfg_kw))
    missing, unexpected = jm.set_state_dict(
        {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    tstep = T.jit.TrainStep(tm, TB.bert_pretrain_loss_fn, T.optimizer.AdamW(
        lr, parameters=tm.parameters(), weight_decay=0.01))
    jstep = P.jit.train_step(jm, JB.bert_pretrain_loss_fn, P.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.01))
    tb = [torch.from_numpy(a) for a in arrays]
    jb = [P.to_tensor(a.astype(np.int32) if a.dtype.kind == "i" else a)
          for a in arrays]
    return ([float(tstep(*tb)) for _ in range(steps)],
            [float(jstep(*jb)) for _ in range(steps)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-4, 1e-5])
    a = ap.parse_args(argv)
    cfg_kw = dict(vocab_size=30522, hidden_size=a.hidden,
                  num_layers=a.layers, num_heads=max(a.hidden // 64, 1),
                  intermediate_size=4 * a.hidden,
                  max_position_embeddings=max(512, a.seq),
                  hidden_dropout=0.0, attention_dropout=0.0)
    arrays = batch(30522, a.batch, a.seq)
    for lr in a.lr:
        port, ref = losses(cfg_kw, arrays, lr)
        print(f"hidden {a.hidden}, {a.layers} layers, {a.batch} x {a.seq}, "
              f"lr {lr}: port {port}, JAX {ref}", flush=True)


if __name__ == "__main__":
    main()
