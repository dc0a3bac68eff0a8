"""Where a GPT-2-small train step spends its time on the card.

    python -m paddle_tpu_torch.tools.train_profile [--pallas-layernorm]
        [--out chiprun_out/train_profile.json]

Trains the workload of ``chip_smoke.py``'s train phase
(`gpt2_small_train`: ``bench.py``'s configuration — GPT-2-small at full
width, random weights from seed 0, batch 16 x 1024 random tokens,
AdamW(1e-4, weight decay 0.01), the forward under bf16 `amp.auto_cast`
and the cross entropy outside it — through `jit.TrainStep`; with
``--pallas-layernorm``, ``FLAGS_use_pallas_layernorm`` on, so every
LayerNorm forward runs kernel K5) for
`STEPS` steps plain, for the wall time, and `PROFILED_STEPS` more under
``torch.profiler`` for the breakdown.  Prints, and writes to ``--out``:
tokens/s and the mean step time of the plain run, the device's busy time
and idle share over the profiled steps, and the kernels and PyTorch
operators that took the most device time.  Needs a CUDA card; raises
without one.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import amp
from ..core import flags
from ..device import default_device
from ..jit import train_step
from ..models.gpt import GPT, GPTConfig
from ..nn.functional.loss import cross_entropy
from ..optimizer import AdamW
from ._device_time import breakdown, card_line

SEED = 0
BATCH, SEQ = 16, 1024
WARMUP_STEPS = 2
STEPS = 10
PROFILED_STEPS = 3


def amp_loss_fn(model, tokens, labels):
    """``bench.py``'s loss: the forward under bf16 autocast, the cross
    entropy of the bf16 logits outside it."""
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        logits = model(tokens)
    return cross_entropy(logits, labels, reduction="mean")


def gpt2_small_train(device):
    """The GPT-2-small training of ``chip_smoke.py`` and of this profile.

    Returns ``(model, step, tokens, labels, warmup_losses)``: the model
    (random f32 weights from `SEED`), its `jit.TrainStep` with AdamW and
    `amp_loss_fn`, one fixed batch of random int32 tokens and labels from
    a numpy seed, and the losses of the `WARMUP_STEPS` steps already
    taken, so that cuBLAS's handles and the first load of every kernel
    stay out of any timing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small_config()
    model = GPT.random(cfg, seed=SEED, device=device)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    step = train_step(model, amp_loss_fn, opt)
    tokens, labels = train_batch(cfg, device)
    losses = [float(step(tokens, labels)) for _ in range(WARMUP_STEPS)]
    return model, step, tokens, labels, losses


def gpt2_small_config() -> GPTConfig:
    """``bench.py``'s GPT-2-small: vocab 50304, 768 wide, 12 layers and
    heads, 1024 positions."""
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=1024,
                     use_parallel_layers=False)


def train_batch(cfg, device):
    """The train's fixed batch: `BATCH` x `SEQ` random int32 tokens and
    labels from a numpy seed (`SEED`)."""
    rng = np.random.default_rng(SEED)
    return tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)).to(device)
        for _ in range(2))


def _train(step, tokens, labels, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(tokens, labels)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, float(loss)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pallas-layernorm", action="store_true")
    ap.add_argument("--out", default="chiprun_out/train_profile.json")
    args = ap.parse_args(argv)

    flags.set_flags({"use_pallas_layernorm": args.pallas_layernorm})
    _, step, tokens, labels, _ = gpt2_small_train(default_device())
    wall, loss = _train(step, tokens, labels, STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, _ = _train(step, tokens, labels, PROFILED_STEPS)
    result = dict(
        device=torch.cuda.get_device_name(0), card=card_line(),
        pallas_layernorm=args.pallas_layernorm, batch=BATCH, seq=SEQ, steps=STEPS, wall_s=wall,
        tokens_per_s=BATCH * SEQ * STEPS / wall,
        mean_step_ms=wall / STEPS * 1e3, last_loss=loss,
        profiled_steps=PROFILED_STEPS, profiled_wall_s=wall_prof,
        **breakdown(prof, wall_prof))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
