"""Card-only tests of the data-parallel slice (marked ``cuda``; they skip
without a card).  No JAX here: the references are plain PyTorch.

* two ranks of a small GPT on the card's backend (the rule: NCCL with a
  card a rank, gloo staged through host memory when they share one),
  `DataParallel` against one process on the whole batch, bf16 AMP
  through kernels K3/K4: losses within 1e-3 relative;
* the device trace (`profiler.start_trace`/`stop_trace`) of a flash
  attention forward and backward names the K3/K4 kernels.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           max_seq_len=256, use_parallel_layers=False, dropout=0.0)
STEPS = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K3/K4 and the card's "
                    "backend have no CPU mode")


def _batch():
    g = torch.Generator().manual_seed(0)
    return (torch.randint(0, 512, (8, 256), generator=g),
            torch.randint(0, 512, (8, 256), generator=g))


def _loss(model, x, y):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    with amp.auto_cast(dtype="bfloat16"):
        logits = model(x)
    return F.cross_entropy(logits, y)


def dp_card_rank(out):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa

    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = GPT.random(GPTConfig(**CFG), seed=1, device=dev)
    dp = dist.DataParallel(model)
    opt = optimizer.AdamW(1e-3, parameters=model.parameters())
    x, y = (t.to(dev) for t in _batch())
    s = x.shape[0] // n
    fa.flash_attention_cuda_fwd.launches = 0
    losses = []
    for _ in range(STEPS):
        loss = _loss(dp, x[r * s:(r + 1) * s], y[r * s:(r + 1) * s])
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().clone()
        dist.all_reduce(g, op="avg")
        losses.append(float(g))
    with open(f"{out}.{r}", "w") as f:
        json.dump({"losses": losses, "backend": dist.parallel.backend(),
                   "k3": fa.flash_attention_cuda_fwd.launches}, f)


@pytest.mark.cuda
def test_data_parallel_on_the_card(card, tmp_path):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    model = GPT.random(GPTConfig(**CFG), seed=1, device="cuda")
    opt = optimizer.AdamW(1e-3, parameters=model.parameters())
    x, y = (t.cuda() for t in _batch())
    want = []
    for _ in range(STEPS):
        loss = _loss(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.detach()))
    out = str(tmp_path / "rank")
    dist.spawn(dp_card_rank, args=(out,), nprocs=2)
    res = [json.load(open(f"{out}.{r}")) for r in range(2)]
    expect = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for got in res:
        assert got["backend"] == expect
        assert got["k3"] == CFG["num_layers"] * STEPS
        for a, b in zip(got["losses"], want):
            assert abs(a - b) <= 1e-3 * abs(b)


@pytest.mark.cuda
def test_device_trace_names_flash_kernels(card, tmp_path):
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v = (torch.randn(2, 4, 256, 64, device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    with profiler.trace(str(tmp_path)):
        flash_attention_fwd(q, k, v, is_causal=True).sum().backward()
    (path,) = tmp_path.glob("trace_*.json")
    names = [e.get("name", "") for e in json.loads(path.read_text())[
        "traceEvents"]]
    for kern in ("fwd_kernel", "dkv_kernel", "dq_kernel"):
        assert any(kern in n for n in names), kern
