"""Card-only tests of the quantization, sparsity and op long-tail slice
(marked ``cuda``; they skip without a card).  No JAX here: the
references are the port on the CPU and exact integer products.

* the int8 route: `Int8Conv2D` (the 7x7 stem of ResNet-50, stride 2) and
  `Int8Linear` (K = 1200, past f32's exact range for int8 products) run
  ``torch._int_mm`` on the card (the ``cuda`` count), with s32
  accumulators equal to the CPU's and to an int64 product;
* the masks of a pruned model stay on the card and hold through a step
  of the decorated optimizer;
* the Viterbi path and the hash ids on the card equal the CPU's, and a
  control-flow predicate read inside a CUDA-graph capture raises with
  its reason.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
import paddle_tpu_torch.quantization as TQ
import paddle_tpu_torch.quantization.int8 as TQ8
import paddle_tpu_torch.sparsity as TS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 route is torch._int_mm "
                    "on the card")


def _half_levels(g, scale, shape):
    """Values on exact round-half points of the int8 grid, and others."""
    k = torch.randint(-126, 126, shape, generator=g).double()
    v = torch.where(torch.rand(shape, generator=g) < 0.5,
                    (k + 0.5) * scale / 127.0,
                    (torch.rand(shape, generator=g) * 2 - 1) * scale)
    return v.float()


@pytest.mark.cuda
def test_int8_route_on_the_card(card):
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(64, 3, 7, 7, generator=g), torch.randn(64, generator=g)
    x = _half_levels(g, 1.5, (8, 3, 64, 64))
    cpu = TQ.Int8Conv2D(w, b, torch.tensor(1.5), 2, 3, 1, 1, "NCHW")
    card_layer = TQ.Int8Conv2D(w.cuda(), b.cuda(), torch.tensor(1.5), 2, 3,
                               1, 1, "NCHW")
    TQ8.reset_counts()
    acc = card_layer.accumulate(x.cuda()).cpu()
    assert TQ8.counts() == {"linear": 0, "conv": 1, "cuda": 1}
    assert torch.equal(acc, cpu.accumulate(x))
    qx = TQ8.quantize_act(x, torch.tensor(1.5))
    ref = torch.nn.functional.conv2d(qx.double(), cpu.qweight.double(),
                                     stride=2, padding=3)
    assert torch.equal(acc.long(), ref.round().long())
    lw = torch.randn(1200, 40, generator=g)
    xl = _half_levels(g, 2.0, (33, 1200))
    lin = TQ.Int8Linear(lw, None, torch.tensor(2.0))
    got = TQ.Int8Linear(lw.cuda(), None, torch.tensor(2.0)).accumulate(
        xl.cuda()).cpu()
    want = TQ8.quantize_act(xl, torch.tensor(2.0)).long() @ \
        lin.qweight.long()
    assert torch.equal(got.long(), want)
    assert torch.equal(got, lin.accumulate(xl))


@pytest.mark.cuda
def test_masks_stay_on_the_card(card):
    T.seed(0)
    m = T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                        T.nn.Linear(16, 4)).cuda()
    masks = TS.prune_model(m)
    opt = TS.decorate(T.optimizer.SGD(0.1, parameters=m.parameters()), m)
    (m(torch.rand(4, 8, device="cuda")) ** 2).mean().backward()
    opt.step()
    dev = TS.ASPHelper._masks[m]
    for name in ("0.weight", "2.weight"):
        assert dev[name].is_cuda
        p = dict(m.named_parameters())[name]
        assert TS.check_mask(p)
        assert torch.equal((p == 0).cpu(),
                           torch.from_numpy(masks[name] == 0) | (p == 0).cpu())


@pytest.mark.cuda
def test_long_tail_on_the_card(card):
    g = torch.Generator().manual_seed(1)
    em = torch.round(torch.randn(4, 12, 5, generator=g) * 2) / 2
    trans = torch.round(torch.randn(7, 5, generator=g) * 2) / 2
    ln = torch.tensor([12, 3, 7, 1])
    cpu = T.crf_decoding(em, trans, length=ln)
    assert torch.equal(T.crf_decoding(em.cuda(), trans.cuda(),
                                      length=ln.cuda()).cpu(), cpu)
    x = torch.randint(0, 2 ** 30, (6, 5), generator=g)
    assert torch.equal(T.hash_op(x.cuda(), 2, 1000).cpu(),
                       T.hash_op(x, 2, 1000))
    pred = torch.ones((), device="cuda")
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            T.ops.control_flow.cond(pred > 0, lambda: pred, lambda: -pred)
