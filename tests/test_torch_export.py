"""Cross-loading ProgramDescs between the JAX package and the port
(`paddle_tpu_torch/static/{program,fx_export,__init__}.py`, the
Predictor).

- JAX writes, the port runs: `paddle_tpu.static.save_inference_model`
  (the sequential emitter, and the jaxpr exporter on a tiny ResNet-18
  and a tiny BERT) -> the port's `load_inference_model`, `Executor` and
  Predictor on the CPU, equal to the JAX package's Predictor on the same
  files (also from the legacy ``dir/__model__`` layout).
- The port writes, JAX runs: the port's `save_inference_model` (the
  sequential emitter, and `fx_export` on a tiny ResNet-18, ViT and
  BERT, the JAX models' weights loaded into the port's) -> the JAX
  package's `load_inference_model` and Predictor, equal to the port's
  eager forward; a bidirectional two-layer LSTM exports as ONE ``rnn``
  op.  The JAX package parses the port's bytes and writes them back
  unchanged.
- An op the exporter has no mapping for raises naming it; a higher-order
  op (``torch.cond``) raises naming slice 4b.

Tolerance: f32 on the CPU, relative norm 1e-5 (XLA's and torch's CPU
kernels round differently; the deepest program here has 257 ops).
About 30 s alone (27-34 s), and under ``-n 6`` with the slice's other
files 138 s for all four.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import collections
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.inference as JINF
import paddle_tpu.models.bert  # noqa: F401
import paddle_tpu_torch.models.bert  # noqa: F401
import paddle_tpu.static as JS
import paddle_tpu_torch as T
import paddle_tpu_torch.inference as TINF
import paddle_tpu_torch.static as TS
from paddle_tpu_torch.core import place as TPL

from test_torch_vision_models import build

TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_predict(prefix, inputs):
    pred = JINF.create_predictor(JINF.Config(prefix + ".pdmodel"))
    return [np.asarray(o) for o in pred.run([np.asarray(i) for i in inputs])]


def port_predict(prefix, inputs, ir_optim=True):
    cfg = TINF.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    pred = TINF.create_predictor(cfg)
    for name, x in zip(pred.get_input_names(), inputs):
        pred.get_input_handle(name).copy_from_cpu(np.asarray(x))
    pred.run()
    return [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]


def op_types(prefix, pkg_static):
    prog, _, _ = pkg_static.load_inference_model(prefix)
    return collections.Counter(o["type"] for b in prog.desc["blocks"]
                               for o in b["ops"])


def images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def token_batch(seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(1, 100, (2, 16)).astype(np.int64)
    types = r.integers(0, 2, (2, 16)).astype(np.int64)
    return ids, types


def tiny_bert_cfg(pkg):
    return pkg.models.bert.BertConfig(
        vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=64)


# ---------------------------------------------------------------------------
# JAX writes, the port runs
# ---------------------------------------------------------------------------
def _jax_sequential():
    from paddle_tpu import nn

    P.seed(3)
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
                         nn.Linear(4 * 4 * 4, 5), nn.Softmax())


def test_jax_sequential_program_runs_in_port(tmp_path):
    prefix = str(tmp_path / "seq")
    jm = _jax_sequential()
    jm.eval()
    JS.save_inference_model(prefix, layer=jm, input_spec=[
        P.static.InputSpec([2, 3, 8, 8], "float32", "x")])
    x = images(2, 8)
    want = jax_predict(prefix, [x])
    assert relnorm(port_predict(prefix, [x])[0], want[0]) <= TOL
    prog, feeds, fetches = TS.load_inference_model(prefix)
    exe = TS.Executor(T.CPUPlace())
    exe.scope.update(prog._param_scope)
    got = exe.run(prog, feed={feeds[0]: torch.from_numpy(x)},
                  fetch_list=fetches)
    assert relnorm(got[0].numpy(), want[0]) <= TOL
    # the legacy layout: dir/__model__ + dir/__params__
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    shutil.copy(prefix + ".pdmodel", legacy / "__model__")
    shutil.copy(prefix + ".pdiparams", legacy / "__params__")
    prog2, feeds2, _ = TS.load_inference_model(str(legacy))
    assert feeds2 == feeds
    assert sorted(prog2._param_scope) == sorted(prog._param_scope)


def test_jax_traced_resnet_runs_in_port(tmp_path):
    prefix = str(tmp_path / "resnet")
    jm, _ = build(lambda pkg: pkg.vision.models.resnet18(num_classes=10))
    jm.eval()
    JS.save_inference_model(prefix, layer=jm, input_spec=[
        P.static.InputSpec([2, 3, 32, 32], "float32", "image")])
    x = images()
    want = jax_predict(prefix, [x])
    for ir in (True, False):
        assert relnorm(port_predict(prefix, [x], ir)[0], want[0]) <= TOL


def test_jax_traced_bert_runs_in_port(tmp_path):
    prefix = str(tmp_path / "bert")
    P.seed(5)
    jm = P.models.bert.BertModel(tiny_bert_cfg(P))
    jm.eval()
    JS.save_inference_model(prefix, layer=jm, input_spec=[
        P.static.InputSpec([2, 16], "int64", "input_ids"),
        P.static.InputSpec([2, 16], "int64", "token_type_ids")])
    ids, types = token_batch()
    want = jax_predict(prefix, [ids, types])
    got = port_predict(prefix, [ids, types])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert relnorm(g, w) <= TOL


# ---------------------------------------------------------------------------
# the port writes, JAX runs
# ---------------------------------------------------------------------------
def _port_writes(tmp_path, tm, specs, inputs, name):
    prefix = str(tmp_path / name)
    tm.eval()
    prog = TS.save_inference_model(prefix, layer=tm, input_spec=specs)
    with torch.no_grad():
        eager = tm(*[torch.from_numpy(i) for i in inputs])
    eager = eager if isinstance(eager, tuple) else (eager,)
    got = jax_predict(prefix, inputs)
    assert len(got) == len(eager)
    for g, e in zip(got, eager):
        assert relnorm(g, e.numpy()) <= TOL
    # the JAX package parses the port's bytes and writes them back
    raw = open(prefix + ".pdmodel", "rb").read()
    assert P.static.Program.parse_from_string(raw).serialize_to_string() \
        == raw == prog.serialize_to_string()
    return prefix


def test_port_sequential_program_runs_in_jax(tmp_path):
    from paddle_tpu_torch import nn

    T.seed(3)
    tm = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                       nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
                       nn.Linear(4 * 4 * 4, 5), nn.Softmax())
    prefix = _port_writes(tmp_path, tm, [TS.InputSpec([2, 3, 8, 8],
                                                      "float32", "x")],
                          [images(2, 8)], "seq")
    ops = op_types(prefix, JS)
    assert ops["conv2d"] == 1 and ops["batch_norm"] == 1


def test_port_resnet_program_runs_in_jax(tmp_path):
    _, tm = build(lambda pkg: pkg.vision.models.resnet18(num_classes=10))
    prefix = _port_writes(tmp_path, tm, [TS.InputSpec([2, 3, 32, 32],
                                                      "float32", "image")],
                          [images()], "resnet")
    ops = op_types(prefix, TS)
    assert ops["conv2d"] == 20 and ops["pool2d"] == 1
    # the port's own Predictor, captured or op by op, agrees
    with torch.no_grad():
        want = tm(torch.from_numpy(images())).numpy()
    for ir in (True, False):
        assert relnorm(port_predict(prefix, [images()], ir)[0], want) <= TOL


def test_port_vit_program_runs_in_jax(tmp_path):
    _, tm = build(lambda pkg: pkg.vision.models.vit.VisionTransformer(
        image_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
        num_heads=4))
    _port_writes(tmp_path, tm, [TS.InputSpec([2, 3, 32, 32], "float32",
                                             "image")], [images()], "vit")


def test_port_bert_program_runs_in_jax(tmp_path):
    _, tm = build(lambda pkg: pkg.models.bert.BertModel(tiny_bert_cfg(pkg)))
    ids, types = token_batch()
    _port_writes(tmp_path, tm, [TS.InputSpec([2, 16], "int64", "ids"),
                                TS.InputSpec([2, 16], "int64", "types")],
                 [ids, types], "bert")


def test_port_lstm_exports_one_rnn_op(tmp_path):
    from paddle_tpu_torch import nn

    class Tagger(nn.Layer):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTM(8, 16, num_layers=2, direction="bidirect")
            self.head = nn.Linear(32, 3)

        def forward(self, x):
            out, (h, c) = self.rnn(x)
            return self.head(out), h

    T.seed(1)
    x = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(
        np.float32)
    prefix = _port_writes(tmp_path, Tagger(),
                          [TS.InputSpec([2, 5, 8], "float32", "x")], [x],
                          "lstm")
    ops = op_types(prefix, JS)
    assert ops["rnn"] == 1
    assert not ops["matmul_v2"] - 1  # the head only: no unrolled cells


class _Mixed(torch.nn.Module):
    """One of most of the exporter's handlers: pools, splits, sorts,
    reductions, comparisons, casts, clamps, pads, gathers and scalars."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(4, 6, generator=g))
        self.register_buffer("table", torch.randn(10, 3, generator=g))

    def forward(self, x, ids):
        h = torch.nn.functional.avg_pool2d(x, 2, 2)             # [2,3,4,4]
        h = torch.nn.functional.adaptive_avg_pool2d(h, (2, 2))
        h = torch.nn.functional.leaky_relu(h, 0.1).flatten(1)   # [2,12]
        a, b = torch.split(h, [5, 7], dim=1)
        v, i = torch.topk(a, 3)
        s, si = torch.sort(b, dim=1, descending=True)
        m = torch.where(a > 0, a, a * a).cumsum(1)
        e = self.table.index_select(0, ids) + x.mean((2, 3)).amax(
            1, keepdim=True)
        p = torch.nn.functional.pad(e, (1, 2), value=-0.5)
        c = torch.clamp(p, -1.0, 1.0) ** 3 / 2.0 - torch.floor(p)
        q = (a[:, :4] @ self.w).sum(1, keepdim=True).argmax(0)
        z = (b.max(dim=1).values // 0.25).to(torch.int32)
        return (v, i, s, si.to(torch.int32), m, c, q, z,
                torch.cat([a.exp(), b.sigmoid()], 1))


def test_mixed_ops_program_runs_in_jax(tmp_path):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 3, 8, 8)).astype(np.float32)
    ids = np.asarray([3, 7], np.int64)
    _port_writes(tmp_path, _Mixed(),
                 [TS.InputSpec([2, 3, 8, 8], "float32", "x"),
                  TS.InputSpec([2], "int64", "ids")], [x, ids], "mixed")


def test_unmapped_op_raises_naming_it():
    class Bessel(torch.nn.Module):
        def forward(self, x):
            return torch.special.i0(x)

    with pytest.raises(NotImplementedError, match="i0"):
        TS.program_from_layer(Bessel(), [TS.InputSpec([3], "float32")], {})


def test_higher_order_op_raises_naming_4b():
    class Branch(torch.nn.Module):
        def forward(self, x):
            return torch.cond(x.sum() > 0, lambda v: v * 2, lambda v: v - 1,
                              (x,))

    with pytest.raises(NotImplementedError, match="4b"):
        TS.program_from_layer(Branch(), [TS.InputSpec([3], "float32")], {})
