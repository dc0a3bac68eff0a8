"""The port's `jit` (`to_static`, `save`, `load`, `TracedLayer`), the
inference API (`Config`, `Predictor`, the zero-copy handles, `clone`)
and the static API around them, against the JAX package on the CPU.

- `jit.save` -> `jit.load`/`create_predictor` on LeNet equals the JAX
  package's `jit.save` -> Predictor on the same weights (relative norm
  1e-5, f32 on the CPU), for ``switch_ir_optim`` on and off; the
  ``.pdmodel`` is `torch.export`'s zip and the ``.pdiparams`` the JAX
  package's pickle layout.
- A JAX StableHLO ``.pdmodel`` raises ValueError naming the format, in
  `jit.load`, `load_inference_model` and the Predictor.
- The handles (`copy_from_cpu`, `set_lod`/`lod`, `copy_to_cpu`,
  `shape`), `get_output_names` before `run` raising, `clone` sharing
  the runner and owning its state, `enable_tpu` raising, a LoD program
  (`sequence_pool`) equal to the JAX Predictor with the same LoD.
- `Model.save(training=False)` and `save_quantized_model` now export
  through `jit.save` (their item-4 stubs closed), equal to the eager
  forward and to the JAX package's export of the same weights.
- `to_static`'s signature cache and `concrete_programs`, `TracedLayer`,
  `static`'s default programs, places, `data`, and the slice-4b names
  raising.  The flags: all sixty of the JAX package's names and
  defaults; `interp_tensor_array_capacity` sizes a `while`'s arrays.

About 15-20 s alone; under ``-n 6`` with the slice's other files 138 s
for all four.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.inference as JINF
import paddle_tpu.jit as JJ
import paddle_tpu.quantization as JQ
import paddle_tpu_torch as T
import paddle_tpu_torch.inference as TINF
import paddle_tpu_torch.jit as TJ
import paddle_tpu_torch.quantization as TQ
import paddle_tpu_torch.static as TS
from paddle_tpu.core import flags as JF
from paddle_tpu_torch.core import flags as TF
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


def digits(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, 28, 28)).astype(np.float32)


def port_pred(prefix, ir_optim=True):
    cfg = TINF.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return TINF.create_predictor(cfg)


def jax_outputs(prefix, inputs):
    pred = JINF.create_predictor(JINF.Config(prefix + ".pdmodel"))
    return [np.asarray(o) for o in pred.run(inputs)]


@pytest.fixture(scope="module")
def lenet():
    with TPL.expected_device("cpu"):
        jm, tm = build(lambda pkg: pkg.vision.models.LeNet(num_classes=10))
    jm.eval()
    tm.eval()
    return jm, tm


# ---------------------------------------------------------------------------
# jit.save / load and the Predictor on both formats
# ---------------------------------------------------------------------------
def test_jit_save_load_matches_jax(lenet, tmp_path):
    jm, tm = lenet
    x = digits()
    JJ.save(jm, str(tmp_path / "j"),
            input_spec=[P.static.InputSpec([4, 1, 28, 28], "float32")])
    want = jax_outputs(str(tmp_path / "j"), [x])[0]
    TJ.save(tm, str(tmp_path / "t"),
            input_spec=[TS.InputSpec([None, 1, 28, 28], "float32")])
    raw = open(tmp_path / "t.pdmodel", "rb").read()
    assert raw[:4] == b"PK\x03\x04" and TJ.sniff_pdmodel(raw) == "archive"
    import pickle

    meta = pickle.load(open(tmp_path / "t.pdiparams", "rb"))
    assert set(meta) == {"params", "buffers", "pnames", "bnames"}
    assert meta["pnames"] == sorted(dict(tm.named_parameters()))
    loaded = TJ.load(str(tmp_path / "t"), device="cpu")
    # None dims became 1, as in the JAX package: the archive takes batch 1
    assert loaded.n_inputs() == 1
    one = loaded(torch.from_numpy(x[:1]))
    assert relnorm(one.numpy(), want[:1]) <= TOL
    TJ.save(tm, str(tmp_path / "t4"),
            input_spec=[TS.InputSpec([4, 1, 28, 28], "float32")])
    for ir in (True, False):
        pred = port_pred(str(tmp_path / "t4"), ir)
        assert pred.get_input_names() == ["input_0"]
        (got,) = pred.run([x])
        assert relnorm(got, want) <= TOL
        assert pred.graph_count() == 0  # the CPU runs op by op


def test_jax_stablehlo_pdmodel_raises_naming_the_format(lenet, tmp_path):
    jm, _ = lenet
    JJ.save(jm, str(tmp_path / "j"),
            input_spec=[P.static.InputSpec([1, 1, 28, 28], "float32")])
    raw = open(tmp_path / "j.pdmodel", "rb").read()
    assert TJ.sniff_pdmodel(raw) == "unknown"
    with pytest.raises(ValueError, match="StableHLO"):
        TJ.load(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="StableHLO"):
        TS.load_inference_model(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="StableHLO"):
        port_pred(str(tmp_path / "j"))


def test_handles_clone_and_config(lenet, tmp_path):
    _, tm = lenet
    prefix = str(tmp_path / "p")
    TS.save_inference_model(prefix, layer=tm, input_spec=[
        TS.InputSpec([4, 1, 28, 28], "float32", "image")])
    pred = port_pred(prefix)
    # a program names its fetch targets at load; an archive's outputs
    # are known only once it ran (as the JAX package's two formats)
    assert pred.get_output_names() == ["output_0"]
    TJ.save(tm, str(tmp_path / "a"),
            input_spec=[TS.InputSpec([4, 1, 28, 28], "float32")])
    with pytest.raises(RuntimeError, match="run"):
        port_pred(str(tmp_path / "a")).get_output_names()
    h = pred.get_input_handle("image")
    x = digits()
    h.copy_from_cpu(x)
    assert h.shape() == [4, 1, 28, 28]
    with pytest.raises(RuntimeError):
        h.copy_to_cpu()
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")
    twin = pred.clone()
    pred.run()
    out = pred.get_output_handle("output_0")
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    assert relnorm(out.copy_to_cpu(), want) <= TOL
    assert out.shape() == [4, 10]
    with pytest.raises(RuntimeError):
        out.copy_from_cpu(x)
    # the clone shares the runner, owns its state
    assert twin._runner is pred._runner
    with pytest.raises(RuntimeError, match="run"):
        twin.get_output_handle("output_0").copy_to_cpu()
    (got,) = twin.run([x[::-1].copy()])
    assert relnorm(got, want[::-1]) <= TOL
    cfg = TINF.Config(prefix + ".pdmodel")
    assert cfg.use_gpu()  # the card by default
    with pytest.raises(ValueError, match="TPU"):
        cfg.enable_tpu()
    cfg.disable_gpu()
    cfg.enable_memory_optim()
    cfg.enable_tensorrt_engine()
    assert not cfg.use_gpu() and cfg.params_file() == prefix + ".pdiparams"
    (again,) = TINF.create_predictor(cfg).run([x])
    assert relnorm(again, want) <= TOL


def _seq_pool_program(pkg):
    prog = pkg.static.Program()
    blk = prog.global_block()
    blk.create_var("feed", type=pkg.static.proto.VarType.FEED_MINIBATCH,
                   persistable=True)
    blk.create_var("fetch", type=pkg.static.proto.VarType.FETCH_LIST,
                   persistable=True)
    blk.create_var("x", shape=[3, 4, 2], dtype="float32")
    blk.append_op("feed", {"X": "feed"}, {"Out": "x"}, {"col": 0})
    blk.append_op("sequence_softmax", {"X": "x"}, {"Out": "s"}, {})
    blk.append_op("sequence_pool", {"X": "s"}, {"Out": "y"},
                  {"pooltype": "SUM"})
    blk.append_op("fetch", {"X": "s"}, {"Out": "fetch"}, {"col": 0})
    blk.append_op("fetch", {"X": "y"}, {"Out": "fetch"}, {"col": 1})
    return prog


def test_set_lod_matches_jax(tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 4, 2)).astype(
        np.float32)
    lod = [[0, 4, 6, 9]]  # offsets: lengths 4, 2, 3
    outs = {}
    for name, pkg, inf in (("j", P, JINF), ("t", T, TINF)):
        prefix = str(tmp_path / name)
        pkg.static.save_inference_model(prefix,
                                        program=_seq_pool_program(pkg))
        cfg = inf.Config(prefix + ".pdmodel")
        if pkg is T:
            cfg.disable_gpu()
        pred = inf.create_predictor(cfg)
        h = pred.get_input_handle("x")
        h.copy_from_cpu(x)
        h.set_lod(lod)
        assert h.lod() == lod
        pred.run()
        outs[name] = [pred.get_output_handle(n) for n in
                      pred.get_output_names()]
    for j, t in zip(outs["j"], outs["t"]):
        assert relnorm(t.copy_to_cpu(), np.asarray(j.copy_to_cpu())) <= TOL
        assert t.lod() == j.lod()
    assert outs["t"][0].lod() == lod


# ---------------------------------------------------------------------------
# the item-4 stubs, closed
# ---------------------------------------------------------------------------
def test_model_save_for_inference(lenet, tmp_path):
    jm, tm = lenet
    x = digits()
    spec = [4, 1, 28, 28]
    P.Model(jm, inputs=[P.static.InputSpec(spec, "float32")]).save(
        str(tmp_path / "j"), training=False)
    T.Model(tm, inputs=[TS.InputSpec(spec, "float32")]).save(
        str(tmp_path / "t"), training=False)
    (got,) = port_pred(str(tmp_path / "t")).run([x])
    with torch.no_grad():
        assert relnorm(got, tm(torch.from_numpy(x)).numpy()) <= TOL
    assert relnorm(got, jax_outputs(str(tmp_path / "j"), [x])[0]) <= TOL


def test_save_quantized_model(tmp_path):
    jm, tm = build(lambda pkg: pkg.vision.models.LeNet(num_classes=10),
                   seed=1)
    JQ.ImperativeQuantAware().quantize(jm)
    TQ.ImperativeQuantAware().quantize(tm)
    jm.eval()
    tm.eval()
    x = digits(seed=2)
    spec = [4, 1, 28, 28]
    JQ.ImperativeQuantAware().save_quantized_model(
        jm, str(tmp_path / "j"),
        input_spec=[P.static.InputSpec(spec, "float32")])
    TQ.ImperativeQuantAware().save_quantized_model(
        tm, str(tmp_path / "t"), input_spec=[TS.InputSpec(spec, "float32")])
    (got,) = port_pred(str(tmp_path / "t")).run([x])
    with torch.no_grad():
        assert relnorm(got, tm(torch.from_numpy(x)).numpy()) <= TOL
    assert relnorm(got, jax_outputs(str(tmp_path / "j"), [x])[0]) <= 1e-4


# ---------------------------------------------------------------------------
# to_static, TracedLayer, the static API
# ---------------------------------------------------------------------------
def test_to_static_signature_cache(lenet):
    _, tm = lenet
    sf = TJ.to_static(lambda a, k=2.0: a * k)
    x3, x4 = torch.ones(3), torch.ones(4)
    assert sf(x3).tolist() == [2.0] * 3
    sf(x3)
    sf(x4, k=3.0)
    sf(x4)
    # the JAX package's key: tensor shapes and dtypes, the other
    # arguments, the keywords, the layer's training flag
    assert len(sf.concrete_programs) == 3
    assert [s.shape for s in sf.concrete_programs[0].inputs] == [[3]]
    net = T.vision.models.LeNet(num_classes=10).eval()
    x = torch.from_numpy(digits(2))
    with torch.no_grad():
        want = net(x)
        TJ.declarative(net)
        assert isinstance(net.forward, TJ.StaticFunction)
        assert torch.equal(net(x), want)
        out, traced = TJ.TracedLayer.trace(net, [x])
        assert torch.equal(out, want) and torch.equal(traced(x), want)
    def helper(v):
        return v

    assert TJ.not_to_static(helper)._paddle_not_to_static


def test_static_api_and_the_next_slice():
    main, start = TS.Program(), TS.Program()
    assert TS.default_main_program() is not main
    with TS.program_guard(main, start):
        assert TS.default_main_program() is main
        assert TS.default_startup_program() is start
    assert TS.default_main_program() is not main
    assert TS.cpu_places() == [T.CPUPlace(0)]
    assert TS.cuda_places() == [T.CUDAPlace(i) for i in
                                range(torch.cuda.device_count())]
    spec = TS.data("x", [None, 4], "int64")
    assert spec.name == "x" and spec.dtype == torch.int64
    assert TS.Executor().run(lambda x: x + 1, feed={"x": 1}) == [2]
    for call in (lambda: TS.append_backward(None),
                 lambda: TS.gradients([], []),
                 lambda: TS.Executor().train_from_dataset(None, None)):
        with pytest.raises(NotImplementedError, match="4b"):
            call()
    assert TS.nn.cond(torch.tensor(True), lambda: 1, lambda: 2) == 1


def test_public_names_cover_jax():
    """Every class and function the JAX package's `jit`, `inference` and
    `static` define (in the module or its package) or list in
    ``__all__`` has a port counterpart (`static`'s `append_backward` and
    `gradients` raise, naming slice 4b)."""
    import importlib.util
    import inspect

    import paddle_tpu.static as JSt

    for jmod, tmod in ((JJ, TJ), (JINF, TINF), (JSt, TS)):
        want = {n for n in dir(jmod) if not n.startswith("_") and (
            inspect.isclass(getattr(jmod, n)) or
            inspect.isfunction(getattr(jmod, n))) and getattr(
            getattr(jmod, n), "__module__", "").startswith(jmod.__name__)}
        want |= set(getattr(jmod, "__all__", []))
        missing = sorted(n for n in want if not hasattr(tmod, n)
                         and importlib.util.find_spec(
                             f"{tmod.__name__}.{n}") is None)
        assert missing == [], (jmod.__name__, missing)


def test_flags_are_the_jax_packages():
    assert set(TF._REGISTRY) == set(JF._REGISTRY)
    assert all(TF.flag(k) == JF.flag(k) for k in JF._REGISTRY)
    for name, other in (("allocator_strategy", "bfc"),
                        ("pallas_attention_min_seq", 128)):
        with pytest.raises(ValueError, match="CUDA|K3"):
            TF.set_flags({name: other})


def _while_array_program(pkg):
    """A `while` writing a TensorArray at the loop counter, its bound a
    feed (no constant to infer the capacity from)."""
    prog = pkg.static.Program()
    g = prog.global_block()
    V = pkg.static.proto.VarType
    g.create_var("feed", type=V.FEED_MINIBATCH, persistable=True)
    g.create_var("fetch", type=V.FETCH_LIST, persistable=True)
    g.append_op("feed", {"X": "feed"}, {"Out": "n"}, {"col": 0})
    g.append_op("fill_constant", {}, {"Out": "i"},
                {"shape": [1], "dtype": 3, "value": 0.0})
    g.append_op("less_than", {"X": "i", "Y": "n"}, {"Out": "c"}, {})
    sub = prog.create_block(0)
    sub.append_op("cast", {"X": "i"}, {"Out": "f"},
                  {"in_dtype": 3, "out_dtype": 5})
    sub.append_op("write_to_array", {"X": "f", "I": "i"}, {"Out": "arr"},
                  {})
    sub.append_op("increment", {"X": "i"}, {"Out": "i"}, {"step": 1.0})
    sub.append_op("less_than", {"X": "i", "Y": "n"}, {"Out": "c"}, {})
    op = g.append_op("while", {"X": ["n"], "Condition": "c"},
                     {"Out": ["i", "arr"]}, {"is_test": True})
    op.desc["attrs"].append({"name": "sub_block", "type": 8,
                             "block_idx": 1})
    g.append_op("tensor_array_to_tensor", {"X": "arr"},
                {"Out": "y", "OutIndex": "yi"},
                {"axis": 0, "use_stack": True})
    g.append_op("fetch", {"X": "y"}, {"Out": "fetch"}, {"col": 0})
    return prog


def test_tensor_array_capacity_flag_sizes_a_while(tmp_path):
    n = np.asarray([3], np.int64)
    prog = _while_array_program(T)
    from paddle_tpu_torch.static.interp import ProgramRunner

    with pytest.raises(NotImplementedError, match="capacity"):
        ProgramRunner(prog, {}, jit=False, device="cpu")(n)
    TF.set_flags({"interp_tensor_array_capacity": 8})
    JF.set_flags({"interp_tensor_array_capacity": 8})
    try:
        (got,) = ProgramRunner(prog, {}, jit=False, device="cpu")(n)
        from paddle_tpu.static.interp import ProgramRunner as JRunner

        (want,) = JRunner(_while_array_program(P), {}, jit=False)(n)
    finally:
        TF.set_flags({"interp_tensor_array_capacity": 0})
        JF.set_flags({"interp_tensor_array_capacity": 0})
    assert got.tolist() == np.asarray(want).tolist() == [[0.0], [1.0],
                                                         [2.0]]


def test_rnn_marker_is_never_executed():
    from paddle_tpu_torch.static.export_marker import rnn_marker

    x = torch.zeros(1, 2, 3)
    h = torch.zeros(1, 1, 4)
    with pytest.raises(RuntimeError, match="never executed"):
        rnn_marker(x, h, h, [], "GRU", 4, 1, False, False, 0.0)
