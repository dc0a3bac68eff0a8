"""Card-only tests of the deployment slice (marked ``cuda``; they skip
without a card).  No JAX here: the references are the port's own plain
versions on the CPU.

* The K3 custom op inside a `jit.save`d ViT encoder launches the kernel
  (``flash_attention_cuda_fwd.launches`` grows by the depth a forward)
  and matches the model's CPU forward; a captured Predictor replays it,
  adding the captured launches to the counter at each replay.
* A captured `ProgramRunner` (one CUDA graph a feed signature) replays
  equal to its op-by-op run of the same program.
* What a replay hands out is the caller's: a fetch kept from one run
  (`Executor.run`, `ProgramRunner`, the archive's runner) is unchanged
  after later runs on other feeds, and so is a persistable written back
  into the Executor's scope.
* Two Predictor clones sharing one captured graph, run from two threads
  on different inputs, each get their own outputs.
* An int8-converted model keeps its ``torch._int_mm`` products in the
  exported graph and matches its eager forward.
* Under ``FLAGS_use_pallas_layernorm`` a `jit.save`d LayerNorm binds
  K5's custom op, which launches the kernel and matches its plain
  version.
* A translator that reads a device value on the host inside a capture
  raises.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
import paddle_tpu_torch.inference as TINF
import paddle_tpu_torch.jit as TJ
import paddle_tpu_torch.static as TS
from paddle_tpu_torch.core import place as TPL
from paddle_tpu_torch.ops.flash_attention import flash_attention_cuda_fwd


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K3 and CUDA graphs run on "
                    "the card")
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield torch.device("cuda")
    TPL._EXPECTED_DEVICE[0] = prev


def relnorm(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _vit(depth=2):
    T.seed(0)
    return T.vision.models.vit.VisionTransformer(
        image_size=32, patch_size=8, num_classes=10, embed_dim=64,
        depth=depth, num_heads=1).eval()


@pytest.mark.cuda
def test_k3_custom_op_in_an_exported_program(card, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _vit()
    x = torch.randn(4, 3, 32, 32)
    with torch.no_grad():
        want = cpu(x)
    net = _vit().to(card)
    TJ.save(net, str(tmp_path / "vit"),
            input_spec=[TS.InputSpec([4, 3, 32, 32], "float32")])
    exported = TJ.load(str(tmp_path / "vit"))
    ops = [str(n.target) for n in exported._exported.graph.nodes]
    assert ops.count("paddle_tpu_torch.flash_attention_fwd.default") == 2
    before = flash_attention_cuda_fwd.launches
    got = exported(x.to(card))
    torch.cuda.synchronize()
    assert flash_attention_cuda_fwd.launches - before == 2
    # f32 SIMT kernel against the composed CPU form: 1e-5 relative
    assert relnorm(got, want) <= 1e-5
    cfg = TINF.Config(str(tmp_path / "vit.pdmodel"))
    pred = TINF.create_predictor(cfg)
    for i in range(3):  # warm-up + capture, then two replays
        before = flash_attention_cuda_fwd.launches
        (out,) = pred.run([x.numpy()])
        assert flash_attention_cuda_fwd.launches - before == 2
        assert relnorm(torch.from_numpy(out), want) <= 1e-5
    assert pred.graph_count() == 1


@pytest.mark.cuda
def test_captured_program_replays_equal_to_eager(card, tmp_path):
    torch.backends.cudnn.allow_tf32 = False
    net = T.vision.models.resnet18(num_classes=10).eval()
    prefix = str(tmp_path / "r")
    TS.save_inference_model(prefix, layer=net, input_spec=[
        TS.InputSpec([2, 3, 32, 32], "float32", "image")])
    prog, _, _ = TS.load_inference_model(prefix)
    from paddle_tpu_torch.static.interp import ProgramRunner

    captured = ProgramRunner(prog, prog._param_scope, jit=True)
    eager = ProgramRunner(prog, prog._param_scope, jit=False)
    xs = [torch.randn(2, 3, 32, 32) for _ in range(3)]
    for x in xs:
        (a,) = captured(x)
        (b,) = eager(x)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert captured.graph_count() == 1 and eager.graph_count() == 0


def _resnet_program(tmp_path, batch=2):
    torch.backends.cudnn.allow_tf32 = False
    T.seed(0)
    net = T.vision.models.resnet18(num_classes=10).eval()
    prefix = str(tmp_path / "r")
    TS.save_inference_model(prefix, layer=net, input_spec=[
        TS.InputSpec([batch, 3, 32, 32], "float32", "image")])
    return net, prefix


@pytest.mark.cuda
def test_replayed_fetches_are_the_callers(card, tmp_path):
    from paddle_tpu_torch.static.interp import ProgramRunner

    net, prefix = _resnet_program(tmp_path)
    prog, _, _ = TS.load_inference_model(prefix)
    xs = [np.random.default_rng(i).standard_normal(
        (2, 3, 32, 32)).astype("float32") for i in range(4)]
    # the Executor: run 1 captures, runs 2 and 3 replay
    exe = TS.Executor(T.CUDAPlace(0))
    fetch = prog.fetch_target_names()
    kept = [exe.run(prog, feed={"image": x}, fetch_list=fetch)[0]
            for x in xs[:3]]
    assert exe._runners and all(
        r.graph_count() == 1 for r in exe._runners.values())
    snap = [k.clone() for k in kept]
    exe.run(prog, feed={"image": xs[3]}, fetch_list=fetch)
    for a, b in zip(kept, snap):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(kept[1], kept[2])
    # neither a kept fetch nor a persistable written back into the scope
    # is a graph's static output
    from paddle_tpu_torch.ops.capture import _tensors

    runner = next(iter(exe._runners.values()))
    static = {t.data_ptr() for e in runner._graphs._graphs.values()
              for t in _tensors(e.out)} - \
        {p.data_ptr() for p in runner.params.values()}
    assert static
    assert not {t.data_ptr() for t in kept} & static
    assert not {t.data_ptr() for t in exe.scope.values()
                if isinstance(t, torch.Tensor)} & static
    # the runner itself
    captured = ProgramRunner(prog, prog._param_scope, jit=True)
    outs = [captured(torch.from_numpy(x))[0] for x in xs]
    eager = ProgramRunner(prog, prog._param_scope, jit=False)
    for x, got in zip(xs, outs):
        torch.testing.assert_close(got, eager(torch.from_numpy(x))[0],
                                   rtol=0, atol=0)
    # the archive's runner (`jit.save`), device feeds and host feeds
    TJ.save(net.to(card), str(tmp_path / "a"),
            input_spec=[TS.InputSpec([2, 3, 32, 32], "float32")])
    layer = TINF.create_predictor(TINF.Config(
        str(tmp_path / "a.pdmodel")))._layer
    outs = [layer([x])[0] for x in xs]
    outs_dev = [layer([torch.from_numpy(x).to(card)])[0] for x in xs]
    assert layer.graph_count() == 1
    for a, b in zip(outs, outs_dev):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(outs[1], outs[2])


@pytest.mark.cuda
def test_clones_in_threads_get_their_own_outputs(card, tmp_path):
    import threading

    net, prefix = _resnet_program(tmp_path)
    pred = TINF.create_predictor(TINF.Config(prefix + ".pdmodel"))
    xs = [np.random.default_rng(i).standard_normal(
        (2, 3, 32, 32)).astype("float32") for i in range(2)]
    want = [pred.run([x])[0] for x in xs]  # the capture, then a replay
    assert pred.graph_count() == 1
    clones = [pred.clone() for _ in xs]
    bad = []

    def serve(clone, x, w):
        for _ in range(50):
            (got,) = clone.run([x])
            if not np.array_equal(got, w):
                bad.append(float(np.abs(got - w).max()))

    threads = [threading.Thread(target=serve, args=a)
               for a in zip(clones, xs, want)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, bad
    assert pred.graph_count() == 1


@pytest.mark.cuda
def test_int8_products_survive_export(card, tmp_path):
    net = T.vision.models.LeNet(num_classes=10).to(card).eval()
    calib = [torch.randn(8, 1, 28, 28, device=card) for _ in range(2)]

    def calib_fn(m):
        with torch.no_grad():
            for b in calib:
                m(b)

    T.quantization.ImperativePTQ().quantize(net, calib_fn)
    T.quantization.convert_to_int8(net)
    x = torch.randn(8, 1, 28, 28, device=card)
    with torch.no_grad():
        want = net(x)
    TJ.save(net, str(tmp_path / "q"),
            input_spec=[TS.InputSpec([8, 1, 28, 28], "float32")])
    loaded = TJ.load(str(tmp_path / "q"))
    ops = [str(n.target) for n in loaded._exported.graph.nodes]
    assert ops.count("aten._int_mm.default") == 5  # 2 convs, 3 linears
    torch.testing.assert_close(loaded(x), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_k5_custom_op_in_an_exported_program(card, tmp_path):
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.layer_norm import layer_norm, layer_norm_cuda

    ln = T.nn.LayerNorm(768).to(card).eval()
    x = torch.randn(64, 768, device=card)
    flags.set_flags({"use_pallas_layernorm": True})
    try:
        TJ.save(ln, str(tmp_path / "ln"),
                input_spec=[TS.InputSpec([64, 768], "float32")])
    finally:
        flags.set_flags({"use_pallas_layernorm": False})
    loaded = TJ.load(str(tmp_path / "ln"))
    ops = [str(n.target) for n in loaded._exported.graph.nodes]
    assert ops.count("paddle_tpu_torch.layer_norm.default") == 1
    before = layer_norm_cuda.launches
    got = loaded(x)
    torch.cuda.synchronize()
    assert layer_norm_cuda.launches - before == 1
    want = layer_norm(x, ln.weight.detach(), ln.bias.detach(), 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_host_read_inside_a_capture_raises(card):
    from paddle_tpu_torch.static.interp import _host_read

    t = torch.ones(1, device=card)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="captures"):
        with torch.cuda.graph(g):
            _host_read(t, "a test value")
