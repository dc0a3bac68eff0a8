"""paddle_tpu_torch.vision.models against the JAX package's.

Each model is built in both packages; the JAX model's parameters and
buffers are set from numpy draws made from a seed (its own initializers
draw zeros: a compile a shape is time the test does not need), and its
``state_dict()``, as numpy, loads into the port through
``set_state_dict`` with nothing missing or unexpected: the weight bridge.
Then one train-mode forward on the same input, made from a seed: the
outputs, the gradient of every parameter against fixed cotangents, and
BatchNorm's running statistics after the step, each within 1e-5 of the
JAX package's relative to the tensor's largest value (f32; the JAX side
under one ``jax.jit``).  Models and sizes: LeNet at 28 x 28; resnet18
and resnet50 at 2 x 3 x 32 x 32; vgg11(batch_norm=True)'s features (and
its classifier's names and shapes: the 25088 x 4096 Linear is 400 MB);
mobilenet_v1/v2(scale=0.25); a 2-layer ViT at 32 x 32; and
yolov3_darknet53(num_classes=2) at 64 x 64: its training loss, and in
eval mode its heads and the decode (``yolo_box`` at each scale and one
``multiclass_nms``) of the same head outputs, whose labels, indices and
counts are equal.  Last, the fixed-batch probe: LeNet through
``Model.fit`` with Adam for 10 steps on one batch of ``FakeData``, the
losses within 1e-5 of the JAX package's and falling.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as TPL

import torch_op_tables as tab
from test_torch_tensor_api import cotangents

REL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def _zeros(self, shape, dtype):
    import jax.numpy as jnp

    return jnp.zeros(shape, dtype)


def _draw(name, shape, r):
    """A value for the state entry ``name`` of ``shape``: He-scaled
    weights, BatchNorm's and LayerNorm's scales near 1, small biases,
    positive running variances."""
    if name.endswith("_variance"):
        return r.uniform(0.5, 1.5, shape)
    if name.endswith("_mean") or name.endswith("bias"):
        return 0.1 * r.standard_normal(shape)
    if name.endswith("weight") and len(shape) == 1:
        return 1.0 + 0.1 * r.standard_normal(shape)
    if name.endswith("weight") and len(shape) in (2, 4):
        fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
        return r.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    return 0.02 * r.standard_normal(shape)


def build(make, seed=0):
    """``(jax_model, port_model)``: ``make(pkg)`` in both, the JAX one's
    state drawn from ``seed`` and loaded into the port's."""
    with mock.patch.multiple(JI.Initializer, _init=_zeros), \
            mock.patch.object(JI.Constant, "_init", _zeros), \
            mock.patch.object(JI.Uniform, "_init", _zeros), \
            mock.patch.object(JI.Normal, "_init", _zeros), \
            mock.patch.object(JI.XavierUniform, "_init", _zeros), \
            mock.patch.object(JI.KaimingUniform, "_init", _zeros):
        jm = make(P)
    r = np.random.default_rng(seed)
    for name, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        t.set_value(_draw(name, tuple(t.shape), r).astype(np.float32))
    tm = make(T)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    missing, unexpected = tm.set_state_dict(state)
    assert missing == [] and unexpected == [], (missing, unexpected)
    return jm, tm


def jax_run(jm, arrays, call, grad=True):
    """``(outputs, {param: grad}, {buffer: value})`` of the JAX model on
    ``arrays`` under one ``jax.jit``: parameters and buffers enter as
    arguments, the buffers' values after the forward leave as outputs."""
    named = list(jm.named_parameters())
    bufs = list(jm.named_buffers())

    def run(xs, ps, bs):
        old = [t._array for _, t in named + bufs]
        try:
            for (_, t), a in zip(named + bufs, list(ps) + list(bs)):
                t._array = a
            outs = tab.flat(call(jm, *[P.Tensor(a) for a in xs]))
            grads = {}
            if grad:
                fl = [o for o in outs if "float" in str(o.dtype)]
                cots = cotangents([tuple(o.shape) for o in fl])
                gs = P.grad(fl, [p for _, p in named],
                            grad_outputs=[P.Tensor(c) for c in cots],
                            allow_unused=True)
                grads = {n: g._array for (n, _), g in zip(named, gs)
                         if g is not None}
            return ([o._array for o in outs], grads,
                    {n: b._array for n, b in bufs})
        finally:
            for (_, t), a in zip(named + bufs, old):
                t._array = a

    outs, grads, after = jax.jit(run)(
        list(arrays), [p._array for _, p in named],
        [b._array for _, b in bufs])
    return ([np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in after.items()})


def port_run(tm, arrays, call, grad=True):
    outs = tab.flat(call(tm, *[torch.from_numpy(np.array(a))
                               for a in arrays]))
    grads = {}
    if grad:
        fl = [o for o in outs if o.is_floating_point()]
        cots = [torch.from_numpy(c) for c in
                cotangents([tuple(o.shape) for o in fl])]
        named = list(tm.named_parameters())
        gs = torch.autograd.grad(fl, [p for _, p in named], cots,
                                 allow_unused=True)
        grads = {n: g for (n, _), g in zip(named, gs) if g is not None}
    return ([o.detach().numpy() for o in outs],
            {k: v.numpy() for k, v in grads.items()},
            {k: v.detach().numpy() for k, v in tm.named_buffers()})


def close(got, want, label, tol=REL, scale=None):
    """``got`` within ``tol`` of ``want`` relative to ``scale`` (default:
    ``want``'s largest value); integers equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=label)
        return
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=REL, atol=tol * scale,
                               err_msg=label)


def check_step(jm, tm, arrays, call, label, tol=None):
    """A train-mode step (outputs and BatchNorm's running statistics
    after it), then in eval mode the gradient of every parameter, each
    gradient within the tolerance relative to the model's largest one.
    ``tol`` = (outputs, statistics, gradients), default `REL` each."""
    out_tol, stat_tol, grad_tol = tol or (REL, REL, REL)
    jm.train()
    tm.train()
    jo, _, jb = jax_run(jm, arrays, call, grad=False)
    to, _, tb = port_run(tm, arrays, call, grad=False)
    assert len(to) == len(jo)
    for i, (g, w) in enumerate(zip(to, jo)):
        close(g, w, f"{label}.out[{i}]", out_tol)
    assert set(tb) == set(jb)
    for k in jb:
        close(tb[k], jb[k], f"{label}.buffer.{k}", stat_tol)
    # the gradients with the running statistics the JAX step left
    for n, b in jm.named_buffers():
        b.set_value(jb[n])
    tm.set_state_dict(jb)
    jm.eval()
    tm.eval()
    jo, jg, _ = jax_run(jm, arrays, call)
    to, tg, _ = port_run(tm, arrays, call)
    for i, (g, w) in enumerate(zip(to, jo)):
        close(g, w, f"{label}.eval_out[{i}]", out_tol)
    assert set(tg) == set(jg), sorted(set(tg) ^ set(jg))
    top = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        close(tg[k], jg[k], f"{label}.grad.{k}", grad_tol, top)


def img(*shape):
    return np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)


def fwd(m, x):
    return m(x)


def vit(pkg):
    return pkg.vision.models.VisionTransformer(
        image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
        dropout=0.0)


MODELS = {
    "lenet": (lambda pkg: pkg.vision.models.LeNet(), (2, 1, 28, 28)),
    "resnet18": (lambda pkg: pkg.vision.models.resnet18(num_classes=10),
                 (2, 3, 64, 64)),
    "resnet50": (lambda pkg: pkg.vision.models.resnet50(), (2, 3, 64, 64)),
    "mobilenet_v1": (lambda pkg: pkg.vision.models.mobilenet_v1(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
    "mobilenet_v2": (lambda pkg: pkg.vision.models.mobilenet_v2(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
    "vit": (vit, (2, 3, 32, 32)),
}


# (outputs, statistics, gradients) where `REL` is below the models'
# conditioning in f32.  Train-mode BatchNorm over 8 values a channel (the
# last stages at 2 x 64 x 64) amplifies rounding: each package's f32 run
# is this far off the port's f64 run of the same step (relative to the
# largest value): resnet50 outputs 7.9e-05 (port) and 1.2e-04 (JAX),
# statistics 3.8e-05 and 4.6e-05; mobilenet_v1 statistics 1.0e-05 and
# 1.7e-05; mobilenet_v2 outputs 5.9e-06 and 1.6e-05, statistics 2.3e-04
# and 2.0e-03.  In eval mode, XLA's CPU backend at the suite's
# ``--xla_backend_optimization_level=0`` (tests/conftest.py) computes
# resnet50's convolution weight gradients up to 4.6e-03 of the largest
# gradient off the f64 value (layer3.3.conv3), the port 9.3e-07.
TOL = {"resnet50": (3e-4, 1e-4, 1e-2), "mobilenet_v1": (REL, 5e-5, REL),
       "mobilenet_v2": (5e-5, 5e-3, REL)}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_train_step_matches_jax(name):
    make, shape = MODELS[name]
    jm, tm = build(make)
    if name == "mobilenet_v2":  # its classifier's dropout draws in train
        jm.classifier[0].p = tm.classifier[0].p = 0.0
    check_step(jm, tm, [img(*shape)], fwd, name, TOL.get(name))


def test_vgg11_bn_features_and_classifier_names():
    """The features (and the 7 x 7 pool) through a train-mode step; the
    classifier's names and shapes against the JAX model's."""
    def feats(m, x):
        return m.avgpool(m.features(x))

    jm, tm = build(lambda pkg: pkg.vision.models.vgg11(batch_norm=True,
                                                       num_classes=0))
    check_step(jm, tm, [img(2, 3, 32, 32)], feats, "vgg11_bn")
    with mock.patch.object(JI.XavierUniform, "_init", _zeros), \
            mock.patch.object(JI.Constant, "_init", _zeros):
        jc = P.vision.models.VGG(P.nn.Sequential(), num_classes=1000)
    tc = T.vision.models.VGG(T.nn.Sequential(), num_classes=1000)
    want = {k: tuple(v.shape) for k, v in jc.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tc.state_dict().items()}
    assert got == want and want["classifier.0.weight"] == (25088, 4096)


@pytest.fixture(scope="module")
def yolo():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    try:
        return build(lambda pkg: pkg.vision.models.yolov3_darknet53(
            num_classes=2))
    finally:
        TPL._EXPECTED_DEVICE[0] = prev


def _yolo_batch():
    r = np.random.default_rng(2)
    gt = np.concatenate([r.uniform(0.1, 0.9, (2, 4, 2)),
                         r.uniform(0.05, 0.5, (2, 4, 2))], -1)
    gt[1, 3] = 0.0  # a padded row
    return [img(2, 3, 64, 64), gt.astype(np.float32),
            r.integers(0, 2, (2, 4)).astype(np.int32)]


def _yolo_loss(m, x, g, lab):
    """The training loss: the model's own in train mode; in eval mode the
    same sum of the three scales' ``yolov3_loss`` over its heads."""
    if m.training:
        return m(x, g, lab)
    loss = sys.modules[type(m).__module__].yolov3_loss
    return sum(loss(out, g, lab, m.ANCHORS, m.MASKS[i], m.num_classes,
                    m.ignore_thresh, m.downsamples[i])[0].sum()
               for i, out in enumerate(m._heads(x)))


def test_yolov3_training_loss_matches_jax(yolo):
    jm, tm = yolo
    check_step(jm, tm, _yolo_batch(), _yolo_loss, "yolov3.train")


def test_yolov3_eval_heads_and_decode_match_jax(yolo):
    """Eval mode: the three heads within tolerance; the decode of the
    JAX heads' outputs by each package: labels, indices and counts
    equal, boxes and scores within tolerance."""
    jm, tm = yolo
    jm.eval()
    tm.eval()
    x = img(1, 3, 64, 64)
    im = np.asarray([[64, 64]], np.int32)
    jheads, _, _ = jax_run(jm, [x], lambda m, xv: m._heads(xv), grad=False)
    theads, _, _ = port_run(tm, [x], lambda m, xv: m._heads(xv), grad=False)
    for i, (g, w) in enumerate(zip(theads, jheads)):
        close(g, w, f"yolov3.head[{i}]")
    kw = dict(score_threshold=0.01, nms_top_k=400, keep_top_k=100,
              nms_threshold=0.45, background_label=-1, return_index=True)
    ja, js = [], []
    for i, out in enumerate(jheads):
        anchors = [jm.ANCHORS[2 * m + d] for m in jm.MASKS[i]
                   for d in (0, 1)]
        b, s = P.vision.ops.yolo_box(P.to_tensor(out), P.to_tensor(im),
                                     anchors, 2, 0.01, jm.downsamples[i])
        ja.append(b)
        js.append(s)
    want = tab.flat(P.vision.ops.multiclass_nms(
        P.concat(ja, axis=1), P.transpose(P.concat(js, axis=1), [0, 2, 1]),
        **kw))
    tb, ts = tm.decode([torch.from_numpy(np.array(o)) for o in jheads],
                       torch.from_numpy(im))
    got = tab.flat(T.vision.ops.multiclass_nms(tb, ts, **kw))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g.numpy(), np.asarray(w.numpy()), f"yolov3.decode[{i}]")
    out, index, count = got
    assert int(count[0]) > 0
    # the whole eval forward runs and gives the documented shapes
    res = tm(torch.from_numpy(x), im_shape=torch.from_numpy(im))
    assert tuple(res[0].shape) == (1, 100, 6) and tuple(res[1].shape) == (1,)


def _fixed_batch(pkg):
    """Ten steps of one batch of 8 FakeData samples."""
    fake = pkg.vision.datasets.FakeData(num_samples=8,
                                        image_shape=(1, 28, 28),
                                        num_classes=10)

    class Repeat(pkg.io.Dataset):
        def __getitem__(self, i):
            return fake[i % 8]

        def __len__(self):
            return 80

    return Repeat()


def test_lenet_fit_fixed_batch_matches_jax():
    """The probe of the verify recipe: LeNet, ``Model.fit`` with Adam
    (lr 1e-3) over 10 steps of one batch, from one initial state: the
    losses equal the JAX package's within 1e-5, and fall."""
    make = MODELS["lenet"][0]
    jm, tm = build(make, seed=5)
    logged = {"jax": [], "torch": []}
    for pkg, net, side in ((P, jm, "jax"), (T, tm, "torch")):
        class Rec(pkg.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                logged[side].append(float(logs["loss"]))

        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(1e-3, parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(_fixed_batch(pkg), batch_size=8, epochs=1, shuffle=False,
                  verbose=0, callbacks=[Rec()])
    assert len(logged["torch"]) == 10
    np.testing.assert_allclose(logged["torch"], logged["jax"], rtol=1e-5,
                               atol=1e-5)
    assert logged["torch"][-1] < logged["torch"][0]


@pytest.mark.parametrize("mod", ["lenet", "resnet", "vgg", "mobilenet",
                                 "vit", "yolov3"])
def test_every_model_name_exists(mod):
    """Each public class, function and table of the JAX package's model
    module (and of ``vision`` and ``vision.models``) has the port's
    counterpart."""
    import importlib
    import inspect

    import paddle_tpu.vision.models  # noqa: F401

    jm = importlib.import_module(f"paddle_tpu.vision.models.{mod}")
    tm = importlib.import_module(f"paddle_tpu_torch.vision.models.{mod}")
    want = {n for n, v in vars(jm).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v)
                 or isinstance(v, dict))
            and getattr(v, "__module__", jm.__name__) == jm.__name__}
    assert want and want <= set(dir(tm)), sorted(want - set(dir(tm)))
    for jpkg, tpkg in ((P.vision, T.vision),
                       (P.vision.models, T.vision.models)):
        public = {n for n in dir(jpkg) if not n.startswith("_")}
        assert public <= set(dir(tpkg)), sorted(public - set(dir(tpkg)))
