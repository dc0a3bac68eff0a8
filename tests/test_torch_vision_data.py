"""paddle_tpu_torch.vision's transforms and datasets against the JAX
package's.

Every transform of ``paddle_tpu/vision/transforms.py`` is a case of one
table: the same image (CHW, HWC or 2-D, made from a seed) through both
packages after the same ``np.random.seed``, so the random crops, flips,
rotations and jitters draw the same numbers.  Outputs are bit-equal,
except where `Resize` runs (``Resize``, ``resize``, ``RandomResizedCrop``):
``jax.image.resize`` against the port's ``interpolate``, within atol 1e-6
(f32 values in [0, 255] are scaled to [0, 1] first).  A tensor in gives a
tensor out, numpy gives numpy.  `FakeData` is bit-equal, with and without
a transform; each archive dataset reads files the test writes (IDX,
CIFAR's pickled batches, a class folder, Flowers' tgz and ``.mat``
labels, VOC's tar) and gives the JAX package's items, bit for bit, and
raises as the JAX one does without them.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT

from test_torch_tensor_api import _public

RESIZE_ATOL = 1e-6


def chw(seed=0, shape=(3, 20, 24)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def hwc(seed=0, shape=(20, 24, 3)):
    return np.random.default_rng(seed).integers(
        0, 256, shape).astype(np.float32)


def gray(seed=0):
    return chw(seed, (20, 24))


class C:
    """``build(module)`` -> a transform (or function) applied to
    ``make()``; ``resize`` marks the cases whose output `Resize` makes."""

    def __init__(self, label, build, make=chw, resize=False, seeds=(0,)):
        self.label, self.build, self.make = label, build, make
        self.resize, self.seeds = resize, seeds
        self.name = label.split("[")[0]

    def __repr__(self):
        return self.label


CASES = [
    C("Compose", lambda m: m.Compose([m.RandomHorizontalFlip(0.5),
                                      m.Normalize([0.5] * 3, [0.2] * 3)]),
      seeds=(0, 1, 2, 3)),
    C("BaseTransform", lambda m: type("Negate", (m.BaseTransform,), {
        "_apply_image": lambda self, x: -x})()),
    C("ToTensor[hwc-255]", lambda m: m.ToTensor(), make=hwc),
    C("ToTensor[2d-hwc]", lambda m: m.ToTensor("HWC"), make=gray),
    C("Normalize[chw]", lambda m: m.Normalize([0.4, 0.5, 0.6],
                                              [0.2, 0.3, 0.25])),
    C("Normalize[hwc]", lambda m: m.Normalize([120.0, 110, 100], [60.0] * 3,
                                              data_format="HWC"), make=hwc),
    C("Resize[down-chw]", lambda m: m.Resize((7, 9)), resize=True),
    C("Resize[up-hwc]", lambda m: m.Resize(33), make=hwc, resize=True),
    C("Resize[2d]", lambda m: m.Resize((10, 30)), make=gray, resize=True),
    C("RandomHorizontalFlip", lambda m: m.RandomHorizontalFlip(),
      seeds=(0, 1, 2, 3)),
    C("RandomVerticalFlip", lambda m: m.RandomVerticalFlip(0.7), make=hwc,
      seeds=(0, 1, 2, 3)),
    C("RandomCrop", lambda m: m.RandomCrop(9, padding=2), seeds=(0, 5)),
    C("RandomCrop[hwc]", lambda m: m.RandomCrop((5, 11)), make=hwc),
    C("CenterCrop", lambda m: m.CenterCrop((7, 10)), make=hwc),
    C("Transpose", lambda m: m.Transpose(), make=hwc),
    C("Pad[constant]", lambda m: m.Pad(2, fill=0.5)),
    C("Pad[reflect-hwc]", lambda m: m.Pad((1, 3), padding_mode="reflect"),
      make=hwc),
    C("Pad[edge-2d]", lambda m: m.Pad((1, 2, 3, 4), padding_mode="edge"),
      make=gray),
    C("Grayscale[3]", lambda m: m.Grayscale(3)),
    C("Grayscale[hwc]", lambda m: m.Grayscale(), make=hwc),
    C("ColorJitter", lambda m: m.ColorJitter(0.4, 0.4, 0.4), make=hwc,
      seeds=(0, 1)),
    C("ColorJitter[chw]", lambda m: m.ColorJitter(0.2, 0.3, 0.5)),
    C("RandomResizedCrop", lambda m: m.RandomResizedCrop(12), resize=True,
      seeds=(0, 1, 2)),
    C("RandomResizedCrop[hwc]", lambda m: m.RandomResizedCrop(
        (10, 8), scale=(0.5, 1.0)), make=hwc, resize=True),
    C("RandomRotation", lambda m: m.RandomRotation(30, fill=0.25),
      seeds=(0, 1)),
    C("RandomRotation[hwc]", lambda m: m.RandomRotation((10, 80)), make=hwc),
    C("to_tensor", lambda m: m.to_tensor, make=hwc),
    C("normalize", lambda m: lambda x: m.normalize(x, 0.5, 0.25)),
    C("resize", lambda m: lambda x: m.resize(x, (15, 11)), resize=True),
    C("hflip", lambda m: m.hflip, make=hwc),
]


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _check(case, got, want, label):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if case.resize:
        hi = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got / hi, want / hi, rtol=0,
                                   atol=RESIZE_ATOL, err_msg=label)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("case", CASES, ids=repr)
def test_transform_matches_jax(case):
    for seed in case.seeds:
        img = case.make(seed)
        np.random.seed(seed)
        want = case.build(JT)(img.copy())
        np.random.seed(seed)
        got = case.build(TT)(img.copy())
        assert isinstance(got, torch.Tensor) == (case.name in (
            "ToTensor", "to_tensor")), type(got)
        _check(case, got, want, f"{case.label} seed {seed}")
        # a tensor in gives a tensor out, of the same values
        np.random.seed(seed)
        got_t = case.build(TT)(torch.from_numpy(img.copy()))
        assert isinstance(got_t, torch.Tensor)
        _check(case, got_t, want, f"{case.label} tensor seed {seed}")


def test_every_transform_has_a_case():
    names = {c.name for c in CASES}
    want = _public(JT) - {"Tensor", "read_file", "decode_jpeg",
                          "image_load"}
    assert want <= names, sorted(want - names)
    assert _public(JT) <= set(TT.__all__), sorted(_public(JT) - set(
        TT.__all__))


def test_read_file_decode_jpeg_and_image_load(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, (6, 5, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(path, format="JPEG")
    jraw, traw = JT.read_file(path), TT.read_file(path)
    np.testing.assert_array_equal(traw.numpy(), _np(jraw))
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            TT.decode_jpeg(traw, mode).numpy(), _np(JT.decode_jpeg(jraw,
                                                                   mode)))
    np.testing.assert_array_equal(np.asarray(TT.image_load(path)),
                                  np.asarray(JT.image_load(path)))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def _items(ds, idx=None):
    idx = range(len(ds)) if idx is None else idx
    return [[_np(v) for v in ds[i]] for i in idx]


def _same(tds, jds, idx=None):
    assert len(tds) == len(jds)
    for i, (g, w) in enumerate(zip(_items(tds, idx), _items(jds, idx))):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind, i
            np.testing.assert_array_equal(a, b, err_msg=f"item {i}")


def test_fake_data_is_bit_equal():
    for kw in (dict(num_samples=5, image_shape=(3, 8, 6), num_classes=7,
                    seed=3),
               dict(num_samples=4, image_shape=(1, 28, 28))):
        _same(TD.FakeData(**kw), JD.FakeData(**kw))
    np.random.seed(4)
    t = TD.FakeData(6, (3, 16, 16), transform=TT.Compose([
        TT.RandomResizedCrop(8), TT.RandomHorizontalFlip()]))
    tw = [[_np(v) for v in t[i]] for i in range(6)]
    np.random.seed(4)
    j = JD.FakeData(6, (3, 16, 16), transform=JT.Compose([
        JT.RandomResizedCrop(8), JT.RandomHorizontalFlip()]))
    jw = [[_np(v) for v in j[i]] for i in range(6)]
    for (a, la), (b, lb) in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=RESIZE_ATOL)
        assert la == lb


def _idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def test_mnist_reads_idx_files(tmp_path):
    r = np.random.default_rng(0)
    img, lab = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    _idx(img, r.integers(0, 256, (5, 28, 28)).astype(np.uint8), 2051)
    _idx(lab, r.integers(0, 10, (5,)).astype(np.uint8), 2049)
    _same(TD.MNIST(img, lab), JD.MNIST(img, lab))
    assert TD.FashionMNIST is TD.MNIST
    for mod in (TD, JD):
        with pytest.raises(FileNotFoundError):
            mod.MNIST(str(tmp_path / "none.gz"))


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def test_cifar_reads_pickled_batches(tmp_path):
    r = np.random.default_rng(1)
    path = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            d = {b"data": r.integers(0, 256, (3, 3072)).astype(np.uint8),
                 b"labels": [int(v) for v in r.integers(0, 10, 3)]}
            _add(tar, f"cifar-10-batches-py/{name}", pickle.dumps(d))
    for mode in ("train", "test"):
        _same(TD.Cifar10(path, mode=mode), JD.Cifar10(path, mode=mode))
        _same(TD.Cifar100(path, mode=mode), JD.Cifar100(path, mode=mode))
    for mod in (TD, JD):
        with pytest.raises(FileNotFoundError):
            mod.Cifar10()


def test_dataset_folder_reads_classes(tmp_path):
    from PIL import Image

    r = np.random.default_rng(2)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(2):
            np.save(tmp_path / c / f"{i}.npy",
                    r.uniform(size=(3, 4, 4)).astype(np.float32))
        Image.fromarray(r.integers(0, 256, (4, 5, 3)).astype(
            np.uint8)).save(tmp_path / c / "z.png")
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    t, j = TD.DatasetFolder(str(tmp_path)), JD.DatasetFolder(str(tmp_path))
    assert t.class_to_idx == j.class_to_idx and len(t) == 6
    _same(t, j)
    assert TD.ImageFolder is TD.DatasetFolder


def _jpg(arr, fmt="JPEG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def test_flowers_archive_and_synthetic(tmp_path):
    import scipy.io as scio

    r = np.random.default_rng(3)
    data = str(tmp_path / "102flowers.tgz")
    with tarfile.open(data, "w:gz") as tar:
        for i in range(1, 6):
            _add(tar, "jpg/image_%05d.jpg" % i,
                 _jpg(r.integers(0, 256, (8, 8, 3)).astype(np.uint8)))
    labels, setid = str(tmp_path / "labels.mat"), str(tmp_path / "set.mat")
    scio.savemat(labels, {"labels": r.integers(1, 103, (1, 5))})
    scio.savemat(setid, {"tstid": [[1, 3, 5]], "trnid": [[2, 4]],
                         "valid": [[5]]})
    for mode in ("train", "test", "valid"):
        _same(TD.Flowers(data, labels, setid, mode=mode),
              JD.Flowers(data, labels, setid, mode=mode))
    _same(TD.Flowers(mode="test", num_samples=4),
          JD.Flowers(mode="test", num_samples=4))
    for mod in (TD, JD):
        with pytest.raises(ValueError):
            mod.Flowers(data)


def test_voc2012_archive_and_synthetic(tmp_path):
    r = np.random.default_rng(4)
    path = str(tmp_path / "voc.tar")
    names = ["2007_000032", "2007_000033"]
    with tarfile.open(path, "w") as tar:
        _add(tar, TD.VOC2012.SET_FILE.format("train"),
             "\n".join(names).encode())
        _add(tar, TD.VOC2012.SET_FILE.format("val"), names[1].encode())
        for n in names:
            _add(tar, TD.VOC2012.DATA_FILE.format(n),
                 _jpg(r.integers(0, 256, (6, 7, 3)).astype(np.uint8)))
            _add(tar, TD.VOC2012.LABEL_FILE.format(n),
                 _jpg(r.integers(0, 21, (6, 7)).astype(np.uint8), "PNG"))
    for mode in ("train", "valid"):
        _same(TD.VOC2012(path, mode=mode), JD.VOC2012(path, mode=mode))
    _same(TD.VOC2012(num_samples=3), JD.VOC2012(num_samples=3))
    # an archive-backed dataset pickles without its handle (spawned
    # DataLoader workers open their own)
    ds = pickle.loads(pickle.dumps(TD.VOC2012(path)))
    _same(ds, JD.VOC2012(path))


def test_every_dataset_name_exists():
    assert _public(JD) - {"Dataset"} <= set(TD.__all__)


def test_fit_style_loader_batches_equal_jax():
    """A DataLoader over FakeData through the ImageNet training
    transforms (threads here), against the JAX package's batches, one
    ``np.random.seed`` each."""
    def pipe(m):
        return m.Compose([m.RandomResizedCrop(16), m.RandomHorizontalFlip(),
                          m.Normalize([0.485, 0.456, 0.406],
                                      [0.229, 0.224, 0.225])])

    import paddle_tpu_torch as T

    np.random.seed(7)
    tl = T.io.DataLoader(TD.FakeData(8, (3, 24, 24), transform=pipe(TT)),
                         places="cpu", batch_size=4)
    got = [(x.numpy(), y.numpy()) for x, y in tl]
    np.random.seed(7)
    jl = P.io.DataLoader(JD.FakeData(8, (3, 24, 24), transform=pipe(JT)),
                         batch_size=4)
    want = [(_np(x), _np(y)) for x, y in jl]
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_allclose(gx, wx, rtol=0, atol=10 * RESIZE_ATOL)
        np.testing.assert_array_equal(gy, wy)
