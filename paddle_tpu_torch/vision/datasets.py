"""Vision datasets (counterpart: paddle_tpu/vision/datasets.py).

Host code on numpy.  Nothing is downloaded: each dataset reads local
files in the formats of Paddle's loaders (IDX for MNIST, pickled batches
in a tar.gz for CIFAR, a tar of JPEGs with scipy ``.mat`` labels for
Flowers, the VOCdevkit tar for VOC2012) and raises without them, as the
JAX package's do; `FakeData` draws each sample from
``RandomState(seed + idx)``, the JAX package's samples bit for bit.
Flowers and VOC2012 without an archive give the JAX package's synthetic
corpus (`_stable_rng`).  PIL is imported only where an image is decoded.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["FakeData", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]


def _stable_rng(name: str, mode: str):
    """A numpy RandomState keyed by (name, mode) through crc32 (not
    ``hash()``, which differs between processes)."""
    import zlib

    return np.random.RandomState(
        zlib.crc32(f"{name}:{mode}".encode()) % (2 ** 31))


class FakeData(Dataset):
    """Deterministic synthetic image classification data."""

    def __init__(self, num_samples=1000, image_shape=(3, 224, 224),
                 num_classes=1000, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.asarray(rng.randint(0, self.num_classes), dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


class MNIST(Dataset):
    """MNIST from local IDX files (gzipped or not)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.transform = transform
        if image_path is None or not os.path.exists(image_path):
            raise FileNotFoundError(
                "MNIST files not available (no network); pass image_path/"
                "label_path to local IDX files, or use datasets.FakeData")
        with _open(image_path) as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols)
        with _open(label_path) as f:
            struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), dtype=np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 255.0
        label = np.asarray(self.labels[idx], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


FashionMNIST = MNIST


class Cifar10(Dataset):
    """CIFAR from a local ``cifar-*-python.tar.gz`` of pickled batches."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        if data_file is None or not os.path.exists(data_file):
            raise FileNotFoundError(
                "CIFAR archive not available (no network); pass data_file, "
                "or use datasets.FakeData")
        images, labels = [], []
        with tarfile.open(data_file, "r:gz") as tf:
            names = [m for m in tf.getmembers()
                     if ("data_batch" in m.name if mode == "train"
                         else "test_batch" in m.name)]
            for m in sorted(names, key=lambda x: x.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                images.append(d[b"data"])
                labels += list(d[b"labels"])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


class DatasetFolder(Dataset):
    """``root/<class>/<file>`` samples, classes in sorted order."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError("PIL unavailable; use .npy images") from None
        return np.asarray(Image.open(path).convert("RGB"))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(target, dtype=np.int64)

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


class Flowers(Dataset):
    """Flowers-102: ``data_file`` (102flowers.tgz) with ``label_file``
    (imagelabels.mat) and ``setid_file`` (setid.mat), read with scipy;
    without them a synthetic corpus of the same schema (1-based labels of
    shape (1,))."""

    # Paddle trains on the large split (tstid) and tests on trnid
    MODE_FLAG_MAP = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, num_samples=128,
                 image_size=(3, 32, 32)):
        self.transform = transform
        self._archive = None
        if data_file is not None:
            if label_file is None or setid_file is None:
                raise ValueError(
                    "Flowers: data_file requires label_file "
                    "(imagelabels.mat) and setid_file (setid.mat) too")
            import scipy.io as scio

            self._archive = _TarImages(data_file)
            self.labels = scio.loadmat(label_file)["labels"][0]
            self.indexes = scio.loadmat(setid_file)[
                self.MODE_FLAG_MAP[mode.lower()]][0]
            return
        if label_file is not None or setid_file is not None:
            raise ValueError(
                "Flowers: label_file/setid_file given without data_file")
        r = _stable_rng("flowers", mode)
        self.images = r.rand(num_samples, *image_size).astype(np.float32)
        self.labels = r.randint(1, 103, (num_samples,)).astype(np.int64)

    def __getitem__(self, idx):
        if self._archive is not None:
            index = int(self.indexes[idx])
            img = self._archive.read_image("jpg/image_%05d.jpg" % index)
            label = np.array([self.labels[index - 1]]).astype(np.int64)
        else:
            img = self.images[idx]
            label = np.array([self.labels[idx]]).astype(np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        if self._archive is not None:
            return len(self.indexes)
        return len(self.images)


class _TarImages:
    """A tar archive indexed by member name, images decoded by PIL.  The
    handle opens lazily and is dropped on pickling, so an archive-backed
    dataset crosses into spawned DataLoader workers (each opens its
    own)."""

    def __init__(self, path):
        self.path = path
        self._tar = None
        self._name2mem = None
        self._members()  # validate the archive eagerly

    def _members(self):
        if self._tar is None:
            self._tar = tarfile.open(self.path)
            self._name2mem = {m.name: m for m in self._tar.getmembers()}
        return self._tar, self._name2mem

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._tar = None
        self._name2mem = None

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None
            self._name2mem = None

    def read_text_lines(self, name):
        tar, n2m = self._members()
        data = tar.extractfile(n2m[name]).read()
        return [ln.strip() for ln in data.decode("utf-8").splitlines()
                if ln.strip()]

    def read_image(self, name):
        import io as _io

        from PIL import Image

        tar, n2m = self._members()
        raw = tar.extractfile(n2m[name]).read()
        return np.array(Image.open(_io.BytesIO(raw)))


class VOC2012(Dataset):
    """VOC2012 segmentation: (image, class-index mask) pairs from the
    VOCdevkit tar; without it a synthetic corpus of the same schema."""

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    MODE_FLAG_MAP = {"train": "train", "test": "train", "valid": "val"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 num_samples=32, image_size=(3, 32, 32), num_classes=21):
        self.transform = transform
        self._archive = None
        if data_file is not None:
            self._archive = _TarImages(data_file)
            flag = self.MODE_FLAG_MAP[mode.lower()]
            names = self._archive.read_text_lines(self.SET_FILE.format(flag))
            self.data = [self.DATA_FILE.format(n) for n in names]
            self.labels = [self.LABEL_FILE.format(n) for n in names]
            return
        r = _stable_rng("voc2012", mode)
        self.images = r.rand(num_samples, *image_size).astype(np.float32)
        self.masks = r.randint(0, num_classes,
                               (num_samples,) + image_size[1:]).astype(
                                   np.int64)

    def __getitem__(self, idx):
        if self._archive is not None:
            img = self._archive.read_image(self.data[idx])
            mask = self._archive.read_image(self.labels[idx]).astype(np.int64)
        else:
            img, mask = self.images[idx], self.masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        if self._archive is not None:
            return len(self.data)
        return len(self.images)
