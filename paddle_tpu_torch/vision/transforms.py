"""Vision transforms (counterpart: paddle_tpu/vision/transforms.py).

Host code on numpy, as in the JAX package: a transform takes a numpy
array (or a PIL image) and gives numpy, or takes a ``torch.Tensor`` and
gives one on the same device.  `ToTensor` gives a CPU tensor (a
DataLoader worker sees no card; the loader moves batches).  The random
transforms draw from the global ``np.random``, at the JAX package's call
sites and in its order, so under one ``np.random.seed`` the crops, flips,
rotations and jitters are the JAX package's, bit for bit.  `Resize` is
``jax.image.resize(..., "bilinear")`` (half-pixel centres, an
antialiasing kernel when downsampling) through the port's
``nn.functional.interpolate``, which reproduces it.  Kept from the JAX
package: `ColorJitter` has no hue, `Normalize` does not read ``to_rgb``,
``Resize`` reads no ``interpolation``.  PIL is imported only inside
`decode_jpeg` and `image_load`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "RandomHorizontalFlip", "RandomVerticalFlip", "RandomCrop",
           "CenterCrop", "Transpose", "Pad", "Grayscale", "ColorJitter",
           "RandomResizedCrop", "RandomRotation", "to_tensor", "normalize",
           "resize", "hflip", "read_file", "decode_jpeg", "image_load"]


def _to_np(img):
    """``(array, device)``: a tensor's values on the host and its device
    (None for anything else)."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy(), img.device
    return np.asarray(img), None


def _wrap_like(out, device):
    return out if device is None else \
        torch.from_numpy(np.ascontiguousarray(out)).to(device)


def _float_np(img):
    arr, dev = _to_np(img)
    return np.asarray(arr, dtype=np.float32), dev


def _layout(arr):
    """-> 'chw' | 'hwc' | '2d' (channel-count based, incl. 1-channel)."""
    if arr.ndim == 2:
        return "2d"
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):
        return "chw"
    return "hwc"


def _hw_axes(arr):
    return (1, 2) if _layout(arr) == "chw" else (0, 1)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    """[0, 255] images scaled to [0, 1] (when the maximum exceeds 1.5),
    HWC laid out CHW, as a CPU float32 tensor."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(_to_np(img)[0], dtype=np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[None] if self.data_format == "CHW" else arr[..., None]
        elif self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr, dev = _float_np(img)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return _wrap_like((arr - m) / s, dev)


def _resize_array(arr, size):
    """``jax.image.resize(arr, shape, "bilinear")`` of a CHW, HWC or 2-D
    float32 array to spatial ``size``, through `interpolate`."""
    from ..nn.functional.common import interpolate

    t = torch.from_numpy(np.ascontiguousarray(arr))
    layout = _layout(arr)
    if layout == "chw":
        out = interpolate(t[None], size=list(size), mode="bilinear")[0]
    elif layout == "hwc":
        out = interpolate(t[None], size=list(size), mode="bilinear",
                          data_format="NHWC")[0]
    else:
        out = interpolate(t[None, None], size=list(size),
                          mode="bilinear")[0, 0]
    return out.numpy()


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr, dev = _float_np(img)
        return _wrap_like(_resize_array(arr, self.size), dev)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            arr, dev = _to_np(img)
            return _wrap_like(arr[..., ::-1].copy(), dev)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            arr, dev = _to_np(img)
            return _wrap_like(np.flip(arr, axis=-2).copy(), dev)
        return img


def _crop(arr, i, j, th, tw):
    h_ax, w_ax = _hw_axes(arr)
    sl = [slice(None)] * arr.ndim
    sl[h_ax] = slice(i, i + th)
    sl[w_ax] = slice(j, j + tw)
    return arr[tuple(sl)]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        h_ax, w_ax = _hw_axes(arr)
        if self.padding:
            p = self.padding
            pads = [(0, 0)] * arr.ndim
            pads[h_ax] = (p, p)
            pads[w_ax] = (p, p)
            arr = np.pad(arr, pads)
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return _wrap_like(_crop(arr, i, j, th, tw), dev)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        h_ax, w_ax = _hw_axes(arr)
        th, tw = self.size
        i = (arr.shape[h_ax] - th) // 2
        j = (arr.shape[w_ax] - tw) // 2
        return _wrap_like(_crop(arr, i, j, th, tw), dev)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        return _wrap_like(arr.transpose(self.order), dev)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    arr, dev = _to_np(img)
    return _wrap_like(arr[..., ::-1].copy(), dev)


def _to_gray(arr, layout):
    """Luma (ITU-R 601-2); returns 2-D [H, W]."""
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    if layout == "2d":
        return arr
    if layout == "chw":
        return arr[0] if arr.shape[0] == 1 else np.tensordot(
            w, arr[:3], axes=(0, 0))
    return arr[..., 0] if arr.shape[-1] == 1 else arr[..., :3] @ w


class Pad(BaseTransform):
    """Constant, edge or reflect border padding (left, top, right,
    bottom)."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        l, t, r, b = self.padding
        pad = ((0, 0), (t, b), (l, r)) if _layout(arr) == "chw" else \
            ((t, b), (l, r)) + ((0, 0),) * (arr.ndim - 2)
        if self.padding_mode == "constant":
            out = np.pad(arr, pad, constant_values=self.fill)
        else:
            out = np.pad(arr, pad, mode=self.padding_mode)
        return _wrap_like(out, dev)


class Grayscale(BaseTransform):
    """ITU-R 601-2 luma, repeated ``num_output_channels`` times."""

    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        arr, dev = _float_np(img)
        layout = _layout(arr)
        gray = _to_gray(arr, layout)
        reps = self.num_output_channels
        out = (np.repeat(gray[..., None], reps, -1) if layout == "hwc"
               else np.repeat(gray[None], reps, 0))
        return _wrap_like(out, dev)


class ColorJitter(BaseTransform):
    """Random brightness, contrast and saturation scaling (no hue, as in
    the JAX package)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _factor(amount):
        return 1.0 + np.random.uniform(-amount, amount) if amount else 1.0

    def _apply_image(self, img):
        arr, dev = _float_np(img)
        # the value range is the input's, not the jittered result's
        hi = 255.0 if arr.max() > 1.5 else 1.0
        layout = _layout(arr)
        arr = arr * self._factor(self.brightness)
        if self.contrast:
            mean = arr.mean()
            arr = (arr - mean) * self._factor(self.contrast) + mean
        if self.saturation and layout != "2d" and \
                (arr.shape[0] if layout == "chw" else arr.shape[-1]) >= 3:
            gray = _to_gray(arr, layout)
            gray = gray[None] if layout == "chw" else gray[..., None]
            f = self._factor(self.saturation)
            arr = arr * f + gray * (1.0 - f)
        return _wrap_like(np.clip(arr, 0.0, hi), dev)


class RandomResizedCrop(BaseTransform):
    """A random area and aspect crop, then `Resize` (the ImageNet
    training crop); the full image after 10 misses."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        h_ax, w_ax = _hw_axes(arr)
        h, w = arr.shape[h_ax], arr.shape[w_ax]
        area = h * w
        rng = np.random
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = rng.randint(0, h - ch + 1)
                j = rng.randint(0, w - cw + 1)
                return _wrap_like(self._resize(_crop(arr, i, j, ch, cw)),
                                  dev)
        return _wrap_like(self._resize(arr), dev)


class RandomRotation(BaseTransform):
    """A rotation by a random angle, counter-clockwise about the image
    centre, nearest-neighbour, ``fill`` outside the source."""

    def __init__(self, degrees, fill=0):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        arr, dev = _to_np(img)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        chw = _layout(arr) == "chw"
        h, w = (arr.shape[1:3]) if chw else arr.shape[:2]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # source = R(+angle) . (dest - center) + center
        cos, sin = np.cos(angle), np.sin(angle)
        sy = cy + (yy - cy) * cos + (xx - cx) * sin
        sx = cx - (yy - cy) * sin + (xx - cx) * cos
        syi = np.round(sy).astype(np.int64)
        sxi = np.round(sx).astype(np.int64)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        syi = np.clip(syi, 0, h - 1)
        sxi = np.clip(sxi, 0, w - 1)
        if chw:
            out = np.where(valid[None], arr[:, syi, sxi], self.fill)
        else:
            out = np.where(valid[..., None] if arr.ndim == 3 else valid,
                           arr[syi, sxi], self.fill)
        return _wrap_like(out.astype(arr.dtype), dev)


def read_file(path, name=None):
    """A file's bytes as a CPU uint8 tensor."""
    with open(path, "rb") as f:
        data = f.read()
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG bytes (a uint8 tensor or array) to a CHW uint8 CPU tensor,
    decoded on the host by PIL."""
    import io

    from PIL import Image

    raw = bytes(np.asarray(_to_np(x)[0]).astype(np.uint8))
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


def image_load(path, backend=None):
    """The image at ``path`` (a PIL image)."""
    from PIL import Image

    return Image.open(path)
