"""Common functionals (counterpart: paddle_tpu/nn/functional/common.py):
linear, embedding, the dropouts, one-hot and label smoothing, the
similarities, bilinear, the pixel and channel shuffles, unfold/fold,
interpolation (the JAX package's ``jax.image.resize``: half-pixel
centres, an antialiasing kernel when downsampling, ``align_corners``
taken and not read), affine grids and grid sampling, and the temporal
shift."""
from __future__ import annotations

import numpy as np
import torch

from ... import amp
from ...core.framework import generator_for

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "label_smooth", "cosine_similarity",
           "pairwise_distance", "bilinear", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "unfold", "fold",
           "interpolate", "upsample", "affine_grid", "grid_sample",
           "temporal_shift", "npair_loss"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` [in_features, out_features]
    (paddle's layout).  A WHITE op under `amp.auto_cast`."""
    x, weight, bias = amp.cast_inputs(amp.WHITE, x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [num, dim] at the integer ids ``x``; rows of
    ids equal to ``padding_idx`` are zeros (and pass no gradient)."""
    ids = x.long()
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def _keep_mask(x, p, shape):
    u = torch.rand(shape, generator=generator_for(x.device), device=x.device)
    return u < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (with ``axis``, whole
    slices: the mask has size 1 on every other axis).  ``upscale_in_train``
    scales the kept elements by ``1 / (1 - p)`` in training and is the
    identity otherwise; ``downscale_in_infer`` keeps them as they are in
    training and scales by ``1 - p`` otherwise.  The mask is drawn from
    the default generator of ``x``'s device (`core.framework.seed`), so
    one seed draws the same masks; drawing inside a CUDA-graph capture
    raises."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0:
        if mode == "downscale_in_infer" and p > 0:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(x, p, shape)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped elements take ``-alpha * scale`` and the
    result is shifted and scaled back to the input's mean and variance."""
    if not training or p == 0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    keep = _keep_mask(x, p, x.shape)
    return (a_coef * torch.where(keep, x, alpha_p) + b_coef).to(x.dtype)


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _one_hot

    return _one_hot(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = torch.sum(x1 * x2, dim=axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] . weight[o] . x2[b]`` (+ ``bias``), weight
    [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        return x.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r,
                                                   w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """NCHW whatever ``data_format`` says, as in the JAX package."""
    r = downscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """NCHW whatever ``data_format`` says, as in the JAX package."""
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w)
    return x.transpose(1, 2).reshape(n, c, h, w)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L], the kernel offset
    minor; the first two ``paddings`` (top/bottom, left/right)."""
    ks, st, pd, dl = (_pair(v) for v in (kernel_sizes, strides, paddings,
                                         dilations))
    return torch.nn.functional.unfold(x, ks, dl, pd[:2], st)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, `unfold`'s adjoint: overlapping blocks summed."""
    ks, st, pd, dl = (_pair(v) for v in (kernel_sizes, strides, paddings,
                                         dilations))
    return torch.nn.functional.fold(x, list(output_sizes), ks, dl, pd[:2],
                                    st)


def _triangle(t):
    return torch.clamp(1 - t.abs(), min=0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, 0.0, out)


def _resize_weights(m, n, kernel, device):
    """``jax.image``'s [m, n] weights of output sample j on input pixel
    i: half-pixel centres, the kernel widened by m / n when downsampling
    (antialiasing), each column normalised, samples outside the input
    zero."""
    inv_scale = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    t = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / max(inv_scale, 1.0)
    w = kernel(t)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to ``size`` (or ``floor(in * scale)``) as
    the JAX package's ``jax.image.resize`` does: ``nearest`` takes input
    ``floor((j + 0.5) * m / n)``; ``linear``/``bilinear``/``trilinear``
    and ``area`` a triangle kernel, ``bicubic`` Keys' cubic (a = -0.5),
    applied one axis at a time as a [m, n] weight matrix; an axis whose
    size does not change is left as it is."""
    channel_first = data_format.startswith("NC")
    nd = x.dim() - 2
    spatial_axes = list(range(2, x.dim())) if channel_first else \
        list(range(1, x.dim() - 1))
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = size if isinstance(size, (list, tuple)) else [size]
        out_spatial = [int(s.item() if isinstance(s, torch.Tensor) else s)
                       for s in size]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * nd
        out_spatial = [int(x.shape[a] * f) for a, f in zip(spatial_axes, sf)]
    kernel = {"nearest": None, "bilinear": _triangle, "linear": _triangle,
              "trilinear": _triangle, "area": _triangle,
              "bicubic": _keys_cubic}[mode]
    out = x
    if kernel is not None and not out.is_floating_point():
        out = out.float()
    for axis, n in zip(spatial_axes, out_spatial):
        m = out.shape[axis]
        if m == n:
            continue
        if kernel is None:
            src = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            out = out.index_select(axis, src)
            continue
        w = _resize_weights(m, n, kernel, x.device).to(out.dtype)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out.to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Sampling grid [N, H, W, 2] (x, y) of ``theta`` [N, 2, 3] over
    ``out_shape`` [N, C, H, W]'s normalised coordinates."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(s) for s in out_shape)
    dev, dt = theta.device, theta.dtype
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=dev, dtype=dt)
    else:
        ys = (torch.arange(h, device=dev, dtype=dt) + 0.5) / h * 2 - 1
        xs = (torch.arange(w, device=dev, dtype=dt) + 0.5) / w * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` [N, C, H, W] at ``grid`` [N, Hg, Wg, 2] (normalised
    x, y): ``nearest`` (rounded half to even, clamped) or ``bilinear``
    with zeros outside (``padding_mode="zeros"``) or the border value
    (else)."""
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1) / 2 * (w - 1)
        iy = (gy + 1) / 2 * (h - 1)
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device)[:, None, None]
    if mode == "nearest":
        ixr = torch.clamp(torch.round(ix), 0, w - 1).long()
        iyr = torch.clamp(torch.round(iy), 0, h - 1).long()
        return x[bidx, :, iyr, ixr].permute(0, 3, 1, 2)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1

    def gather(yy, xx):
        v = x[bidx, :, torch.clamp(yy, 0, h - 1).long(),
              torch.clamp(xx, 0, w - 1).long()]
        if padding_mode == "zeros":
            valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            v = torch.where(valid[..., None], v, 0.0)
        return v

    out = (gather(y0, x0) * (wy0 * wx0)[..., None]
           + gather(y0, x1) * (wy0 * wx1)[..., None]
           + gather(y1, x0) * (wy1 * wx0)[..., None]
           + gather(y1, x1) * (wy1 * wx1)[..., None])
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift over ``seg_num`` frames a clip: the first
    ``int(c * shift_ratio)`` channels take the next frame's, the next as
    many the previous frame's (zeros at the clip's ends)."""
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    fc = int(c * shift_ratio)
    left = torch.cat([a[:, 1:, :fc], torch.zeros_like(a[:, -1:, :fc])], 1)
    right = torch.cat([torch.zeros_like(a[:, :1, fc:2 * fc]),
                       a[:, :-1, fc:2 * fc]], 1)
    return torch.cat([left, right, a[:, :, 2 * fc:]], 2).reshape(nt, c, h, w)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    from .loss import npair_loss as _npair

    return _npair(anchor, positive, labels, l2_reg)

