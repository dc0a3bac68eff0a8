"""Pooling functionals (counterpart: paddle_tpu/nn/functional/pooling.py).

Windows as the JAX package's ``lax.reduce_window``: ``padding`` an int,
one int an axis, ``[lo, hi]`` pairs, or ``"SAME"``/``"VALID"``;
``ceil_mode`` widens the high padding until the last partial window
fits.  Max pools pad with ``-inf``; average pools sum in f32 and divide
by the window's count of real elements (``exclusive``, numeric padding)
or by the kernel's size (``exclusive=False``, or a string padding).
``max_pool2d/3d(return_mask=True)`` also return each window's argmax (the
first on ties) as Paddle's index into the input's flattened spatial
volume; the 1-D max pool and the adaptive max pools return no mask, and
``divisor_override`` is taken and not read, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool2d", "spatial_pyramid_pool",
           "spp"]


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _pool_pads(padding, nd):
    if isinstance(padding, str):
        return padding.upper()
    if not isinstance(padding, (list, tuple)) or all(
            isinstance(i, int) for i in padding):
        p = _tup(padding, nd)
        if len(p) == nd:
            return [(i, i) for i in p]
        return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    return [tuple(i) for i in padding]


def _window_sum(a, kernel, stride):
    """Sums of every window (no padding) of ``a`` [N, C, *spatial]."""
    nd = len(kernel)
    if nd == 1:
        return TF.avg_pool2d(a[:, :, None], (1,) + kernel, (1,) + stride,
                             divisor_override=1)[:, :, 0]
    pool = TF.avg_pool2d if nd == 2 else TF.avg_pool3d
    return pool(a, kernel, stride, divisor_override=1)


def _pool_nd(x, kernel, stride, padding, nd, mode, ceil_mode=False,
             exclusive=True, data_format="NCHW"):
    kernel = _tup(kernel, nd)
    stride = _tup(stride if stride is not None else kernel, nd)
    pads = _pool_pads(padding, nd)
    channels_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channels_last else x
    spatial = a.shape[2:]
    if pads == "SAME":
        pads = [((-(-n // s) - 1) * s + k - n) for n, k, s in
                zip(spatial, kernel, stride)]
        pads = [(max(t, 0) // 2, max(t, 0) - max(t, 0) // 2) for t in pads]
    elif pads == "VALID":
        pads = [(0, 0)] * nd
    elif ceil_mode:
        pads = list(pads)
        for d in range(nd):
            lo, hi = pads[d]
            num = spatial[d] + lo + hi - kernel[d]
            need = (-(-num // stride[d])) * stride[d] + kernel[d] \
                - (spatial[d] + lo + hi)
            if need > 0:
                pads[d] = (lo, hi + need)
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    if mode == "max":
        fill = float("-inf") if a.is_floating_point() else \
            torch.iinfo(a.dtype).min
        out = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}[nd](
            TF.pad(a, flat, value=fill), kernel, stride)
    else:
        summed = _window_sum(TF.pad(a.float(), flat), kernel, stride)
        if exclusive and not isinstance(padding, str):
            ones = torch.ones((1, 1) + tuple(spatial), device=a.device)
            counts = _window_sum(TF.pad(ones, flat), kernel, stride)
            out = (summed / counts).to(a.dtype)
        else:
            out = (summed / float(np.prod(kernel))).to(a.dtype)
    return out.movedim(1, -1) if channels_last else out


def _max_pool_with_index(x, kernel_size, stride, padding, ceil_mode, nd,
                         channels_last):
    """Max pool and each window's argmax as a flat index into the input's
    spatial volume (the JAX package's ``_max_pool_nd_with_index``): the
    input padded with the dtype's lowest finite value, windows gathered
    by ``unfold``, the first maximum of each taken."""
    ks = _tup(kernel_size, nd)
    st = _tup(stride or kernel_size, nd)
    pd = _tup(padding, nd)
    a = x.movedim(-1, 1) if channels_last else x
    spatial = a.shape[2:]

    def osize(i, k, p, s):
        num = i + 2 * p - k
        return (num + s - 1) // s + 1 if ceil_mode else num // s + 1

    osz = [osize(*t) for t in zip(spatial, ks, pd, st)]
    extra = [max((o - 1) * s + k - (i + 2 * p), 0)
             for o, s, k, i, p in zip(osz, st, ks, spatial, pd)]
    low = torch.finfo(a.dtype).min if a.is_floating_point() else \
        torch.iinfo(a.dtype).min
    ap = TF.pad(a, [v for p, e in zip(reversed(pd), reversed(extra))
                    for v in (p, p + e)], value=low)
    win = ap
    for d in range(nd):
        win = win.unfold(2 + d, ks[d], st[d])
    win = win.reshape(tuple(win.shape[:2 + nd]) + (-1,))
    arg = torch.argmax(win, dim=-1)
    out = torch.gather(win, -1, arg[..., None])[..., 0]
    pos, kcoord = arg, []
    for k in reversed(ks):
        kcoord.append(pos % k)
        pos = pos // k
    kcoord = kcoord[::-1]
    gidx = torch.zeros_like(arg)
    for d in range(nd):
        shape = [1] * arg.dim()
        shape[2 + d] = osz[d]
        base = torch.arange(osz[d], device=a.device).reshape(shape) * st[d]
        gidx = gidx * spatial[d] + (base + kcoord[d] - pd[d])
    if channels_last:
        out, gidx = out.movedim(1, -1), gidx.movedim(1, -1)
    return out, gidx


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, "max", ceil_mode,
                    data_format="NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding,
                                    ceil_mode, 2, data_format == "NHWC")
    return _pool_nd(x, kernel_size, stride, padding, 2, "max", ceil_mode,
                    data_format=data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding,
                                    ceil_mode, 3, data_format == "NDHWC")
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", ceil_mode,
                    data_format=data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", ceil_mode,
                    exclusive, data_format="NCL")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", ceil_mode,
                    exclusive, data_format=data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", ceil_mode,
                    exclusive, data_format=data_format)


def _adaptive_pool_nd(x, output_size, nd, mode, data_format):
    """Each spatial axis in turn cut into ``output_size`` bins: equal
    blocks where the size divides, else bin ``i`` over ``[floor(i * n /
    o), ceil((i + 1) * n / o))``; max or mean over each."""
    out_sizes = _tup(output_size, nd) if output_size is not None else \
        (None,) * nd
    start = 2 if data_format.startswith("NC") else 1
    out = x
    for d in range(nd):
        axis = start + d
        n = out.shape[axis]
        o = out_sizes[d] if out_sizes[d] is not None else n
        if n % o == 0:
            r = out.reshape(tuple(out.shape[:axis]) + (o, n // o)
                            + tuple(out.shape[axis + 1:]))
            out = r.amax(axis + 1) if mode == "max" else r.mean(axis + 1)
            continue
        segs = []
        for i in range(o):
            lo, hi = (i * n) // o, ((i + 1) * n + o - 1) // o
            block = out.narrow(axis, lo, hi - lo)
            segs.append(block.amax(axis, keepdim=True) if mode == "max"
                        else block.mean(axis, keepdim=True))
        out = torch.cat(segs, axis)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool_nd(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool_nd(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool_nd(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool_nd(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool_nd(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool_nd(x, output_size, 3, "max", "NCDHW")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """`max_pool2d`'s inverse: each pooled value written at its flat
    ``indices`` position of a zero [N, C, H, W] (``output_size``, else
    the pool's input size)."""
    ks = _tup(kernel_size, 2)
    st = _tup(stride or ks, 2)
    pd = _tup(padding, 2)
    n, c, h, w = x.shape
    if output_size is not None:
        oh, ow = output_size[-2:]
    else:
        oh = (h - 1) * st[0] + ks[0] - 2 * pd[0]
        ow = (w - 1) * st[1] + ks[1] - 2 * pd[1]
    flat = x.new_zeros(n, c, oh * ow)
    flat = flat.scatter(2, indices.reshape(n, c, -1).long(),
                        x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)


def spatial_pyramid_pool(x, pyramid_height, pool_type="max", name=None):
    """Adaptive max (or avg) pools at 1, 2, 4, ... 2^(H-1) bins a side,
    each flattened, concatenated."""
    outs = []
    for level in range(int(pyramid_height)):
        pool = adaptive_max_pool2d if pool_type == "max" else \
            adaptive_avg_pool2d
        p = pool(x, 2 ** level)
        outs.append(p.reshape(p.shape[0], -1))
    return torch.cat(outs, 1)


spp = spatial_pyramid_pool
