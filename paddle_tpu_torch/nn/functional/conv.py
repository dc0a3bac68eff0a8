"""Convolution functionals (counterpart: paddle_tpu/nn/functional/conv.py).

Weights are ``[out, in / groups, *k]`` (``[in, out / groups, *k]`` for
the transposes) whatever ``data_format`` is; a channels-last input
(``NLC``, ``NHWC``, ``NDHWC``) is moved to channels-first around the
convolution.  ``padding`` is Paddle's: ``"SAME"`` (XLA's rule: the output
is ``ceil(in / stride)`` long, the extra row low on the right) or
``"VALID"``, an int, one int an axis, ``[lo, hi]`` pairs flattened or
nested.  Uneven pairs are padded ahead of the convolution.  The
transposes take ``output_padding`` (zeros past the last full window,
where it exceeds the high padding) and, as in the JAX package, ignore
``output_size``.  WHITE ops under `amp.auto_cast`.  On the card an f32
convolution runs in f32: the first turns cuDNN's TF32 off for the
process (`_cast`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tup(v, nd):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * nd


def _pairs(padding, nd):
    """``padding`` as ``[(lo, hi)]`` an axis, or its upper-cased string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _same_pads(spatial, kernel, stride, dilation):
    out = []
    for n, k, s, d in zip(spatial, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _channels_first(x, channels_last):
    return x.movedim(-1, 1) if channels_last else x


def _bias(out, bias):
    if bias is None:
        return out
    return out + bias.reshape([1, -1] + [1] * (out.dim() - 2))


def _cast(x, weight, bias):
    """The inputs as `amp.auto_cast` has them.  An f32 convolution on the
    card is computed in f32, as the port's matmuls are: PyTorch lets cuDNN
    round f32 products to TF32 by default (about 1e-3 of a 576-term sum),
    so the port turns that off for the process, which also holds for the
    backward cuDNN runs later."""
    x, weight, bias = amp.cast_inputs(amp.WHITE, x, weight, bias)
    if x.is_cuda and x.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    return x, weight, bias


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format):
    x, weight, bias = _cast(x, weight, bias)
    channels_last = not data_format.startswith("NC")
    stride, dilation = _tup(stride, nd), _tup(dilation, nd)
    a = _channels_first(x, channels_last)
    pads = _pairs(padding, nd)
    if pads == "SAME":
        pads = _same_pads(a.shape[2:], weight.shape[2:], stride, dilation)
    elif pads == "VALID":
        pads = [(0, 0)] * nd
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        a = TF.pad(a, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        sym = 0
    out = _bias(_CONV[nd](a, weight, None, stride, sym, dilation, groups),
                bias)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd, data_format):
    """The full transposed convolution (no padding), then each axis cut
    by its ``(lo, hi)`` padding and extended by ``output_padding``."""
    x, weight, bias = _cast(x, weight, bias)
    channels_last = not data_format.startswith("NC")
    stride, dilation = _tup(stride, nd), _tup(dilation, nd)
    out_pad = _tup(output_padding, nd)
    pads = _pairs(padding, nd)
    if isinstance(pads, str):
        raise ValueError("string padding not supported for conv_transpose")
    a = _channels_first(x, channels_last)
    full = _CONV_T[nd](a, weight, None, stride, 0, 0, groups, dilation)
    out = TF.pad(full, [v for (lo, hi), op in zip(reversed(pads),
                                                  reversed(out_pad))
                        for v in (-lo, op - hi)])
    out = _bias(out, bias)
    return out.movedim(1, -1) if channels_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format)
