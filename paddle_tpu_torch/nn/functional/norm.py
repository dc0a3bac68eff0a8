"""Normalization functionals (counterpart: paddle_tpu/nn/functional/norm.py).

Statistics in f32 with the population variance (``jnp.var``), the
result in the input's dtype.  ``layer_norm`` over one axis with weight
and bias goes through `fused_layer_norm` (kernel K5 under
``FLAGS_use_pallas_layernorm``), the JAX package's route; every other
form is composed.  ``batch_norm`` follows Paddle, not
``torch.nn.functional.batch_norm``: ``momentum`` (0.9) weights the
*running* value, the running variance is the population variance, and
the output is one per-channel ``x * s + t`` applied in the input's
dtype from f32 statistics.
"""
from __future__ import annotations

import torch

from ...ops.layer_norm import fused_layer_norm

__all__ = ["normalize", "batch_norm", "layer_norm", "group_norm",
           "instance_norm", "local_response_norm"]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def _stats(a32, dims, keepdim=False):
    return (a32.mean(dim=dims, keepdim=keepdim),
            a32.var(dim=dims, correction=0, keepdim=keepdim))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Normalize over every axis but the channel axis (1, or the last for
    a channels-last ``data_format``) with the batch's statistics in
    training (``use_global_stats`` off), which also update the running
    buffers in place (``momentum * running + (1 - momentum) * batch``),
    else with the running ones."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    dims = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = -1
    if training and not use_global_stats:
        mean, var = _stats(x.float(), dims)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * var)
    else:
        mean, var = running_mean, running_var.float()
    rstd = torch.rsqrt(var + epsilon)
    if weight is not None:
        s = weight * rstd
        t = bias - mean * s
    else:
        s, t = rstd, -mean * rstd
    return x * s.reshape(bshape).to(x.dtype) + t.reshape(bshape).to(x.dtype)


def _affine(out, weight, bias, bshape):
    if weight is None:
        return out
    out = out * weight.reshape(bshape).to(out.dtype)
    return out if bias is None else out + bias.reshape(bshape).to(out.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(normalized_shape)
    if weight is not None and bias is not None and nd == 1:
        shape = x.shape
        return fused_layer_norm(x.reshape(-1, shape[-1]), weight, bias,
                                epsilon).reshape(shape)
    a32 = x.float()
    mean, var = _stats(a32, tuple(range(-nd, 0)), keepdim=True)
    out = ((a32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(out, weight, bias, list(normalized_shape))


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    a = x.movedim(c_axis, 1)
    n, c = a.shape[0], a.shape[1]
    g = a.reshape(n, num_groups, c // num_groups, *a.shape[2:]).float()
    mean, var = _stats(g, tuple(range(2, g.dim())), keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    out = _affine(out.reshape(a.shape), weight, bias,
                  [1, c] + [1] * (a.dim() - 2))
    return out.movedim(1, c_axis)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Normalize each (sample, channel) over the spatial axes; the
    running buffers, ``use_input_stats`` and ``momentum`` are taken and
    not read, as in the JAX package."""
    nd = x.dim()
    channel_first = data_format.startswith("NC")
    dims = tuple(range(2, nd)) if channel_first else tuple(range(1, nd - 1))
    a32 = x.float()
    mean, var = _stats(a32, dims, keepdim=True)
    out = ((a32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    bshape = [1, -1] + [1] * (nd - 2) if channel_first else \
        [1] * (nd - 1) + [-1]
    return _affine(out, weight, bias, bshape)


def local_response_norm(x, size, alpha=0.0001, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over a
    window of ``size`` channels (``size // 2`` before, the rest after)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = torch.square(x).movedim(c_axis, -1)
    half = size // 2
    padded = torch.nn.functional.pad(sq, (half, size - half - 1))
    c = x.shape[c_axis]
    acc = sum(padded[..., i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * acc.movedim(-1, c_axis), beta)
