"""Int8 execution (counterpart: paddle_tpu/quantization/int8.py).

QAT or PTQ (`ImperativeQuantAware`, `ImperativePTQ`) calibrates the
activation scales; `convert_to_int8` then freezes int8 weights and
scales and swaps the fake-quant twins for `Int8Linear`/`Int8Conv2D`,
whose products are integer ones: int8 operands, an exact s32
accumulator, dequantized as the JAX package does, by
``act_scale * w_scale / Q_MAX**2``, then the bias, then the input's
dtype.

**The integer product.** On the card it is ``torch._int_mm`` (s8 x s8 ->
s32 through cuBLASLt), with M, K and N padded with zeros to its shape
rules (zeros leave the sums exact); on the CPU an int32 ``mm``.  A
convolution is an im2col of the int8 activations (strided views, which
work in any integer dtype where ``F.unfold`` is floating-point only)
through the same product, one a group.  No float route exists on the
card: an f32 product of int8 values is not exact once
``127**2 * K`` passes ``2**24`` (K > 1040), and TF32 is coarser still.
Every integer product adds one to `counts` (``"linear"`` or ``"conv"``
by layer, ``"cuda"`` where ``_int_mm`` ran), so a caller can show that
each converted layer ran it.

The arithmetic is paddle_tpu's, in its order, so the int8 payloads
come out bit-equal to the JAX package's; scales stay device tensors and
every division is tensor by tensor (CUDA divides by a host scalar as a
multiply by its reciprocal, which moves round-half cases by one level).
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from ..ops._util import div as _div

__all__ = ["Q_MAX", "quantize_weight", "quantize_act", "Int8Linear",
           "Int8Conv2D", "convert_to_int8", "counts", "reset_counts"]

Q_MAX = 127.0

_COUNTS = {"linear": 0, "conv": 0, "cuda": 0}


def counts() -> dict:
    """Integer products run since `reset_counts`: one a layer call
    (``"linear"``, ``"conv"``), and ``"cuda"`` those through
    ``torch._int_mm``."""
    return dict(_COUNTS)


def reset_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def quantize_weight(w: torch.Tensor, quant_axis: int):
    """Per-channel symmetric int8 along ``quant_axis``: returns ``(q int8
    of w's shape, scale f32 [channels])`` with ``scale`` the channel's
    absmax and ``q = clip(round(w / max(scale, 1e-30) * Q_MAX), ±Q_MAX)``
    — divide first, then multiply, as paddle_tpu does.  ``torch.round``
    rounds half to even, like ``jnp.round``."""
    red = [i for i in range(w.dim()) if i != quant_axis]
    scale = w.abs().amax(dim=red)
    shape = [1] * w.dim()
    shape[quant_axis] = -1
    q = torch.clamp(torch.round(w / torch.clamp(scale.reshape(shape),
                                                min=1e-30) * Q_MAX),
                    -Q_MAX, Q_MAX).to(torch.int8)
    return q, scale


def quantize_act(x, scale):
    """Per-tensor symmetric int8 with a calibrated static ``scale`` (a
    0-d tensor), in f32 as JAX promotes a narrower float against it."""
    x = x.float()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / torch.clamp(scale, min=1e-30)
                                   * Q_MAX), -Q_MAX, Q_MAX).to(torch.int8)


def _round_up(n, m):
    return -(-n // m) * m


def padded_int_mm(a, b):
    """``a @ b`` of int8 [M, K] and [K, N] as s32 through
    ``torch._int_mm``: M is padded to more than 16 and every dim to a
    multiple of 16 with zeros, which leave every sum exact (cuBLASLt
    refuses an int8 product whose leading dims are multiples of 8 only:
    LeNet's 120 x 84 layer, K 120 and N 88)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _round_up(max(m, 17), 16), _round_up(k, 16), \
        _round_up(n, 16)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _int8_mm(a, b):
    """The exact s32 product of int8 ``a`` [M, K] and ``b`` [K, N]."""
    if a.is_cuda:
        _COUNTS["cuda"] += 1
        return padded_int_mm(a, b)
    return torch.mm(a.to(torch.int32), b.to(torch.int32))


def _geometry(layer, spatial):
    """``layer``'s stride, dilation and ``[(lo, hi), (lo, hi)]`` padding
    over an input of ``spatial`` size, as ``F.conv2d`` reads them
    (``"SAME"``/``"VALID"``, one int, one an axis, or a pair an axis)."""
    from ..nn.functional.conv import _pairs, _same_pads, _tup

    stride, dil = _tup(layer._stride, 2), _tup(layer._dilation, 2)
    pads = _pairs(layer._padding, 2)
    if pads == "SAME":
        pads = _same_pads(spatial, layer.qweight.shape[2:], stride, dil)
    elif pads == "VALID":
        pads = [(0, 0), (0, 0)]
    return stride, dil, pads


def _im2col(q, kernel, stride, pads, dilation):
    """int8 NCHW ``q`` as rows [N * OH * OW, C * kh * kw] (channel-major
    columns, as OIHW weights flatten), and (OH, OW)."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    (pt, pb), (pl, pr) = pads
    q = torch.nn.functional.pad(q, (pl, pr, pt, pb))
    cols = q.unfold(2, (kh - 1) * dh + 1, sh).unfold(
        3, (kw - 1) * dw + 1, sw)                 # [N, C, OH, OW, eh, ew]
    cols = cols[..., ::dh, ::dw]
    n, c, oh, ow = cols.shape[:4]
    return cols.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow,
                                                  c * kh * kw), (oh, ow)


class Int8Linear(Layer):
    """``y = dequant(s8(x) @ s8(W)) + b``: an exact s32 product, per
    output-channel weight scales (``weight`` [in, out])."""

    def __init__(self, weight, bias, act_scale):
        super().__init__()
        weight = weight.detach()
        qw, wscale = quantize_weight(weight, quant_axis=1)
        self.register_buffer("qweight", qw)
        self.register_buffer("w_scale", wscale.float())
        self.register_buffer("act_scale", torch.as_tensor(
            act_scale, dtype=torch.float32,
            device=weight.device).detach().clone().reshape(()))
        if bias is not None:
            self.register_buffer("bias_f32", bias.detach().float().clone())
        else:
            self.bias_f32 = None

    def accumulate(self, x):
        """The s32 accumulator [..., out] of the int8 product of ``x``."""
        qx = quantize_act(x, self.act_scale)
        acc = _int8_mm(qx.reshape(-1, qx.shape[-1]), self.qweight)
        _COUNTS["linear"] += 1
        return acc.reshape(*qx.shape[:-1], self.qweight.shape[1])

    def forward(self, x):
        acc = self.accumulate(x)
        deq = acc.float() * _div(self.act_scale * self.w_scale,
                                 Q_MAX * Q_MAX)
        if self.bias_f32 is not None:
            deq = deq + self.bias_f32
        return deq.to(x.dtype)


class Int8Conv2D(Layer):
    """A 2-D convolution as an exact s32 product (im2col of the int8
    activations), per output-channel weight scales (OIHW, quant_axis 0);
    NCHW or NHWC, string, symmetric or asymmetric padding, groups."""

    def __init__(self, weight, bias, act_scale, stride, padding, dilation,
                 groups, data_format="NCHW"):
        super().__init__()
        weight = weight.detach()
        qw, wscale = quantize_weight(weight, quant_axis=0)
        self.register_buffer("qweight", qw)
        self.register_buffer("w_scale", wscale.float())
        self.register_buffer("act_scale", torch.as_tensor(
            act_scale, dtype=torch.float32,
            device=weight.device).detach().clone().reshape(()))
        if bias is not None:
            self.register_buffer("bias_f32", bias.detach().float().clone())
        else:
            self.bias_f32 = None
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format

    def accumulate(self, x):
        """The s32 accumulator [N, O, OH, OW] (NHWC: [N, OH, OW, O]) of
        the int8 convolution of ``x``."""
        qx = quantize_act(x, self.act_scale)
        nhwc = self._data_format not in ("NCHW", "NCL", "NCDHW")
        if nhwc:
            qx = qx.permute(0, 3, 1, 2)
        o, cg, kh, kw = self.qweight.shape
        stride, dil, pads = _geometry(self, qx.shape[2:])
        cols, (oh, ow) = _im2col(qx, (kh, kw), stride, pads, dil)
        g = max(int(self._groups), 1)
        kg, og = cg * kh * kw, o // g
        w = self.qweight.reshape(o, kg)
        acc = torch.cat([_int8_mm(cols[:, i * kg:(i + 1) * kg].contiguous(),
                                  w[i * og:(i + 1) * og].t().contiguous())
                         for i in range(g)], dim=1) if g > 1 else \
            _int8_mm(cols, w.t().contiguous())
        _COUNTS["conv"] += 1
        acc = acc.reshape(qx.shape[0], oh, ow, o)
        return acc if nhwc else acc.permute(0, 3, 1, 2)

    def forward(self, x):
        acc = self.accumulate(x)
        nhwc = self._data_format not in ("NCHW", "NCL", "NCDHW")
        ch_shape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
        deq = acc.float() * _div(
            self.act_scale * self.w_scale.reshape(ch_shape), Q_MAX * Q_MAX)
        if self.bias_f32 is not None:
            deq = deq + self.bias_f32.reshape(ch_shape)
        return deq.to(x.dtype)


def convert_to_int8(model: Layer) -> Layer:
    """Swap the PTQ/QAT fake-quant twins (`QuantizedLinear`/
    `QuantizedConv2D`, with a calibrated ``_act_scale``) for executing
    int8 layers in place; an uncalibrated scale raises ValueError."""
    from . import QuantizedConv2D, QuantizedLinear

    def _scale_or_raise(sub, name):
        s = float(sub._act_scale)
        if not s > 0:
            raise ValueError(
                f"convert_to_int8: layer {name!r} has no calibrated "
                "activation scale — run PTQ calibration (ImperativePTQ."
                "quantize(model, calib_fn=...)) or QAT steps first; "
                "converting with scale 0 would saturate every "
                "activation")
        return sub._act_scale

    def convert(layer):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, QuantizedLinear):
                layer._modules[name] = Int8Linear(
                    sub.weight, getattr(sub, "bias", None),
                    _scale_or_raise(sub, name))
            elif isinstance(sub, QuantizedConv2D):
                inner = sub._inner
                layer._modules[name] = Int8Conv2D(
                    sub.weight, getattr(sub, "bias", None),
                    _scale_or_raise(sub, name), inner._stride,
                    inner._padding, inner._dilation, inner._groups,
                    getattr(inner, "_data_format", "NCHW"))
            elif sub is not None:
                convert(sub)

    convert(model)
    return model
