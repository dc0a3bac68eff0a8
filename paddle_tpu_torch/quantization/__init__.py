"""Model quantization: QAT and PTQ (counterpart:
paddle_tpu/quantization/__init__.py).

Fake quantization is a quantize-dequantize with a straight-through
estimator, ``x + (q(x) - x).detach()``: forward the quantized value,
backward the identity.  `ImperativeQuantAware` swaps ``nn.Linear`` and
``nn.Conv2D`` for `QuantizedLinear`/`QuantizedConv2D` in place, whose
activation scale is a buffer written in place under ``no_grad`` while
training (an EMA of the batch's absmax, or its running maximum under
`ImperativePTQ`'s calibration) and frozen in eval.  `convert_to_int8`
(`int8`) turns the calibrated twins into integer layers.

Scales stay device tensors and divisions are tensor by tensor, and two
operands meet in the wider of their float types (JAX's promotion,
whatever their ranks), so the quantized values equal the JAX package's.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from ..ops._util import div as _div

__all__ = [
    "fake_quantize_abs_max", "fake_quantize_channel_wise_abs_max",
    "fake_quantize_moving_average_abs_max", "QuantizedLinear",
    "QuantizedConv2D", "ImperativeQuantAware", "ImperativePTQ",
]


def _promote(a, b):
    """``a`` and ``b`` in the wider of their dtypes (JAX promotes a
    bfloat16 array against an f32 0-d one to f32; torch would keep
    bfloat16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _qdq(x, scale, bits):
    """``x`` quantized to ``bits`` with ``scale`` and back, with the
    straight-through gradient."""
    x, scale = _promote(x, scale)
    qmax = _const(float(2 ** (bits - 1) - 1), x)
    s = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s / qmax
    return x + (q - x).detach()


def fake_quantize_abs_max(x, bit_length=8):
    """The whole tensor's absmax as its scale."""
    return _qdq(x, x.detach().abs().amax(), bit_length)


def dequantize_abs_max(x, scale, max_range, name=None):
    """``x * scale / max_range`` in f32 (int8 back to float)."""
    return _div(x.float() * scale, float(max_range))


def dequantize_log(x, dict_table, name=None):
    """Log-quantized uint8 codes to floats through a 128-entry table;
    codes >= 128 give the negative of entry ``code - 128``."""
    code = x.to(torch.int32)
    neg = code >= 128
    idx = torch.where(neg, code - 128, code).clamp(
        0, dict_table.shape[0] - 1)
    val = dict_table[idx.long()]
    return torch.where(neg, -val, val)


def moving_average_abs_max_scale(x, state=None, accum=None,
                                 moving_rate=0.9, name=None):
    """The running absmax scale tracker: ``state = rate * state + 1``,
    ``accum = rate * accum + max|x|``, scale ``accum / state``.  Returns
    ``(x, scale, new_state, new_accum)``."""
    dev = x.device
    st = state if state is not None else torch.ones((), device=dev)
    ac = accum if accum is not None else torch.zeros((), device=dev)
    new_s = moving_rate * st.detach() + 1.0
    new_c = moving_rate * ac.detach() + x.abs().amax()
    return x, new_c / new_s, new_s, new_c


def fake_quantize_channel_wise_abs_max(x, bit_length=8, quant_axis=0):
    """A scale a channel along ``quant_axis`` (weights)."""
    axes = [i for i in range(x.dim()) if i != quant_axis]
    scale = x.detach().abs().amax(dim=axes, keepdim=True)
    return _qdq(x, scale, bit_length)


def fake_quantize_moving_average_abs_max(x, state, bit_length=8, rate=0.9,
                                         update=True):
    """The activation scale as an EMA of the batch's absmax; ``state`` is
    the 0-d scale buffer.  Returns ``(quantized, new_state)``.

    ``update=False`` (eval, deployment) quantizes with the frozen stored
    scale (the batch's absmax only while it was never set);
    ``rate=None`` keeps the running maximum instead of the EMA (PTQ
    calibration over several batches)."""
    cur, s = _promote(x.abs().amax(), state)
    if not update:
        new_s = torch.where(s > 0, s, cur)
    elif rate is None:
        new_s = torch.maximum(s, cur)
    else:
        new_s = torch.where(s > 0, rate * s + (1 - rate) * cur, cur)
    return _qdq(x, new_s, bit_length), new_s


class _Quantized(Layer):
    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        # the wrapped layer is no sublayer (the JAX package's state dict
        # has no ``_inner.*`` names); its parameters are this layer's
        object.__setattr__(self, "_inner", layer)
        self.weight = layer.weight
        if getattr(layer, "bias", None) is not None:
            self.bias = layer.bias
        else:
            self.bias = None
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self.register_buffer("_act_scale", torch.zeros(
            (), dtype=torch.float32, device=layer.weight.device))

    def _quant_input(self, x):
        xq, new_scale = fake_quantize_moving_average_abs_max(
            x, self._act_scale, self._abits, self._rate,
            update=self.training)
        if self.training:
            with torch.no_grad():
                self._act_scale.copy_(new_scale.detach())
        return xq


class QuantizedLinear(_Quantized):
    """``nn.Linear`` with fake quantization of its weight (a scale an
    output channel) and input (the moving-average scale)."""

    def forward(self, x):
        from ..nn import functional as F

        xq = self._quant_input(x)
        wq = fake_quantize_channel_wise_abs_max(self.weight, self._wbits,
                                                quant_axis=1)
        return F.linear(xq, wq, self.bias)


class QuantizedConv2D(_Quantized):
    """``nn.Conv2D`` with fake quantization of its weight (a scale an
    output channel) and input."""

    def forward(self, x):
        from ..nn import functional as F

        xq = self._quant_input(x)
        wq = fake_quantize_channel_wise_abs_max(self.weight, self._wbits,
                                                quant_axis=0)
        inner = self._inner
        return F.conv2d(xq, wq, bias=self.bias, stride=inner._stride,
                        padding=inner._padding, dilation=inner._dilation,
                        groups=inner._groups,
                        data_format=inner._data_format)


class ImperativeQuantAware:
    """Quantization-aware training: `quantize` swaps the model's
    ``Linear``/``Conv2D`` sublayers for their quantized twins in place."""

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 quantizable_layer_type=("Linear", "Conv2D")):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self._types = set(quantizable_layer_type)

    def quantize(self, model: Layer):
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv2D

        def convert(layer):
            for name, sub in list(layer._modules.items()):
                if isinstance(sub, Linear) and "Linear" in self._types:
                    layer._modules[name] = QuantizedLinear(
                        sub, self._wbits, self._abits, self._rate)
                elif isinstance(sub, Conv2D) and "Conv2D" in self._types:
                    layer._modules[name] = QuantizedConv2D(
                        sub, self._wbits, self._abits, self._rate)
                elif sub is not None:
                    convert(sub)

        convert(model)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        """The quantized model as a `jit.save` inference artifact."""
        from .. import jit

        jit.save(model, path, input_spec=input_spec)


class ImperativePTQ:
    """Post-training quantization: the quantized twins with a running
    maximum as the activation scale, collected over ``calib_fn``'s
    forward passes in eval mode, then frozen."""

    def __init__(self, weight_bits=8, activation_bits=8):
        self._wbits = weight_bits
        self._abits = activation_bits

    def quantize(self, model: Layer, calib_fn=None):
        """``calib_fn(model)`` runs representative forward passes."""
        qat = ImperativeQuantAware(self._wbits, self._abits,
                                   moving_rate=None)
        qat.quantize(model)
        if calib_fn is not None:
            model.eval()
            twins = [s for s in model.sublayers(include_self=True)
                     if isinstance(s, (QuantizedLinear, QuantizedConv2D))]
            for sub in twins:
                sub.training = True
            calib_fn(model)
            for sub in twins:
                sub.training = False
        return model


from .int8 import (Int8Conv2D, Int8Linear, convert_to_int8,  # noqa: E402
                   quantize_act, quantize_weight)
