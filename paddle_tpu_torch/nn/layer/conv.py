"""Convolution layers (counterpart: paddle_tpu/nn/layer/conv.py).

Weights ``[out, in / groups, *k]`` (transposes ``[in, out / groups,
*k]``) drawn as the JAX package draws them: Kaiming-uniform with
``fan_in = in_channels * prod(k)``, the bias uniform in ``±1 /
sqrt(fan_in)``.  ``padding_mode`` is taken and not read, and the
transposes' ``output_size`` too, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as init
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    _nd = 2
    _transpose = False
    _default_format = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 output_padding=0, device=None, dtype=torch.float32):
        super().__init__()
        nd = self._nd
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = ks
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format or self._default_format
        self._output_padding = output_padding
        wshape = ([in_channels, out_channels // groups] if self._transpose
                  else [out_channels, in_channels // groups]) + ks
        fan_in = in_channels * int(np.prod(ks))
        self.weight = self.create_parameter(
            wshape, attr=weight_attr, dtype=dtype, device=device,
            default_initializer=init.KaimingUniform(fan_in=fan_in))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device, default_initializer=init.Uniform(-bound, bound))

    def forward(self, x, output_size=None):
        nd = self._nd
        if self._transpose:
            return getattr(F, f"conv{nd}d_transpose")(
                x, self.weight, self.bias, self._stride, self._padding,
                self._output_padding, self._groups, self._dilation,
                self._data_format)
        return getattr(F, f"conv{nd}d")(
            x, self.weight, self.bias, self._stride, self._padding,
            self._dilation, self._groups, self._data_format)


class Conv1D(_ConvNd):
    _nd, _default_format = 1, "NCL"


class Conv2D(_ConvNd):
    _nd, _default_format = 2, "NCHW"


class Conv3D(_ConvNd):
    _nd, _default_format = 3, "NCDHW"


class _ConvTransposeNd(_ConvNd):
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding, device,
                         dtype)


class Conv1DTranspose(_ConvTransposeNd):
    _nd, _default_format = 1, "NCL"


class Conv2DTranspose(_ConvTransposeNd):
    _nd, _default_format = 2, "NCHW"


class Conv3DTranspose(_ConvTransposeNd):
    _nd, _default_format = 3, "NCDHW"
