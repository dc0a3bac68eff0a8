"""Pooling layers (counterpart: paddle_tpu/nn/layer/pooling.py).

As in the JAX package, the pooling layers pass only ``kernel_size``,
``stride`` and ``padding`` on (``ceil_mode``, ``exclusive``,
``return_mask``, ``data_format`` and ``divisor_override`` are taken and
not read), ``AdaptiveAvgPool3D`` pools NCDHW whatever its
``data_format``, and the adaptive max pools return no mask.
"""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


def _pool_layer(cls_name, fn_name):
    def __init__(self, kernel_size=None, stride=None, padding=0, *args,
                 **kwargs):
        Layer.__init__(self)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return getattr(F, fn_name)(x, self.kernel_size, self.stride,
                                   self.padding)

    return type(cls_name, (Layer,), dict(
        __init__=__init__, forward=forward, __module__=__name__,
        __doc__=f"`functional.{fn_name}` as a layer."))


MaxPool1D = _pool_layer("MaxPool1D", "max_pool1d")
MaxPool2D = _pool_layer("MaxPool2D", "max_pool2d")
MaxPool3D = _pool_layer("MaxPool3D", "max_pool3d")
AvgPool1D = _pool_layer("AvgPool1D", "avg_pool1d")
AvgPool2D = _pool_layer("AvgPool2D", "avg_pool2d")
AvgPool3D = _pool_layer("AvgPool3D", "avg_pool3d")


class _Adaptive(Layer):
    _fn = None

    def __init__(self, output_size, data_format=None, return_mask=False,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size)


class AdaptiveAvgPool1D(_Adaptive):
    _fn = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Adaptive):
    _fn = "adaptive_avg_pool2d"

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(_Adaptive):
    _fn = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Adaptive):
    _fn = "adaptive_max_pool1d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool2D(_Adaptive):
    _fn = "adaptive_max_pool2d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool3D(_Adaptive):
    _fn = "adaptive_max_pool3d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)
