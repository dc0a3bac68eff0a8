"""Activation layers (counterpart: paddle_tpu/nn/layer/activation.py).

Each layer calls the functional of its name with the arguments it was
built with (positional in the functional's order, or by keyword;
``name`` is dropped).  As in the JAX package, ``RReLU`` passes no
``training``, so it applies the mean slope in train mode too.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
           "GELU", "LeakyReLU", "ELU", "CELU", "SELU", "Silu", "Swish",
           "Mish", "Hardtanh", "Hardsigmoid", "Hardswish", "Hardshrink",
           "Softshrink", "Softplus", "Softsign", "ThresholdedReLU",
           "Softmax", "LogSoftmax", "Maxout", "GLU", "RReLU", "PReLU"]


def _act_layer(cls_name, fn_name, **defaults):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._kw = dict(defaults)
        self._kw.update(zip(defaults, args))
        self._kw.update((k, v) for k, v in kwargs.items() if k != "name")

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    return type(cls_name, (Layer,), dict(
        __init__=__init__, forward=forward, extra_repr=extra_repr,
        __module__=__name__, __doc__=f"`functional.{fn_name}` as a layer."))


ReLU = _act_layer("ReLU", "relu")
ReLU6 = _act_layer("ReLU6", "relu6")
Sigmoid = _act_layer("Sigmoid", "sigmoid")
LogSigmoid = _act_layer("LogSigmoid", "log_sigmoid")
Tanh = _act_layer("Tanh", "tanh")
Tanhshrink = _act_layer("Tanhshrink", "tanhshrink")
GELU = _act_layer("GELU", "gelu", approximate=False)
LeakyReLU = _act_layer("LeakyReLU", "leaky_relu", negative_slope=0.01)
ELU = _act_layer("ELU", "elu", alpha=1.0)
CELU = _act_layer("CELU", "celu", alpha=1.0)
SELU = _act_layer("SELU", "selu")
Silu = _act_layer("Silu", "silu")
Swish = _act_layer("Swish", "swish")
Mish = _act_layer("Mish", "mish")
Hardtanh = _act_layer("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardsigmoid = _act_layer("Hardsigmoid", "hardsigmoid")
Hardswish = _act_layer("Hardswish", "hardswish")
Hardshrink = _act_layer("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _act_layer("Softshrink", "softshrink", threshold=0.5)
Softplus = _act_layer("Softplus", "softplus", beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", "softsign")
ThresholdedReLU = _act_layer("ThresholdedReLU", "thresholded_relu",
                             threshold=1.0)
Softmax = _act_layer("Softmax", "softmax", axis=-1)
LogSoftmax = _act_layer("LogSoftmax", "log_softmax", axis=-1)
Maxout = _act_layer("Maxout", "maxout", groups=2, axis=1)
GLU = _act_layer("GLU", "glu", axis=-1)
RReLU = _act_layer("RReLU", "rrelu", lower=0.125, upper=1.0 / 3.0)


class PReLU(Layer):
    """`functional.prelu` with a learned slope, ``num_parameters`` of
    them (1: shared; else one a channel), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, dtype=dtype,
            default_initializer=Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)

