"""Norm layers (counterpart: paddle_tpu/nn/layer/norm.py).

Parameters and buffers carry the JAX package's names, so a JAX layer's
``state_dict()`` (as numpy) loads through ``set_state_dict``: BatchNorm's
``weight``, ``bias`` and the f32 buffers ``_mean`` (zeros) and
``_variance`` (ones), InstanceNorm's ``scale`` and ``bias``.
``weight_attr=False`` makes a layer without affine parameters.  As in
the JAX package, the InstanceNorm layers normalize in NCHW whatever
their ``data_format``.  Each layer takes ``device=`` (default: the
expected place).
"""
from __future__ import annotations

import torch

from .. import initializer as init
from ..functional.norm import (batch_norm, group_norm, instance_norm,
                               layer_norm, local_response_norm)
from ...core.place import to_device
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm"]


def _affine_params(layer, shape, weight_attr, bias_attr, dtype, device):
    """``(weight, bias)`` of ``shape`` (1 and 0), or ``(None, None)``
    for ``weight_attr=False``."""
    if weight_attr is False:
        return None, None
    return (layer.create_parameter(shape, attr=weight_attr, dtype=dtype,
                                   default_initializer=init.Constant(1.0),
                                   device=device),
            layer.create_parameter(shape, attr=bias_attr, dtype=dtype,
                                   is_bias=True, device=device))


class _BatchNormBase(Layer):
    """`functional.batch_norm` over ``num_features`` channels, with the
    batch's statistics in train mode (which update ``_mean`` and
    ``_variance``) and the running ones in eval mode."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _affine_params(
            self, [num_features], weight_attr, bias_attr, dtype, device)
        device = to_device(device)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight 1,
    bias 0 unless ``weight_attr`` / ``bias_attr`` name another
    initializer, none with ``weight_attr=False``."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight, self.bias = _affine_params(
            self, self._normalized_shape, weight_attr, bias_attr, dtype,
            device)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _affine_params(
            self, [num_channels], weight_attr, bias_attr, dtype, device)

    def forward(self, x):
        return group_norm(x, self._num_groups, self._epsilon, self.weight,
                          self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.scale, self.bias = _affine_params(
            self, [num_features], weight_attr, bias_attr, dtype, device)

    def forward(self, x):
        return instance_norm(x, weight=self.scale, bias=self.bias,
                             eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return local_response_norm(x, self.size, self.alpha, self.beta,
                                   self.k, self.data_format)
