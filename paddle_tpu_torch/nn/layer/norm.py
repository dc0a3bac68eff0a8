"""Norm layers (counterpart: paddle_tpu/nn/layer/norm.py).

Parameters and buffers carry the JAX package's names, so a JAX layer's
``state_dict()`` (as numpy) loads through ``set_state_dict``: BatchNorm's
``weight``, ``bias`` and the f32 buffers ``_mean`` (zeros) and
``_variance`` (ones), InstanceNorm's ``scale`` and ``bias``.
``weight_attr=False`` makes a layer without affine parameters.  As in
the JAX package, the InstanceNorm layers normalize in NCHW whatever
their ``data_format``.  Each layer takes ``device=`` (default: the
expected place).

`SyncBatchNorm` in training under a ``torch.distributed`` process group
all-reduces each channel's sum and count, then its sum of squared
deviations from the global mean, so every rank normalizes by the
statistics of the global batch (the JAX package gets them from
``pjit``/``shard_map`` seeing that batch); without a group it is
`BatchNorm`.  `SpectralNorm` divides a weight by its largest singular
value from ``power_iters`` power iterations over its trainable
``weight_u``/``weight_v`` (which it reads and does not update, as in the
JAX package).
"""
from __future__ import annotations

import torch

from .. import initializer as init
from ..functional.norm import (batch_norm, group_norm, instance_norm,
                               layer_norm, local_response_norm)
from ...core.place import to_device
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


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


class _AllReduceSum(torch.autograd.Function):
    """The sum over the process group, whose gradient is the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, t):
        from ...distributed import collective

        return collective.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective

        return collective.all_reduce(g.clone())


class SyncBatchNorm(_BatchNormBase):
    def forward(self, x):
        from ...distributed import collective

        if not (self.training and not self._use_global_stats) or \
                not collective._active(None):
            return super().forward(x)
        c_axis = 1 if self._data_format.startswith("NC") else x.dim() - 1
        dims = tuple(i for i in range(x.dim()) if i != c_axis)
        c = x.shape[c_axis]
        x32 = x.float()
        n = torch.full((1,), x.numel() // c, dtype=torch.float32,
                       device=x.device)
        tot = _AllReduceSum.apply(torch.cat([x32.sum(dims), n]))
        mean = tot[:c] / tot[c]
        # two passes, as jnp.var: E[x^2] - mean^2 cancels (and can turn
        # negative) where a channel's mean is large against its spread
        bshape = [1] * x.dim()
        bshape[c_axis] = c
        d = x32 - mean.reshape(bshape)
        var = _AllReduceSum.apply((d * d).sum(dims)) / tot[c]
        with torch.no_grad():
            m = self._momentum
            self._mean.copy_(m * self._mean + (1 - m) * mean)
            self._variance.copy_(m * self._variance + (1 - m) * var)
        # the global statistics applied as running ones (they keep their
        # gradient)
        return batch_norm(x, mean, var, self.weight, self.bias,
                          epsilon=self._epsilon,
                          data_format=self._data_format)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm in it (itself included) replaced
        by a `SyncBatchNorm` holding its parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            with torch.no_grad():
                if layer.weight is not None:
                    out.weight.copy_(layer.weight)
                    out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in layer.named_children():
            out.add_module(name, cls.convert_sync_batchnorm(sub))
        return out


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


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` the largest singular value of
    ``weight`` as a [shape[dim], -1] matrix from ``power_iters`` power
    iterations started at ``weight_u`` [shape[dim]] and ``weight_v``
    [rest], both drawn N(0, 1)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], dtype=dtype, default_initializer=init.Normal(0, 1),
            device=device)
        self.weight_v = self.create_parameter(
            [w], dtype=dtype, default_initializer=init.Normal(0, 1),
            device=device)

    def forward(self, weight):
        w = weight.movedim(self._dim, 0)
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = (u * (mat @ v)).sum()
        return (w / sigma).movedim(0, self._dim)
