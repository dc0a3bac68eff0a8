"""The layer base (counterpart: paddle_tpu/nn/layer/layers.py).

`Layer` is a ``torch.nn.Module`` with what Paddle adds that the port's
layers and checkpoints use: parameters made from a `ParamAttr`
(`create_parameter`) and ``set_state_dict`` / ``load_dict`` over
``state_dict()``'s names (torch's own names, which are the JAX package's:
``blocks.0.qkv.weight`` ...).  ``parameters()``, ``named_parameters()``,
``train()``/``eval()``, ``state_dict()`` and the forward hooks are
torch's.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core import dtype as dtype_mod
from ...core.place import to_device
from ...core.tensor import from_numpy
from ...framework.param_attr import ParamAttr

__all__ = ["Layer"]


class Layer(nn.Module):
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A parameter of ``shape`` drawn by ``attr``'s initializer, else
        ``default_initializer``, else Xavier uniform (a weight) or zeros
        (a bias), carrying ``attr``'s learning-rate multiplier
        (``optimize_attr``), regularizer and trainability."""
        from .. import initializer as init

        dtype = dtype_mod.convert_dtype(dtype) or torch.float32
        if default_initializer is None:
            default_initializer = init.Constant(0.0) if is_bias else \
                init.XavierUniform()
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            raise ValueError("attr=False means no parameter; the caller "
                             "handles it before create_parameter")
        initializer = attr.initializer or default_initializer
        p = nn.Parameter(initializer._init(shape, dtype,
                                           to_device(device)),
                         requires_grad=attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.is_bias = is_bias
        return p

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or numpy arrays, by
        `state_dict`'s names) into the tensor of that name, on its device
        and in its dtype.  Returns ``(missing, unexpected)`` names; a
        shape mismatch raises ValueError."""
        own = self.state_dict(keep_vars=True)
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            src = v.detach() if isinstance(v, torch.Tensor) else \
                from_numpy(v)
            tgt = own[k]
            if list(src.shape) != list(tgt.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{list(src.shape)} vs {list(tgt.shape)}")
            tgt.copy_(src.to(device=tgt.device, dtype=tgt.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
