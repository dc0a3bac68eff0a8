"""The layer base (counterpart: paddle_tpu/nn/layer/layers.py).

`Layer` is a ``torch.nn.Module`` with what Paddle adds: parameters made
from a `ParamAttr` (`create_parameter`), ``set_state_dict`` /
``load_dict`` over ``state_dict()``'s names (torch's own names, which are
the JAX package's: ``blocks.0.qkv.weight`` ...), ``add_parameter``,
``add_sublayer``, ``register_buffer(persistable=)``, ``sublayers`` /
``named_sublayers(include_self=)``, Paddle's forward pre- and post-hooks
(torch's own, which take the same ``hook(layer, inputs[, outputs])``
and return a handle with ``remove()``), ``to(device=, dtype=)`` with
Paddle's names, ``astype``, ``full_name`` and ``functional_state``.
``parameters()``, ``named_parameters()``, ``train()``/``eval()``,
``apply``, ``children()`` and ``state_dict()`` are torch's.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core import dtype as dtype_mod
from ...core.place import Place, to_device
from ...core.tensor import from_numpy
from ...framework.param_attr import ParamAttr

__all__ = ["Parameter", "HookRemoveHelper", "Layer"]

# the handle a hook registration returns (``remove()``)
HookRemoveHelper = torch.utils.hooks.RemovableHandle


class Parameter(nn.Parameter):
    """A trainable tensor built as Paddle builds one: ``Parameter(data,
    dtype=None, name=None, is_bias=False)`` with ``optimize_attr`` (the
    learning-rate multiplier), ``regularizer`` and ``is_bias``."""

    def __new__(cls, data=None, dtype=None, name=None, is_bias=False):
        requires_grad = True
        if isinstance(dtype, bool):  # torch's (data, requires_grad) form
            requires_grad, dtype = dtype, None
        t = data.detach() if isinstance(data, torch.Tensor) else \
            from_numpy(data)
        if dtype is not None:
            t = t.to(dtype_mod.convert_dtype(dtype))
        p = super().__new__(cls, t, requires_grad)
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.is_bias = is_bias
        return p


def _to_args(args, kwargs):
    """torch's ``Module.to`` arguments from Paddle's: dtype names and
    places as torch's, ``blocking=False`` as ``non_blocking``."""
    def conv(a):
        if isinstance(a, str):
            try:
                return dtype_mod.convert_dtype(a)
            except ValueError:
                return to_device(a)
        return to_device(a) if isinstance(a, Place) else a

    blocking = kwargs.pop("blocking", None)
    if blocking is not None:
        kwargs["non_blocking"] = not blocking
    for k in ("device", "dtype"):
        if kwargs.get(k) is not None:
            kwargs[k] = conv(kwargs[k])
        else:
            kwargs.pop(k, None)
    return [conv(a) for a in args], kwargs


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

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """torch's ``register_buffer``, under Paddle's ``persistable``
        (a non-persistable buffer stays out of ``state_dict``); returns
        the tensor."""
        super().register_buffer(name, tensor, persistable
                                if persistent is None else persistent)
        return tensor

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """``(name, layer)`` of every sublayer, depth first, each once
        (``self`` first with ``include_self``)."""
        for name, layer in self.named_modules(
                memo=layers_set, prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    register_forward_post_hook = nn.Module.register_forward_hook

    def to(self, *args, **kwargs):
        """torch's ``to``, also under Paddle's keywords (``device`` a place
        or a name such as ``"cpu"``/``"gpu:0"``, ``dtype`` a dtype name,
        ``blocking``)."""
        args, kwargs = _to_args(args, kwargs)
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return type(self).__name__.lower()

    def functional_state(self):
        """``({name: parameter}, {name: buffer})``, every buffer
        included (the JAX package's staging view of a layer)."""
        return dict(self.named_parameters()), dict(self.named_buffers())
