"""Autograd (counterpart: paddle_tpu/autograd and paddle_tpu/core/tape.py).

The JAX package records a tape of ``jax.vjp`` pullbacks and walks it
backward; the port's tape is torch autograd's graph.  `backward`,
`grad` (double grad with ``create_graph``) and `PyLayer` keep the JAX
package's contracts:

* a ``None`` output cotangent is ones;
* `grad` leaves every ``.grad`` untouched, retains the graph unless
  ``retain_graph=False`` is given, and returns zeros for an input the
  outputs do not reach (None with ``allow_unused=True``);
* a `PyLayer` runs its ``forward`` without recording and its
  ``backward`` as the node's gradient (a ``torch.autograd.Function``);
  ``ctx.saved_tensor`` is a property, as there.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _cotangents(outputs, grad_outputs):
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = _as_list(grad_outputs)
    return [torch.ones_like(t) if g is None else g
            for t, g in zip(outputs, grad_outputs)]


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """Accumulate the gradients of ``tensors`` into every leaf's
    ``.grad``."""
    tensors = _as_list(tensors)
    torch.autograd.backward(tensors, _cotangents(tensors, grad_tensors),
                            retain_graph=retain_graph or create_graph,
                            create_graph=create_graph)


class no_grad(contextlib.ContextDecorator):
    """Context manager and decorator: ops record no graph."""

    def __enter__(self):
        self._cm = torch.no_grad()
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


class enable_grad(contextlib.ContextDecorator):
    def __enter__(self):
        self._cm = torch.enable_grad()
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         name=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, a list; ``create_graph=True`` records them for a second
    derivative."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    retain = True if retain_graph is None else bool(retain_graph)
    grads = torch.autograd.grad(
        outputs, inputs, _cotangents(outputs, grad_outputs),
        retain_graph=retain or create_graph, create_graph=create_graph,
        allow_unused=True)
    if allow_unused:
        return list(grads)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class PyLayer:
    """A custom autograd op: a subclass defines ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)`` over tensors; ``backward`` returns one
    gradient (or None) per tensor argument."""

    _function = None

    @classmethod
    def _torch_function(cls):
        if cls.__dict__.get("_function") is None:
            layer = cls

            class _Function(torch.autograd.Function):
                @staticmethod
                def forward(fctx, pctx, kwargs, *args):
                    fctx.pctx = pctx
                    fctx.tensor_pos = [i for i, a in enumerate(args)
                                       if isinstance(a, torch.Tensor)]
                    fctx.nargs = len(args)
                    return layer.forward(pctx, *args, **kwargs)

                @staticmethod
                def backward(fctx, *grads):
                    with torch.no_grad():
                        gin = layer.backward(fctx.pctx, *grads)
                    gin = iter(_as_list(gin))
                    out = [None] * fctx.nargs
                    for i in fctx.tensor_pos:
                        out[i] = next(gin, None)
                    return (None, None, *out)

            _Function.__name__ = cls.__name__
            cls._function = _Function
        return cls._function

    @classmethod
    def apply(cls, *args, **kwargs):
        return cls._torch_function().apply(PyLayerContext(), kwargs, *args)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError
