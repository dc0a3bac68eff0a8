"""jit: `to_static`, the deployment format, and the training step
(counterpart: paddle_tpu/jit/__init__.py).

Reference: the dygraph->static stack — `ProgramTranslator`/
`StaticFunction` (`fluid/dygraph/dygraph_to_static/
program_translator.py:759,232`) and `paddle.jit.save/load`
(`fluid/dygraph/jit.py`).

* `to_static` / `StaticFunction`: the JAX package traces the function
  once a signature and compiles it; PyTorch runs it eagerly, so a
  `StaticFunction` keeps the JAX package's signature cache (one
  `ConcreteProgram` a signature, ``concrete_programs``) and calls the
  function.  Data-dependent Python control flow runs as it stands (the
  JAX package's dy2static AST pass has nothing to lower here; its port
  comes with slice 4b).
* `save(layer, path, input_spec)`: the function ``infer(params, buffers,
  *inputs)`` exported with `torch.func.functional_call` and
  `torch.export` (``None`` and negative dims become 1, as in the JAX
  package); ``path.pdmodel`` holds `torch.export.save`'s archive and
  ``path.pdiparams`` the JAX package's pickle of numpy arrays
  (``params``/``buffers``/``pnames``/``bnames``), so the weights stay out
  of the program.  The trace runs in `static.export_marker`'s archive
  mode: attention and (under the flag) LayerNorm bind the kernels'
  custom ops, which run K3/K5 on the card.
* `load(path)`: a `TranslatedLayer` over the archive, the op
  registrations imported first.  A JAX StableHLO ``.pdmodel`` raises
  ValueError naming the format; it is never parsed as something else.
* `TrainStep`: forward, backward and the optimizer's in-place update.
"""
from __future__ import annotations

import functools
import io
import os
import pickle
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from ..optimizer.optimizer import collect_lr_mults
from ..static.input_spec import InputSpec  # noqa: F401  (JAX's name here)

__all__ = ["TrainStep", "train_step", "StaticFunction", "ConcreteProgram",
           "to_static", "declarative", "not_to_static", "save", "load",
           "TranslatedLayer", "TracedLayer", "sniff_pdmodel"]


# ---------------------------------------------------------------------------
# to_static
# ---------------------------------------------------------------------------
class ConcreteProgram:
    """One signature's entry of a `StaticFunction`: the input specs it was
    first called with (the JAX package keeps the jitted executable)."""

    def __init__(self, inputs):
        from ..static.input_spec import InputSpec

        self.inputs = [InputSpec.from_tensor(t) for t in inputs]

    def __repr__(self):
        return f"ConcreteProgram(inputs={self.inputs})"


class StaticFunction:
    """Signature cache over a function (reference `ProgramCache`,
    `program_translator.py:692`): the key is the tensor arguments'
    shapes and dtypes, the other arguments, the keywords and the
    layer's training flag, as in the JAX package."""

    def __init__(self, function: Callable, layer=None, input_spec=None):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._compiled: Dict = {}
        functools.update_wrapper(self, function)

    @property
    def concrete_programs(self):
        return list(self._compiled.values())

    def __call__(self, *args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        sig = (
            tuple((tuple(t.shape), str(t.dtype)) for t in tensors),
            tuple(None if isinstance(a, torch.Tensor) else a for a in args),
            tuple(kwargs.items()) if kwargs else (),
            bool(self._layer.training) if self._layer is not None else None,
        )
        if sig not in self._compiled:
            self._compiled[sig] = ConcreteProgram(tensors)
        return self._function(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper (reference `paddle.jit.to_static`)."""

    def wrap(fn):
        if isinstance(fn, nn.Module):
            sf = StaticFunction(fn.forward, layer=fn, input_spec=input_spec)
            fn.forward = sf
            return fn
        layer = kwargs.get("layer")
        if layer is None and isinstance(getattr(fn, "__self__", None),
                                        nn.Module):
            layer = fn.__self__
        return StaticFunction(fn, layer=layer, input_spec=input_spec)

    if function is not None:
        return wrap(function)
    return wrap


declarative = to_static


def not_to_static(fn):
    fn._paddle_not_to_static = True
    return fn


class TracedLayer:
    """reference `fluid/dygraph/jit.py:49` TracedLayer (trace+run)."""

    def __init__(self, static_fn, layer):
        self._fn = static_fn
        self._layer = layer

    @staticmethod
    def trace(layer, inputs):
        sf = StaticFunction(layer.forward, layer=layer)
        out = sf(*inputs)
        return out, TracedLayer(sf, layer)

    def __call__(self, *inputs):
        return self._fn(*inputs)


# ---------------------------------------------------------------------------
# save / load — the deployment format
# ---------------------------------------------------------------------------
_ZIP_MAGIC = b"PK\x03\x04"


def sniff_pdmodel(raw: bytes) -> str:
    """What a ``.pdmodel`` holds: ``"archive"`` (`torch.export.save`'s zip,
    checked first: a zip must never parse as an empty ProgramDesc),
    ``"program"`` (a framework.proto ProgramDesc with blocks) or
    ``"unknown"`` (the JAX package's StableHLO export, or anything
    else)."""
    if raw[:4] == _ZIP_MAGIC:
        return "archive"
    from ..static import proto

    try:
        if proto.parse_program(raw).get("blocks"):
            return "program"
    except Exception:
        pass
    return "unknown"


def _register_export_ops():
    """Import every module that registers a custom op an exported graph
    may hold (before `torch.export.load`)."""
    from ..ops import flash_attention, layer_norm  # noqa: F401
    from ..static import export_marker  # noqa: F401


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: widened,
        t = t.float()              # narrowed back at load by the graph
    return t.numpy()


class _Infer(nn.Module):
    """``infer(params, buffers, *inputs)`` over ``layer``'s forward."""

    def __init__(self, layer, pnames, bnames):
        super().__init__()
        # not a submodule: the weights are inputs, never the program's own
        object.__setattr__(self, "layer", layer)
        self.pnames, self.bnames = pnames, bnames

    def forward(self, parrs: List[torch.Tensor], barrs: List[torch.Tensor],
                *inputs):
        state = dict(zip(self.pnames, parrs))
        state.update(zip(self.bnames, barrs))
        out = torch.func.functional_call(self.layer, state, inputs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _examples(input_spec, device):
    from ..static.input_spec import InputSpec

    if input_spec is None:
        raise ValueError("paddle_tpu_torch.jit.save requires input_spec")
    out = []
    for s in input_spec:
        if isinstance(s, InputSpec):
            shape = [1 if d is None or d < 0 else int(d) for d in s.shape]
            out.append(torch.zeros(shape, dtype=s.dtype, device=device))
        elif isinstance(s, torch.Tensor):
            out.append(torch.zeros_like(s, device=device))
        else:
            raise TypeError(f"input_spec entries are InputSpec or tensors, "
                            f"got {type(s).__name__}")
    return out


def save(layer, path, input_spec=None, **config):
    """Export ``layer`` for inference (``path.pdmodel`` + ``.pdiparams``);
    see the module docstring."""
    from ..static.export_marker import export_trace_context

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    params, buffers = dict(layer.named_parameters()), \
        dict(layer.named_buffers())
    pnames, bnames = sorted(params), sorted(buffers)
    device = next((t.device for t in list(params.values())
                   + list(buffers.values())), torch.device("cpu"))
    examples = _examples(input_spec, device)
    parrs = [params[k].detach() for k in pnames]
    barrs = [buffers[k].detach() for k in bnames]
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad(), export_trace_context("archive"):
            ep = torch.export.export(_Infer(layer, pnames, bnames),
                                     (parrs, barrs, *examples),
                                     strict=False)
    finally:
        if was_training:
            layer.train()
    blob = io.BytesIO()
    torch.export.save(ep, blob)
    with open(path + ".pdmodel", "wb") as f:
        f.write(blob.getvalue())
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"params": {k: _np(params[k]) for k in pnames},
                     "buffers": {k: _np(buffers[k]) for k in bnames},
                     "pnames": pnames, "bnames": bnames}, f)


class TranslatedLayer(nn.Module):
    """Deserialized deployable module (reference TranslatedLayer,
    `fluid/dygraph/io.py`): the exported graph over its own copy of the
    weights (parameters under the JAX package's names, ``.`` as
    ``__``)."""

    def __init__(self, exported, params, buffers, pnames, bnames,
                 device=None):
        super().__init__()
        from ..core.place import to_device
        from ..device import resolve_device

        dev = resolve_device(None if device is None else to_device(device))
        user = set(exported.graph_signature.user_inputs)
        specs = [n.meta.get("val") for n in exported.graph.nodes
                 if n.op == "placeholder" and n.name in user]
        dtypes = [getattr(s, "dtype", None) for s in specs]
        self._n_user = len(specs)

        def tensor(a, i):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtypes[i] or t.dtype)

        src_dev = next((s.device for s in specs
                        if isinstance(s, torch.Tensor)), dev)
        if src_dev.type != dev.type:
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, dev)
        self._exported = exported
        self._module = exported.module()
        self._pnames, self._bnames = list(pnames), list(bnames)
        for i, k in enumerate(self._pnames):
            self.register_parameter(k.replace(".", "__"), nn.Parameter(
                tensor(params[k], i), requires_grad=False))
        off = len(self._pnames)
        for i, k in enumerate(self._bnames):
            self.register_buffer(k.replace(".", "__"),
                                 tensor(buffers[k], off + i))
        self.device = dev

    def n_inputs(self) -> int:
        """The model's own inputs (after the weights)."""
        return self._n_user - len(self._pnames) - len(self._bnames)

    def forward(self, *inputs):
        parrs = [getattr(self, k.replace(".", "__")) for k in self._pnames]
        barrs = [getattr(self, k.replace(".", "__")) for k in self._bnames]
        ins = [i if isinstance(i, torch.Tensor) else
               torch.from_numpy(np.ascontiguousarray(np.asarray(i)))
               for i in inputs]
        outs = self._module(parrs, barrs, *[i.to(self.device) for i in ins])
        outs = tuple(outs)
        return outs[0] if len(outs) == 1 else outs


def load(path, **config):
    """A `TranslatedLayer` over ``path.pdmodel``/``.pdiparams`` (``device``
    in ``config``; default: the card)."""
    with open(path + ".pdmodel", "rb") as f:
        raw = f.read()
    kind = sniff_pdmodel(raw)
    if kind == "program":
        raise ValueError(
            f"{path}.pdmodel is a reference ProgramDesc, not a jit.save "
            "archive: load it with static.load_inference_model or the "
            "inference Predictor")
    if kind != "archive":
        raise ValueError(
            f"{path}.pdmodel is not a torch.export archive (a zip); a "
            "paddle_tpu jit.save artifact is serialized StableHLO, which "
            "runs only under JAX — export the model with "
            "paddle_tpu_torch.jit.save or as a ProgramDesc "
            "(static.save_inference_model)")
    _register_export_ops()
    exported = torch.export.load(io.BytesIO(raw))
    with open(path + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    return TranslatedLayer(exported, meta["params"], meta["buffers"],
                           meta["pnames"], meta["bnames"],
                           device=config.get("device"))


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------
class TrainStep:
    """``step(*batch)`` runs ``loss_fn(model, *batch)``, its backward and
    one optimizer update of every trainable parameter, and returns the
    loss as a detached f32 scalar.  The JAX package compiles the three
    stages into one jitted executable that donates the parameters and
    optimizer state; here they run in turn on the model's own
    parameters: the optimizer's in-place `apply_gradients` (its clip,
    its decay and the parameters' ``ParamAttr.learning_rate``
    multipliers; not a parameter's own regularizer, as in the JAX
    package).  Its optimizer slots and step count are its own, not the
    optimizer's eager ones.  The step counter starts at 1; the gradients
    are freed after the update."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._lr_mults = collect_lr_mults(self._params)
        self._opt_state = None
        self._step = 0

    def __call__(self, *batch) -> torch.Tensor:
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_state(self._params)
        self._step += 1
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch).float()
        loss.backward()
        grads = {k: p.grad for k, p in self._params.items()}
        self.optimizer.apply_gradients(self._params, grads, self._opt_state,
                                       self.optimizer.get_lr(), self._step,
                                       lr_mults=self._lr_mults)
        for p in self._params.values():
            p.grad = None
        return loss.detach()


def train_step(model, loss_fn, optimizer):
    return TrainStep(model, loss_fn, optimizer)
