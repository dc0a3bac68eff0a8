"""Optimizer base (counterpart: paddle_tpu/optimizer/optimizer.py).

Each optimizer defines ``_update_param(p, g, slot, lr, step)``, which
updates one parameter and its slot state IN PLACE under
``torch.no_grad()``: where the JAX package returns new arrays, the port
overwrites them.  Two forms use it, as in the JAX package:

* the eager ``step()`` over the optimizer's ``parameters`` and their
  ``.grad`` (the dygraph loop ``loss.backward(); opt.step();
  opt.clear_grad()``), with its slots kept by the optimizer (and in its
  ``state_dict``);
* the staged `apply_gradients` over a dict of parameters, which
  `jit.TrainStep` calls with slots of its own.

Both clip first (``grad_clip``, in parameter order), then fold the decay
into the gradient, then scale the learning rate by the parameter's
``ParamAttr.learning_rate``.  Only the eager step reads a parameter's
own ``ParamAttr.regularizer``, which replaces the optimizer's decay for
it; `apply_gradients` sees the optimizer's decay alone — the JAX
package's asymmetry, kept.  ``weight_decay`` is a float or a regularizer,
of which only the coefficient is read (an ``L1Decay`` given here decays
as L2, as in the JAX package).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.tensor import from_numpy
from .lr import LRScheduler

__all__ = ["Optimizer", "collect_lr_mults"]


def _lr_mult(p) -> float:
    return float((getattr(p, "optimize_attr", None) or {})
                 .get("learning_rate", 1.0))


def collect_lr_mults(params: Dict[str, torch.Tensor]) -> Optional[dict]:
    """``ParamAttr.learning_rate`` multipliers of a named parameter dict;
    None when every one is 1."""
    mults = {k: _lr_mult(p) for k, p in params.items()}
    return None if all(m == 1.0 for m in mults.values()) else mults


class Optimizer:
    # an update that reads each element of a parameter alone (a ZeRO
    # slice or a pipeline stage may cut a parameter); Lamb, Lars and
    # Dpsgd read whole-parameter norms and set it False
    _elementwise_update = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None \
            else None
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        # the eager step's slots, by id(parameter)
        self._state: Dict[int, dict] = {}
        self._step_count = 0

    # -- learning rate ------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

    # -- functional core (override) ----------------------------------------
    def _init_slot(self, p: torch.Tensor) -> dict:
        return {}

    def _update_param(self, p, g, slot, lr, step):
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _apply_decay(self, p, g, param_obj=None):
        """The decay folded into the gradient: ``param_obj``'s own
        regularizer if it has one, else L2 at ``weight_decay`` (not for
        decoupled decay)."""
        reg = getattr(param_obj, "regularizer", None)
        if reg is not None:
            return g + reg(p)
        if self._weight_decay and not self._decoupled_weight_decay():
            return g + self._weight_decay * p
        return g

    # -- eager form ---------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter with a gradient."""
        if self._parameters is None:
            raise ValueError("optimizer constructed without parameters")
        lr = self.get_lr()
        self._step_count += 1
        pgs = [(p, p.grad) for p in self._parameters
               if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        for p, g in pgs:
            if g is None:
                continue
            slot = self._state.get(id(p))
            if slot is None:
                slot = self._state[id(p)] = self._init_slot(p)
            g = self._apply_decay(p, g.to(p.dtype), p)
            mult = _lr_mult(p)
            self._update_param(p, g, slot, lr * mult if mult != 1.0 else lr,
                               self._step_count)

    def clear_grad(self, set_to_zero=False):
        """Free every parameter's gradient (zero it in place with
        ``set_to_zero``)."""
        for p in self._parameters or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward(); step(); clear_grad()``; returns ``(None,
        [(param, grad)])`` with the gradients cleared."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, [(p, p.grad) for p in self._parameters or []]

    # -- staged form --------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> dict:
        return {k: self._init_slot(p) for k, p in params.items()}

    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]],
                        state: dict, lr, step=1,
                        lr_mults: Optional[dict] = None):
        """Update every parameter with a gradient, and its slot state, in
        place; a parameter whose gradient is None is left as it is.
        ``lr`` is the learning rate of this step, ``step`` counts from 1,
        ``lr_mults`` the per-parameter multipliers (`collect_lr_mults`).
        Returns ``(params, state)``."""
        if self._grad_clip is not None:
            keys = [k for k in params if grads.get(k) is not None]
            clipped = self._grad_clip.clip_arrays([grads[k] for k in keys])
            grads = {**grads, **dict(zip(keys, clipped))}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            if k not in state:
                state[k] = self._init_slot(p)
            g = self._apply_decay(p, g.to(p.dtype))
            mult = lr_mults.get(k, 1.0) if lr_mults else 1.0
            self._update_param(p, g, state[k],
                               lr * mult if mult != 1.0 else lr, step)
        return params, state

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """``step``, the scheduler's state as ``LR_Scheduler`` and each
        eager slot as ``param{i}.{slot}`` (i: the parameter's index)."""
        out = {"step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for i, p in enumerate(self._parameters or []):
            for sk, sv in (self._state.get(id(p)) or {}).items():
                out[f"param{i}.{sk}"] = sv
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        self._step_count = int(state.get("step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameters or []):
            prefix = f"param{i}."
            slot = {}
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(prefix):
                    v = v.detach() if isinstance(v, torch.Tensor) else \
                        from_numpy(v)
                    slot[k[len(prefix):]] = v.to(p.device).clone()
            if slot:
                self._state[id(p)] = slot
