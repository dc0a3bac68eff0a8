"""Optimizers (counterpart: paddle_tpu/optimizer/__init__.py).

`Adam` and `AdamW` compute the JAX package's update, which is not
``torch.optim.AdamW``'s: the bias corrections fold into the step size,
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, and epsilon is scaled
with them, ``denom = sqrt(v) + eps * sqrt(1 - beta2^t)``.  The beta
powers are f32 scalars kept per parameter.  AdamW's decay is decoupled,
``p - lr * weight_decay * p_old``, and applies to every parameter
(biases, LayerNorms and embeddings too), as in the JAX package, whose
``apply_decay_param_fun`` is stored and never read.  `Optimizer`
(optimizer.py) gives both the eager ``step()`` and the staged
``apply_gradients``.

The other ten (`SGD`, `Momentum`, `Adagrad`, `Adadelta`, `Adamax`,
`RMSProp`, `Lamb`, `Lars`, `Ftrl`, `Dpsgd`) compute the JAX package's
update rules in place, with its slot names and dtypes, so an optimizer
``state_dict`` crosses between the packages.  `Lamb`'s trust ratio and
`Lars`'s local rate take their norms in f32, as there.
"""
from __future__ import annotations

import torch

from ..core.framework import generator_for
from . import lr
from .optimizer import Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars", "Ftrl",
           "Dpsgd", "lr"]


def _norm_f32(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(t.float())))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_param(self, p, g, slot, lr, step):
        p.sub_((lr * g).to(p.dtype))


class Momentum(Optimizer):
    """``v = momentum * v + g``; ``p -= lr * v``, or with Nesterov
    ``p -= lr * (g + momentum * v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_slot(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update_param(self, p, g, slot, lr, step):
        v = slot["velocity"].mul_(self._momentum).add_(g)
        step_dir = g + self._momentum * v if self._use_nesterov else v
        p.sub_((lr * step_dir).to(p.dtype))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slot(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update_param(self, p, g, slot, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slot["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = slot["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
        b1p = slot["beta1_pow"].mul_(b1)
        b2p = slot["beta2_pow"].mul_(b2)
        corr2 = torch.sqrt(1 - b2p)
        lr_t = lr * corr2 / (1 - b1p)
        denom = torch.sqrt(v).add_(self._epsilon * corr2)
        p.sub_((lr_t * (m / denom)).to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self):
        return True

    def _update_param(self, p, g, slot, lr, step):
        decay = (lr * self._weight_decay * p).to(p.dtype) \
            if self._weight_decay else None
        super()._update_param(p, g, slot, lr, step)
        if decay is not None:
            p.sub_(decay)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slot(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update_param(self, p, g, slot, lr, step):
        m = slot["moment"].addcmul_(g, g)
        p.sub_((lr * g / (torch.sqrt(m) + self._epsilon)).to(p.dtype))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_slot(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update_param(self, p, g, slot, lr, step):
        rho, eps = self._rho, self._epsilon
        asg = slot["avg_squared_grad"].mul_(rho).addcmul_(g, g,
                                                          value=1 - rho)
        asu = slot["avg_squared_update"]
        update = g * torch.sqrt(asu + eps) / torch.sqrt(asg + eps)
        asu.mul_(rho).addcmul_(update, update, value=1 - rho)
        p.sub_((lr * update).to(p.dtype))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update_param(self, p, g, slot, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slot["moment"].mul_(b1).add_(g, alpha=1 - b1)
        u = torch.maximum(slot["inf_norm"].mul_(b2), torch.abs(g),
                          out=slot["inf_norm"])
        b1p = slot["beta1_pow"].mul_(b1)
        p.sub_(((lr / (1 - b1p)) * m / (u + self._epsilon)).to(p.dtype))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slot(self, p):
        return {"mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p),
                "momentum": torch.zeros_like(p)}

    def _update_param(self, p, g, slot, lr, step):
        rho = self._rho
        ms = slot["mean_square"].mul_(rho).addcmul_(g, g, value=1 - rho)
        if self._centered:
            mg = slot["mean_grad"].mul_(rho).add_(g, alpha=1 - rho)
            denom = ms - mg * mg
        else:
            denom = ms
        mom = slot["momentum"].mul_(self._momentum).add_(
            lr * g / torch.sqrt(denom + self._epsilon))
        p.sub_(mom.to(p.dtype))


class Lamb(Optimizer):
    """Adam's moments with bias correction, plus ``lamb_weight_decay *
    p``, scaled by the trust ratio ``|p| / |r|`` (1 where either norm is
    0).  ``exclude_from_weight_decay_fn`` is stored and not read, as in
    the JAX package."""

    _elementwise_update = False  # whole-parameter norms

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slot(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update_param(self, p, g, slot, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slot["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = slot["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
        b1p = slot["beta1_pow"].mul_(b1)
        b2p = slot["beta2_pow"].mul_(b2)
        r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + self._epsilon) \
            + self._lamb_wd * p
        w_norm, r_norm = _norm_f32(p), _norm_f32(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.sub_((lr * trust * r).to(p.dtype))


class Lars(Momentum):
    """Momentum over ``g + lars_weight_decay * p`` at the local rate
    ``lars_coeff * |p| / (|g| + lars_weight_decay * |p| + epsilon)`` (1
    where either norm is 0)."""

    _elementwise_update = False  # whole-parameter norms

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=1e-9,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon

    def _update_param(self, p, g, slot, lr, step):
        w_norm, g_norm = _norm_f32(p), _norm_f32(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._lars_eps),
            torch.ones_like(w_norm))
        eff_g = g + self._lars_wd * p
        v = slot["velocity"].mul_(self._momentum).add_(lr * local_lr * eff_g)
        p.sub_(v.to(p.dtype))


class Ftrl(Optimizer):
    """FTRL-proximal: squared and linear accumulators with L1/L2
    shrinkage; the new parameter is the proximal solution itself."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1 = float(l1)
        self._l2 = float(l2)
        self._lr_power = float(lr_power)

    def _init_slot(self, p):
        return {"squared": torch.zeros_like(p), "linear": torch.zeros_like(p)}

    def _update_param(self, p, g, slot, lr, step):
        sq, lin = slot["squared"], slot["linear"]
        lp = -self._lr_power
        new_sq = sq + g * g
        sigma = (new_sq ** lp - sq ** lp) / lr
        lin.add_(g - sigma * p)
        sq.copy_(new_sq)
        pre = torch.where(torch.abs(lin) > self._l1,
                          (self._l1 * torch.sign(lin) - lin)
                          / (new_sq ** lp / lr + 2 * self._l2),
                          torch.zeros_like(lin))
        p.copy_(pre.to(p.dtype))


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to an L2 norm of
    ``clip``, plus Gaussian noise of deviation ``clip * sigma /
    batch_size``, then a plain SGD step.

    The noise comes from the parameter device's generator
    (`core.framework.generator_for`, seeded by ``paddle.seed``), one
    draw a parameter in parameter order.  The JAX package draws it from
    ``jax.random`` keys folded from ``(seed, step, parameter)``: the two
    agree in distribution only, never draw for draw.  With ``sigma=0``
    no noise is added and the update is the JAX package's exactly."""

    _elementwise_update = False  # whole-parameter norms

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, seed=0, name=None, **kw):
        super().__init__(learning_rate, parameters)
        self._dp_clip = float(clip)
        self._batch = float(batch_size)
        self._sigma = float(sigma)
        self._seed = int(seed)

    def _update_param(self, p, g, slot, lr, step):
        norm = _norm_f32(g)
        scale = torch.clamp(self._dp_clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        gg = g * scale
        if self._sigma:
            noise = torch.randn(g.shape, dtype=torch.float32,
                                device=g.device,
                                generator=generator_for(g.device))
            gg = gg + (noise * (self._dp_clip * self._sigma / self._batch)
                       ).to(g.dtype)
        p.sub_((lr * gg).to(p.dtype))
