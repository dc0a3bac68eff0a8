"""Fleet meta-optimizers (counterpart: paddle_tpu/distributed/fleet/
meta_optimizers/__init__.py).

Eager wrappers around an optimizer, as in the JAX package: each
transforms the gradients or the parameters around the inner ``step()``,
in place on the torch parameters.  Their collectives (`LocalSGD`'s
parameter average, `FP16AllReduce`'s gradient all-reduce) go through
`distributed.collective`, and are the identity at world size 1.
`StrategyCompiler` stacks them from a `DistributedStrategy` as the JAX
package does.  `DygraphShardingOptimizer` is ZeRO stage 1 for the
dygraph loop (`fleet.zero`).
"""
from __future__ import annotations

import math
from typing import List

import torch

__all__ = [
    "MetaOptimizerBase", "GradientMergeOptimizer", "LocalSGDOptimizer",
    "DGCOptimizer", "FP16AllReduceOptimizer", "LookaheadOptimizer",
    "ModelAverage", "ExponentialMovingAverage", "StrategyCompiler",
    "DygraphShardingOptimizer",
]


class MetaOptimizerBase:
    """Wraps a user optimizer; delegates everything not overridden."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    @property
    def inner(self):
        return self._inner

    def step(self):
        self._inner.step()

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, [(p, p.grad) for p in self._params()]

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, sd):
        return self._inner.set_state_dict(sd)

    def _params(self):
        return self._inner._parameters or []


class GradientMergeOptimizer(MetaOptimizerBase):
    """Accumulate the gradients of ``k_steps`` steps and apply them once
    (averaged with ``avg``); between, ``step()`` only frees them."""

    def __init__(self, inner, k_steps=2, avg=True):
        super().__init__(inner)
        self.k_steps = max(1, int(k_steps))
        self.avg = avg
        self._acc = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        params = self._params()
        for p in params:
            if p.grad is None:
                continue
            a = self._acc.get(id(p))
            if a is None:
                self._acc[id(p)] = p.grad.detach().clone()
            else:
                a.add_(p.grad)
        self._count += 1
        if self._count < self.k_steps:
            for p in params:
                p.grad = None
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in params:
            a = self._acc.get(id(p))
            if a is not None:
                p.grad = a * scale
        self._inner.step()
        self._acc.clear()
        self._count = 0


class LocalSGDOptimizer(MetaOptimizerBase):
    """Step locally; every ``k_steps`` steps average the parameters over
    the group.  ``adaptive`` grows the interval as the loss shrinks,
    ``k = clip(ceil(init_k_steps * sqrt(loss_0 / loss_t)), 1, k_steps)``
    (pass the loss to ``step(loss=...)``)."""

    def __init__(self, inner, k_steps=4, group=None, adaptive=False,
                 init_k_steps=1):
        super().__init__(inner)
        self.k_steps = max(1, int(k_steps))
        self._group = group
        self._adaptive = bool(adaptive)
        self._init_k_steps = max(1, int(init_k_steps))
        self._loss0 = None
        self._cur_k = self._init_k_steps if adaptive else self.k_steps
        self._tick = 0

    def step(self, loss=None):
        self._inner.step()
        self._tick += 1
        if self._adaptive and loss is not None:
            val = float(loss)
            if self._loss0 is None:
                self._loss0 = max(val, 1e-12)
            self._cur_k = int(min(self.k_steps, max(
                1, math.ceil(self._init_k_steps *
                             math.sqrt(self._loss0 / max(val, 1e-12))))))
        if self._tick % self._cur_k:
            return
        from ...collective import all_reduce
        from ...parallel import get_world_size

        n = get_world_size(self._group)
        if n <= 1:
            return
        with torch.no_grad():
            for p in self._params():
                all_reduce(p, group=self._group)
                p.div_(n)


class DGCOptimizer(MetaOptimizerBase):
    """Deep gradient compression: keep only the top ``1 - sparsity``
    share of each momentum-corrected gradient by magnitude; the rest stays
    as a local residual added back at the next step."""

    def __init__(self, inner, rampup_begin_step=0, sparsity=0.999,
                 momentum=0.9):
        super().__init__(inner)
        self.rampup_begin_step = int(rampup_begin_step)
        self.sparsity = float(sparsity)
        self.momentum = float(momentum)
        self._u = {}
        self._tick = 0

    @staticmethod
    def _topk_mask(g, keep_ratio):
        k = max(1, int(round(g.numel() * keep_ratio)))
        flat = torch.abs(g.reshape(-1))
        thresh = torch.topk(flat, k).values[-1]
        return (torch.abs(g) >= thresh).to(g.dtype)

    def step(self):
        self._tick += 1
        if self._tick <= self.rampup_begin_step:
            return self._inner.step()
        keep = 1.0 - self.sparsity
        with torch.no_grad():
            for p in self._params():
                if p.grad is None:
                    continue
                g = p.grad
                u = self._u.get(id(p))
                u = g.clone() if u is None else self.momentum * u + g
                sparse = u * self._topk_mask(u, keep)
                self._u[id(p)] = u - sparse
                p.grad = sparse
        self._inner.step()


class FP16AllReduceOptimizer(MetaOptimizerBase):
    """All-reduce the gradients in bf16 (or fp16) and average them in
    f32: this wrapper reduces by itself, so use it on unreduced local
    gradients (without `DataParallel`)."""

    def __init__(self, inner, dtype="bfloat16", group=None):
        super().__init__(inner)
        self._dtype = torch.bfloat16 if dtype == "bfloat16" else \
            torch.float16
        self._group = group

    def step(self):
        from ...collective import all_reduce
        from ...parallel import get_world_size

        n = get_world_size(self._group)
        with torch.no_grad():
            for p in self._params():
                if p.grad is None:
                    continue
                g16 = p.grad.to(self._dtype)
                if n > 1:
                    all_reduce(g16, group=self._group)
                p.grad = g16.to(torch.float32) / max(n, 1)
        self._inner.step()


class LookaheadOptimizer(MetaOptimizerBase):
    """Fast weights step every iteration; every ``k`` steps the slow
    weights move ``alpha`` of the way to them and the fast weights reset
    to the slow."""

    def __init__(self, inner, alpha=0.5, k=5):
        super().__init__(inner)
        self.alpha = float(alpha)
        self.k = max(1, int(k))
        self._slow = {}
        self._tick = 0

    @torch.no_grad()
    def step(self):
        for p in self._params():
            if id(p) not in self._slow:
                self._slow[id(p)] = p.detach().clone()
        self._inner.step()
        self._tick += 1
        if self._tick % self.k == 0:
            for p in self._params():
                slow = self._slow[id(p)]
                slow.add_(self.alpha * (p - slow))
                p.copy_(slow)


class _SwapGuard:
    def __init__(self, owner):
        self._owner = owner

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._owner.restore()
        return False


class ModelAverage(MetaOptimizerBase):
    """A windowed running average of the parameters; ``apply()`` swaps it
    in (a context that restores), ``restore()`` swaps back.  The live
    window rolls into an "old" one past its length, so the average covers
    at most about the last ``2 * max_average_window`` steps."""

    def __init__(self, inner, average_window_rate=0.15, min_average_window=2,
                 max_average_window=10000):
        super().__init__(inner)
        self.average_window_rate = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._sum = {}
        self._old_sum = {}
        self._num = 0
        self._old_num = 0
        self._updates = 0
        self._backup = None

    def step(self):
        self._inner.step()
        with torch.no_grad():
            self._updates += 1
            window = max(self.min_average_window,
                         min(self.max_average_window,
                             int(self._updates * self.average_window_rate)))
            if self._num >= window:
                self._old_sum, self._old_num = self._sum, self._num
                self._sum, self._num = {}, 0
            for p in self._params():
                s = self._sum.get(id(p))
                if s is None:
                    self._sum[id(p)] = p.detach().clone()
                else:
                    s.add_(p)
            self._num += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {}
        total = self._num + self._old_num
        for p in self._params():
            if total == 0:
                continue
            acc = self._sum.get(id(p), 0)
            if id(p) in self._old_sum:
                acc = acc + self._old_sum[id(p)]
            self._backup[id(p)] = p.detach().clone()
            p.copy_(acc / total)
        return _SwapGuard(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup:
            for p in self._params():
                if id(p) in self._backup:
                    p.copy_(self._backup[id(p)])
            self._backup = None


class ExponentialMovingAverage:
    """An exponential moving average of the parameters: ``update()`` after
    each step (decay ``min(decay, (1 + t) / (10 + t))``); ``apply()`` and
    ``restore()`` swap the shadow weights in and out."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None):
        self._decay = float(decay)
        self._parameters = list(parameters) if parameters else None
        self._shadow = {}
        self._backup = None
        self._step = 0

    def _params(self):
        if self._parameters is None:
            raise RuntimeError("ExponentialMovingAverage needs parameters=")
        return self._parameters

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = min(self._decay, (1.0 + self._step) / (10.0 + self._step))
        for p in self._params():
            s = self._shadow.get(id(p), p.detach())
            self._shadow[id(p)] = d * s + (1.0 - d) * p

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {}
        for p in self._params():
            if id(p) in self._shadow:
                self._backup[id(p)] = p.detach().clone()
                p.copy_(self._shadow[id(p)])
        return _SwapGuard(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup:
            for p in self._params():
                if id(p) in self._backup:
                    p.copy_(self._backup[id(p)])
            self._backup = None


class StrategyCompiler:
    """The meta-optimizers a `DistributedStrategy` switches on, stacked
    in the JAX package's order (``gradient_merge`` outermost, then
    ``dgc``, ``localsgd``, ``fp16_allreduce``, ``lookahead``; of dgc,
    localsgd and fp16_allreduce only the first), after ``lamb``/``lars``
    swap the base optimizer.  Returns ``(optimizer, applied names)``."""

    _EXCLUSIVE = [("dgc", "localsgd", "fp16_allreduce")]
    _ORDER = ["gradient_merge", "dgc", "localsgd", "fp16_allreduce",
              "lookahead"]

    def generate_optimizer(self, optimizer, strategy):
        from ....optimizer import Lamb, Lars

        applied: List[str] = []
        flags = {k: bool(getattr(strategy, k, False)) for k in self._ORDER}
        for group in self._EXCLUSIVE:
            on = [k for k in group if flags.get(k)]
            for k in on[1:]:
                flags[k] = False
        if getattr(strategy, "lamb", False) and \
                not isinstance(optimizer, Lamb):
            kw = {}
            if optimizer._weight_decay:
                kw["lamb_weight_decay"] = optimizer._weight_decay
            optimizer = Lamb(learning_rate=optimizer._learning_rate,
                             parameters=optimizer._parameters,
                             grad_clip=optimizer._grad_clip, **kw)
            applied.append("lamb")
        elif getattr(strategy, "lars", False) and \
                not isinstance(optimizer, Lars):
            kw = {}
            if optimizer._weight_decay:
                kw["lars_weight_decay"] = optimizer._weight_decay
            optimizer = Lars(learning_rate=optimizer._learning_rate,
                             parameters=optimizer._parameters,
                             grad_clip=optimizer._grad_clip, **kw)
            applied.append("lars")

        def _cfg(name, keys):
            cfg = getattr(strategy, name, None) or {}
            return {k: cfg[k] for k in keys if k in cfg}

        def _dgc(o):
            cfg = getattr(strategy, "dgc_configs", None) or {}
            kw = {}
            if "rampup_begin_step" in cfg:
                kw["rampup_begin_step"] = cfg["rampup_begin_step"]
            sp = cfg.get("sparsity")
            if sp is not None:  # a ramp-up list: its last value
                kw["sparsity"] = sp[-1] if isinstance(sp, (list, tuple)) \
                    else sp
            return DGCOptimizer(o, **kw)

        wrappers = {
            "gradient_merge": lambda o: GradientMergeOptimizer(
                o, **_cfg("gradient_merge_configs", ("k_steps", "avg"))),
            "dgc": _dgc,
            "localsgd": lambda o: LocalSGDOptimizer(
                o, **_cfg("localsgd_configs",
                          ("k_steps", "adaptive", "init_k_steps"))),
            "fp16_allreduce": lambda o: FP16AllReduceOptimizer(o),
            "lookahead": lambda o: LookaheadOptimizer(
                o, **_cfg("lookahead_configs", ("alpha", "k"))),
        }
        for name in reversed(self._ORDER):
            if flags.get(name):
                optimizer = wrappers[name](optimizer)
                applied.insert(0, name)
        return optimizer, applied


class DygraphShardingOptimizer(MetaOptimizerBase):
    """ZeRO-1 for the dygraph loop (``loss.backward(); opt.step()``): the
    optimizer state of the inner optimizer's parameters is sharded over
    the hybrid group's sharding group (`fleet.zero.FlatShard`).  ``step``
    averages the gradients over that group (those a `DataParallel`
    already reduced are left alone), updates this rank's range of the
    flattened parameters with the inner optimizer's update and
    all-gathers the ranges back; the strategy's
    ``sharding_configs["offload"]`` keeps the slots in pinned host
    memory.  The reference's signature ``(hcg, user_defined_strategy,
    params, inner_optimizer_class, **inner_kw)``, or ``optimizer=`` a
    built one."""

    def __init__(self, hcg=None, user_defined_strategy=None, params=None,
                 inner_optimizer_class=None, optimizer=None, **inner_kw):
        if optimizer is None:
            if inner_optimizer_class is None:
                raise TypeError(
                    "DygraphShardingOptimizer needs inner_optimizer_class "
                    "(reference signature) or optimizer=")
            optimizer = inner_optimizer_class(parameters=params, **inner_kw)
        super().__init__(optimizer)
        from ...topology import get_hybrid_communicate_group

        self._hcg = hcg if hcg is not None else \
            get_hybrid_communicate_group()
        st = user_defined_strategy
        self._offload = bool(st is not None and st.sharding_configs.get(
            "offload", False))
        self._shard = None
        self._count = 0

    def _group(self):
        from ...collective import Group

        if self._hcg is not None:
            return self._hcg.get_sharding_parallel_group()
        return Group("sharding", None)

    @torch.no_grad()
    def step(self):
        from ..utils.hybrid_parallel_util import _average
        from ..zero import FlatShard, clip_views

        inner = self._inner
        params = [p for p in self._params() if p.requires_grad]
        group = self._group()
        if self._shard is None:
            self._shard = FlatShard([(f"param{i}", p) for i, p in
                                     enumerate(params)], group,
                                    inner._elementwise_update)
        sh = self._shard
        _average(params, [group])
        flat_g = sh.flatten([p.grad if p.grad is not None
                             else torch.zeros_like(p) for p in params])
        own = sh.own(sh.flatten([p.detach() for p in params])).clone()
        if sh.slots is None:
            sh.init_slots(inner, own, self._offload)
        self._count += 1
        inner._step_count = self._count
        (views,) = clip_views(inner._grad_clip, [sh], [sh.views(own,
                                                          sh.own(flat_g))],
                              group)
        sh.apply(inner, own, views, inner.get_lr(), self._count)
        for p, t in zip(params, sh.unflatten(sh.gather(own))):
            p.copy_(t)

    def slot_bytes(self) -> int:
        """Bytes of this rank's optimizer slots."""
        return self._shard.slot_bytes() if self._shard is not None else 0
