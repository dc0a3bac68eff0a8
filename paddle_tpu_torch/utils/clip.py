"""Gradient clipping (counterpart: paddle_tpu/utils/clip.py).

Each clip has two forms over the same arithmetic: ``__call__`` on
``[(param, grad)]`` pairs, for the eager `Optimizer.step`, and
``clip_arrays`` on a list of gradients, for the staged
`Optimizer.apply_gradients` of `jit.TrainStep`.  Norms are taken in f32
and the scaled gradient cast back to its dtype.  None gradients pass
through.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm"]


class ClipGradBase:
    def clip_arrays(self, grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        clipped = self.clip_arrays([g for _, g in params_grads])
        return [(p, c) for (p, _), c in zip(params_grads, clipped)]


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_arrays(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_arrays(self, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append(_scaled(g, scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``min(clip_norm / global_norm, 1)``, the
    global norm the L2 norm of all of them together (summed in list
    order)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_arrays(self, grads):
        live = [g for g in grads if g is not None]
        if not live:
            return list(grads)
        sq = sum(torch.sum(torch.square(g.float())) for g in live)
        global_norm = torch.sqrt(sq)
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
        return [None if g is None else _scaled(g, scale) for g in grads]


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
