"""LayerNorm (counterpart: paddle_tpu/ops/pallas/layer_norm.py, its
`_fwd_xla` form and the custom VJP of `fused_layer_norm`).

Statistics in f32 with the population variance (``jnp.var`` divides by
n), the affine step in f32, the result cast back to the input dtype.
The gradient saves x and w only and recomputes the statistics.  The
Pallas LN kernel (K5) is opt-in there (``FLAGS_use_pallas_layernorm``,
off by default) and not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "fused_layer_norm"]


def layer_norm(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """x2d: [rows, d]; w/b: [d].  Returns the normalized [rows, d]."""
    x32 = x2d.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x2d.dtype)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        return layer_norm(x2d, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        x32, g32 = x2d.float(), g.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (x32 - mean) * rstd
        dw = (g32 * xhat).sum(dim=0).to(w.dtype)
        db = g32.sum(dim=0).to(w.dtype)
        gy = g32 * w.float()
        dx = (gy - gy.mean(dim=-1, keepdim=True)
              - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
        return (dx * rstd).to(x2d.dtype), dw, db, None


def fused_layer_norm(x2d, w, b, eps=1e-5):
    """Differentiable `layer_norm`.  x2d: [rows, d]; w/b: [d]."""
    return _FusedLayerNorm.apply(x2d, w, b, eps)
