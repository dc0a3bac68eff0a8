"""LayerNorm (counterpart: paddle_tpu/ops/pallas/layer_norm.py, its
`_fwd_xla` form, its Pallas kernel and the custom VJP of
`fused_layer_norm`).

Statistics in f32 with the population variance (``jnp.var`` divides by
n), the affine step in f32, the result cast back to the input dtype.
The gradient saves x and w only and recomputes the statistics.

With ``FLAGS_use_pallas_layernorm`` on (off by default, as in JAX), the
forward of a CUDA tensor runs kernel K5 (`csrc/layer_norm.cu`) through
`layer_norm_cuda`, which raises on any input it does not take; every
other call runs `layer_norm`, the `_fwd_xla` form, which is also K5's
plain version.  The backward is composed either way, as in JAX.  JAX's
``d % 128 == 0`` condition is a TPU lane rule and is not carried over.

Export (`static.export_marker`): under `jit.save`'s trace with the flag
on, the forward binds ``paddle_tpu_torch::layer_norm``
(`layer_norm_op`: K5 on CUDA tensors, `layer_norm` on the CPU); without
the flag, and under `fx_export`'s trace, it is `layer_norm`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import flags as _flags
from . import _build

__all__ = ["layer_norm", "layer_norm_cuda", "fused_layer_norm",
           "layer_norm_op"]


def layer_norm(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """x2d: [rows, d]; w/b: [d].  Returns the normalized [rows, d]."""
    x32 = x2d.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x2d.dtype)


class _LayerNormCuda:
    """ctypes wrapper of kernel K5.  ``launches`` counts the kernel
    launches this process made; it grows by one per launch and nowhere
    else.  A call made while a CUDA graph captures adds one to
    ``captured`` instead; the graph adds its captured launches to
    ``launches`` at each replay (`ops.capture`)."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}
    # 16-byte vectors a row may hold: 512 threads x 8 (csrc/layer_norm.cu)
    _MAX_VECS = 512 * 8

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = _build.load("layer_norm").layer_norm_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x2d, w, b, eps):
        """x2d: [rows, d] f32 or bf16; w, b: [d] f32 or bf16 (one dtype).
        Raises on any input the kernel does not take."""
        if x2d.dim() != 2:
            raise ValueError(f"kernel takes x as [rows, d], got rank "
                             f"{x2d.dim()}")
        rows, d = x2d.shape
        if x2d.dtype not in self._DTYPES:
            raise ValueError(f"kernel takes float32 or bfloat16 x, got "
                             f"{x2d.dtype}")
        if w.dtype != b.dtype or w.dtype not in self._DTYPES:
            raise ValueError(f"kernel takes w and b of one dtype, float32 "
                             f"or bfloat16, got {w.dtype} and {b.dtype}")
        if tuple(w.shape) != (d,) or tuple(b.shape) != (d,):
            raise ValueError(f"w and b must be [{d}]")
        vec = 16 // x2d.element_size()
        if d % vec or d // vec > self._MAX_VECS:
            raise ValueError(f"kernel takes d a multiple of {vec} up to "
                             f"{vec * self._MAX_VECS} for {x2d.dtype}, "
                             f"got {d}")
        for t in (x2d, w, b):
            if t.device != x2d.device or t.device.type != "cuda":
                raise ValueError("kernel inputs must all lie on one CUDA "
                                 "device")
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
        if x2d.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
        y = torch.empty_like(x2d)
        if rows == 0:
            return y
        with torch.cuda.device(x2d.device):
            stream = torch.cuda.current_stream(x2d.device).cuda_stream
            err = self._kernel()(
                x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                rows, d, float(eps), self._DTYPES[x2d.dtype],
                self._DTYPES[w.dtype], stream)
        if err != 0:
            raise RuntimeError(f"layer_norm kernel launch failed: "
                               f"cudaError {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return y


layer_norm_cuda = _LayerNormCuda()


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        if _flags.flag("use_pallas_layernorm") and x2d.device.type == "cuda":
            return layer_norm_cuda(x2d.contiguous(), w, b, eps)
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


@torch.library.custom_op("paddle_tpu_torch::layer_norm", mutates_args=())
def layer_norm_op(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Kernel K5 as a `torch.library` op, for exported graphs;
    `layer_norm` on CPU tensors."""
    if x2d.device.type == "cpu":
        return layer_norm(x2d, w, b, eps)
    return layer_norm_cuda(x2d.contiguous(), w, b, eps)


@layer_norm_op.register_fake
def _layer_norm_fake(x2d, w, b, eps):
    return torch.empty_like(x2d, memory_format=torch.contiguous_format)


def fused_layer_norm(x2d, w, b, eps=1e-5):
    """Differentiable LayerNorm.  x2d: [rows, d]; w/b: [d].  Kernel K5
    runs the forward of a CUDA tensor when ``FLAGS_use_pallas_layernorm``
    is on, `layer_norm` otherwise.  Under an export trace:
    `layer_norm_op` for `jit.save` with the flag on, `layer_norm`
    otherwise."""
    from ..static.export_marker import export_mode

    mode = export_mode()
    if mode is not None:
        if mode == "archive" and _flags.flag("use_pallas_layernorm"):
            return layer_norm_op(x2d, w, b, float(eps))
        return layer_norm(x2d, w, b, eps)
    return _FusedLayerNorm.apply(x2d, w, b, eps)
