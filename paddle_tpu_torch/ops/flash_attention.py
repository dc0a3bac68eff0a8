"""Dense flash attention, forward and backward (counterpart:
paddle_tpu/ops/pallas/flash_attention.py).

q, k, v are ``[B, H, S, D]``.  `flash_attention_fwd` is the entry point:
without a mask and with matching lengths when causal, it runs
`FlashAttention`, whose forward is kernel K3 and whose backward is
kernel K4 (`csrc/flash_attention.cu`: one dkv and one dq kernel) for CUDA
tensors, and the two plain versions for CPU tensors:
`_composed_attention` (forward, with the f32 ``lse``) and
`flash_attention_bwd_reference` (K4's formulas over the whole S x S in
f32).  A mask, or causal attention with ``seq_q != seq_k``, takes the
composed form on any device, as in the JAX package: the kernels mask
top-left (``q_pos >= k_pos``) and the composed form bottom-right, and the
two agree only at ``seq_q == seq_k``.  A CUDA input the kernels do not
take raises; there is no fallback.

The TPU's block-size rules (``pick_blocks``, the autotune cache) and its
sequence thresholds are not carried over: the kernels take any length
and mask the ragged tail themselves.

Export (`static.export_marker`): under `jit.save`'s trace the forward
binds the custom op ``paddle_tpu_torch::flash_attention_fwd``
(`flash_attention_fwd_op`: K3 on CUDA tensors, counted as every launch
is; the composed form on the CPU; a fake of the output shapes for the
trace), since ``data_ptr()`` has no meaning on a traced tensor; under
`fx_export`'s trace it takes the composed form, so a ProgramDesc holds
reference op types only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention_fwd", "FlashAttention",
           "flash_attention_bwd_reference", "flash_attention_cuda_fwd",
           "flash_attention_cuda_dkv", "flash_attention_cuda_dq",
           "flash_attention_fwd_op"]

_MASK_VALUE = -1e30  # paddle_tpu's mask value


def _scale_of(d: int, scale):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _composed_attention(q, k, v, mask, is_causal, scale, want_lse=False):
    """The composed O(S^2) attention of the JAX package: the q.k product
    scaled in the input dtype, masked (bottom-right causal, ``-1e30``) and
    softmaxed in f32, probabilities cast back to q's dtype.  Returns out,
    or ``(out, lse)`` with ``lse`` f32 ``[B, H, Sq]``."""
    s = _scale_of(q.shape[-1], scale)
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * s).float()
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(ql, kl, dtype=torch.bool,
                            device=q.device).tril(kl - ql)
        logits = torch.where(causal, logits, _MASK_VALUE)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, _MASK_VALUE)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if want_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_bwd_reference(q, k, v, o, lse, do, is_causal, scale):
    """Plain backward with kernel K4's formulas, in f32 over the whole
    S x S (not autograd through the composed form): ``qs = q * scale``,
    ``p = exp(qs k^T - lse)`` under the top-left causal mask,
    ``delta = rowsum(do * o)``, ``ds = p (do v^T - delta)``;
    ``dv = p^T do``, ``dk = ds^T qs``, ``dq = scale * ds k``.

    q, o, do: [B, H, Sq, D]; k, v: [B, H, Sk, D]; lse: f32 with B*H*Sq
    elements ([B*H, Sq] as the kernels keep it, or [B, H, Sq]).  Returns
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    s = _scale_of(d, scale)
    qs = q.float() * s
    kf, vf, dof = k.float(), v.float(), do.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    if is_causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, _MASK_VALUE)
    p = torch.exp(logits - lse.float().reshape(b, h, sq, 1))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * s
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashKernel:
    """ctypes wrapper of one kernel of ``csrc/flash_attention.cu``.
    ``launches`` counts the kernel launches this process made; it grows
    by one per launch and nowhere else.  A call made while the stream is
    being captured into a CUDA graph launches nothing: it adds one to
    ``captured`` instead, and the graph adds its captured launches to
    ``launches`` each time it replays (`ops.capture`)."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}
    _HEAD_DIMS = (64, 128)

    def __init__(self, symbol: str, pointers: int):
        self.launches = 0
        self.captured = 0
        self._symbol = symbol
        self._pointers = pointers
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = getattr(_build.load("flash_attention"), self._symbol)
            fn.argtypes = ([ctypes.c_void_p] * self._pointers
                           + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _check(self, q, k, v, o=None, lse=None, do=None):
        """Raise on any input the kernel does not take; returns
        ``(B*H, Sq, Sk, D)``."""
        if q.dim() != 4:
            raise ValueError(f"kernel takes q as [B, H, S, D], got rank "
                             f"{q.dim()}")
        b, h, sq, d = q.shape
        sk = k.shape[2]
        if q.dtype not in self._DTYPES:
            raise ValueError(f"kernel takes float32 or bfloat16, got "
                             f"{q.dtype}")
        if d not in self._HEAD_DIMS:
            raise ValueError(f"kernel takes head_dim in {self._HEAD_DIMS}, "
                             f"got {d}")
        shapes = [("k", k, (b, h, sk, d)), ("v", v, (b, h, sk, d))]
        if o is not None:
            shapes += [("out", o, (b, h, sq, d)), ("dout", do, (b, h, sq, d))]
        for name, t, shape in shapes:
            if t.dtype != q.dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {q.dtype} {list(shape)}")
        tensors = [q, k, v]
        if lse is not None:
            if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, sq):
                raise ValueError(f"lse must be float32 [{b * h}, {sq}]")
            tensors += [o, lse, do]
        for t in tensors:
            if t.device != q.device or t.device.type != "cuda":
                raise ValueError("kernel inputs must all lie on one CUDA "
                                 "device")
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError("kernel inputs must be 16-byte aligned")
        return b * h, sq, sk, d

    def _launch(self, device, tensors, bh, sq, sk, d, scale, is_causal,
                dtype):
        if bh == 0 or sq == 0 or sk == 0:
            return
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._kernel()(
                *(t.data_ptr() for t in tensors), bh, sq, sk, d,
                float(_scale_of(d, scale)), int(bool(is_causal)),
                self._DTYPES[dtype], stream)
        if err != 0:
            raise RuntimeError(f"{self._symbol} kernel launch failed: "
                               f"cudaError {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


class _FlashFwdCuda(_FlashKernel):
    def __call__(self, q, k, v, is_causal, scale=None):
        """Kernel K3.  q: [B, H, Sq, D]; k, v: [B, H, Sk, D].  Returns
        ``(out [B, H, Sq, D], lse f32 [B*H, Sq])``."""
        bh, sq, sk, d = self._check(q, k, v)
        out = torch.empty_like(q)
        lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
        self._launch(q.device, (q, k, v, out, lse), bh, sq, sk, d, scale,
                     is_causal, q.dtype)
        return out, lse


class _FlashDkvCuda(_FlashKernel):
    def __call__(self, q, k, v, o, lse, do, is_causal, scale=None):
        """Kernel K4, dkv.  Inputs as `flash_attention_bwd_reference`
        with ``lse`` f32 [B*H, Sq].  Returns ``(dk, dv)``."""
        bh, sq, sk, d = self._check(q, k, v, o, lse, do)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._launch(q.device, (q, k, v, o, lse, do, dk, dv), bh, sq, sk, d,
                     scale, is_causal, q.dtype)
        return dk, dv


class _FlashDqCuda(_FlashKernel):
    def __call__(self, q, k, v, o, lse, do, is_causal, scale=None):
        """Kernel K4, dq.  Inputs as for the dkv kernel.  Returns dq."""
        bh, sq, sk, d = self._check(q, k, v, o, lse, do)
        dq = torch.empty_like(q)
        self._launch(q.device, (q, k, v, o, lse, do, dq), bh, sq, sk, d,
                     scale, is_causal, q.dtype)
        return dq


flash_attention_cuda_fwd = _FlashFwdCuda("flash_attention_fwd", 5)
flash_attention_cuda_dkv = _FlashDkvCuda("flash_attention_bwd_dkv", 8)
flash_attention_cuda_dq = _FlashDqCuda("flash_attention_bwd_dq", 7)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the ``_flash_diff`` custom VJP of
    the JAX package).  CUDA tensors: forward K3, saving q, k, v, out and
    lse; backward K4.  CPU tensors: the two plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale):
        if q.device.type == "cpu":
            out, lse = _composed_attention(q, k, v, None, is_causal, scale,
                                           want_lse=True)
            lse = lse.reshape(-1, q.shape[2])
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_attention_cuda_fwd(q, k, v, is_causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.is_causal, ctx.scale = is_causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.is_causal, ctx.scale
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                       causal, scale)
        else:
            do = do.contiguous()
            dk, dv = flash_attention_cuda_dkv(q, k, v, out, lse, do, causal,
                                              scale)
            dq = flash_attention_cuda_dq(q, k, v, out, lse, do, causal,
                                         scale)
        return dq, dk, dv, None, None


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, is_causal: bool,
                           scale: Optional[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 as a `torch.library` op, for exported graphs: ``(out,
    lse f32 [B*H, Sq])``; the composed form on CPU tensors."""
    if q.device.type == "cpu":
        out, lse = _composed_attention(q, k, v, None, is_causal, scale,
                                       want_lse=True)
        return out, lse.reshape(-1, q.shape[2])
    return flash_attention_cuda_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), is_causal, scale)


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, is_causal, scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((q.shape[0] * q.shape[1], q.shape[2]),
                        dtype=torch.float32))


def flash_attention_fwd(q, k, v, mask=None, is_causal=False, scale=None):
    """Attention of q over k, v, all ``[B, H, S, D]``; differentiable.

    Routes as the JAX package does on the TPU: a mask, or causal with
    ``seq_q != seq_k``, takes the composed form; everything else runs
    `FlashAttention` (kernels K3/K4 on CUDA, the plain versions on the
    CPU).  Under an export trace: `flash_attention_fwd_op` for
    `jit.save`, the composed form for a ProgramDesc."""
    if mask is not None or (is_causal and q.shape[-2] != k.shape[-2]):
        return _composed_attention(q, k, v, mask, is_causal, scale)
    from ..static.export_marker import export_mode

    mode = export_mode()
    if mode == "program":
        return _composed_attention(q, k, v, None, is_causal, scale)
    if mode == "archive":
        return flash_attention_fwd_op(q, k, v, bool(is_causal), scale)[0]
    return FlashAttention.apply(q, k, v, is_causal, scale)
