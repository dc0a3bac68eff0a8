"""Attention functionals (counterpart: paddle_tpu/nn/functional/attention.py)."""
from __future__ import annotations

import torch

from ... import amp
from ...ops.flash_attention import flash_attention_fwd

__all__ = ["multi_query_causal_mask", "scaled_dot_product_attention",
           "flash_attention"]


def _sdpa_reference(q, k, v, mask, dropout_p, scale, is_causal):
    """The JAX package's composed attention: the q.k product scaled in the
    input dtype by ``1 / sqrt(d)`` cast to q's dtype, masked
    (bottom-right causal, ``-1e30``) and softmaxed in f32, probabilities
    cast back.  q, k, v: [B, H, S, D].  ``dropout_p`` is unused, as there."""
    d = q.shape[-1]
    s = scale if scale is not None else \
        1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * s).float()
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(ql, kl, dtype=torch.bool,
                            device=q.device).tril(kl - ql)
        logits = torch.where(causal, logits, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def multi_query_causal_mask(q_offsets: torch.Tensor, q_len: int,
                            seq_lens: torch.Tensor,
                            kv_len: int) -> torch.Tensor:
    """Ragged multi-query causal visibility.

    Query ``i`` of sequence ``b`` sits at absolute position
    ``q_offsets[b] + i`` and may see KV position ``p`` iff
    ``p < min(seq_lens[b], q_offsets[b] + i + 1)``.  A sequence with
    ``seq_lens == 0`` is fully masked.

    q_offsets/seq_lens: [B] integer tensors; returns bool [B, q_len,
    kv_len] on their device.
    """
    dev = seq_lens.device
    pos = torch.arange(kv_len, dtype=torch.int64, device=dev)
    qi = torch.arange(q_len, dtype=torch.int64, device=dev)
    limit = torch.minimum(seq_lens.long()[:, None],
                          q_offsets.long()[:, None] + qi[None, :] + 1)
    return pos[None, None, :] < limit[:, :, None]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None):
    """query/key/value: [batch, num_heads, seq, head_dim].  A WHITE op
    under `amp.auto_cast`.  CUDA tensors of rank 4 go to
    `ops.flash_attention.flash_attention_fwd` (kernels K3/K4, as the JAX
    package sends TPU arrays to its Pallas kernels); anything else to the
    composed form."""
    query, key, value, attn_mask = amp.cast_inputs(amp.WHITE, query, key,
                                                   value, attn_mask)
    if query.dim() == 4 and query.is_cuda:
        return flash_attention_fwd(query, key, value, attn_mask, is_causal,
                                   scale)
    return _sdpa_reference(query, key, value, attn_mask, dropout_p, scale,
                           is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False):
    out = scaled_dot_product_attention(query, key, value, is_causal=causal,
                                       dropout_p=dropout)
    if return_softmax:
        return out, None
    return out
