"""The KV-cache helpers of the transformer layers (counterpart: the cache
helpers of paddle_tpu/nn/layer/transformer.py).

`PreallocKVCache` holds K/V buffers ``[B, H, max_length, D]`` allocated
once at the decode horizon and the number of rows written so far,
``length`` (a Python int: the port reads it on the host, so writing at
it and masking by it costs no device sync).  `kv_cache_write` writes a
step's rows at ``length``: in place, unless autograd would need the
buffer as it was, where it writes a copy, as the JAX package always
does.  The concat cache needs no helper: a step concatenates.
"""
from __future__ import annotations

import collections

import torch

__all__ = ["PreallocKVCache", "kv_capacity_check", "kv_cache_write",
           "kv_valid_mask"]

PreallocKVCache = collections.namedtuple("PreallocKVCache",
                                         ["k", "v", "length"])


def kv_capacity_check(length, s_new, max_length):
    """Raise ValueError when ``s_new`` rows at ``length`` pass
    ``max_length`` (the JAX package's dynamic_update_slice would clamp
    the write onto the last rows and expose stale ones)."""
    if int(length) + s_new > max_length:
        raise ValueError(
            f"PreallocKVCache overflow: writing {s_new} rows at position "
            f"{int(length)} exceeds max_length {max_length}")


def kv_cache_write(buf, new, length, check_capacity=True):
    """``buf`` [B, H, Smax, D] with ``new`` [B, H, s, D] written at row
    ``length``, cast to the buffer's dtype."""
    if check_capacity:
        kv_capacity_check(length, new.shape[2], buf.shape[2])
    start = int(length)
    if torch.is_grad_enabled() and (buf.requires_grad or new.requires_grad):
        buf = buf.clone()
    buf[:, :, start:start + new.shape[2]] = new.to(buf.dtype)
    return buf


def kv_valid_mask(length, s_new, max_length, causal=True, device=None):
    """Bool mask [1, 1, s_new, max_length] over a preallocated buffer.

    ``causal=True``: key j is visible to new query row i iff
    ``j <= length + i`` (buffer validity and causality within the chunk,
    the decoder block's contract); ``causal=False``: iff
    ``j < length + s_new``."""
    kpos = torch.arange(max_length, device=device).view(1, 1, 1, -1)
    if causal:
        qpos = torch.arange(s_new, device=device).view(1, 1, -1, 1)
        return kpos <= int(length) + qpos
    return (kpos < int(length) + s_new).expand(1, 1, s_new, max_length)
