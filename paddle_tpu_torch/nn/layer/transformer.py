"""Transformer layers and their KV-cache helpers (counterpart:
paddle_tpu/nn/layer/transformer.py).

`MultiHeadAttention` projects q, k and v (`Linear`, Paddle's [in, out]
weights), runs `functional.scaled_dot_product_attention` over ``[B, H,
S, D]`` (on a card an unmasked call is kernels K3 forward and K4
backward, a masked one the composed form, as on the JAX package's TPU)
and projects the heads back.  Its caches: `Cache` (K/V grown by
concatenation), `StaticCache` (the cross-attention's projected memory)
and `PreallocCache` (`PreallocKVCache`, whose buffer validity joins the
caller's mask).  Attention dropout is applied by neither package's
attention route.  `TransformerEncoder`/`Decoder` deep-copy their layer
(every layer starts from the same weights, as there), and the decoder
layers build their attentions and linears without the given
``weight_attr``/``bias_attr``, as there.

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
import copy

import torch

from .. import functional as F
from ...core.place import to_device
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["PreallocKVCache", "kv_capacity_check", "kv_cache_write",
           "kv_valid_mask", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

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


def _combine_masks(valid, user_mask):
    """A buffer-validity mask joined with the caller's: a bool mask by
    and, an additive one with ``-1e30`` where invalid."""
    if user_mask is None:
        return valid
    if user_mask.dtype == torch.bool:
        return valid & user_mask
    return torch.where(valid, user_mask.float(), -1e30)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    PreallocCache = PreallocKVCache

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.need_weights = need_weights

    def _shape(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def gen_cache(self, key, value=None, type=None, max_length=None):
        """A `StaticCache` of ``key``/``value`` projected (``type=
        StaticCache``), a `PreallocCache` of zeros [B, H, max_length, D]
        at length 0 (``max_length``), else an empty `Cache`."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(
                self._shape(self.k_proj(key)),
                self._shape(self.v_proj(value if value is not None
                                        else key)))
        rows = 0 if max_length is None else int(max_length)
        k, v = (key.new_zeros(key.shape[0], self.num_heads, rows,
                              self.head_dim) for _ in range(2))
        if max_length is not None:
            return self.PreallocCache(k, v, 0)
        return self.Cache(k, v)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.PreallocCache):
                s_new = k.shape[2]
                kv_capacity_check(cache.length, s_new, cache.k.shape[2])
                k = kv_cache_write(cache.k, k, cache.length, False)
                v = kv_cache_write(cache.v, v, cache.length, False)
                # buffer validity only: within-chunk causality is the
                # caller's mask's, as with the concat cache
                attn_mask = _combine_masks(
                    kv_valid_mask(cache.length, s_new, k.shape[2],
                                  causal=False, device=k.device), attn_mask)
                cache = self.PreallocCache(k, v, int(cache.length) + s_new)
            elif isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], 2)
                v = torch.cat([cache.v, v], 2)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = out.transpose(1, 2)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental = None
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static = cache[1] if cache is not None else None
        tgt = self.cross_attn(tgt, memory, memory, memory_mask, static)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, static))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                        dropout, activation, attn_dropout,
                                        act_dropout, normalize_before),
                num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                        dropout, activation, attn_dropout,
                                        act_dropout, normalize_before),
                num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """Additive causal mask [length, length]: 0 on and below the
        diagonal, -1e9 above, on the expected place."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=to_device(None)).tril()
        return torch.where(keep, 0.0, -1e9)
