"""GPT decoder-only language model: configuration and parameters
(counterpart: paddle_tpu/models/gpt.py).

`GPT` holds trainable parameters under the JAX package's names
(``blocks.0.qkv.weight`` ...) and in its layout: every projection weight
is ``[in, out]``.  Its ``forward`` without a cache is the training path;
with the concat or prealloc KV caches it is ``generate``'s eager decode;
the serving engine reads the same weights through `GPT.params`.

Under a tensor-parallel group (a `HybridCommunicateGroup` with ``mp >
1``) and ``use_parallel_layers``, `GPT` builds the
JAX package's parallel layers where it does: qkv and fc1 are
`ColumnParallelLinear`, out and fc2 `RowParallelLinear`, ``wte`` a
`VocabParallelEmbedding` (the tied head reads its rows, an untied head
is column-split).  The weights given (or drawn) are the whole model's;
each rank keeps its block (`parallel.partition.
gpt_tensor_parallel_rules`).  qkv is split head-aligned: a rank holds q,
k and v of its ``num_heads / mp`` whole heads, so its attention (kernels
K3/K4 on the card) runs on its own heads.  The forward returns the whole
logits (gathered over the group), or this rank's vocabulary block with
``parallel_output=True``, which `gpt_loss_fn` feeds to the
vocab-parallel cross entropy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.dtype import convert_dtype
from ..device import resolve_device
from ..nn import functional as F
from ..nn import initializer as init
from ..nn.decode import sample_logits
from ..nn.functional.loss import cross_entropy
from ..nn.layer import (Dropout, Embedding, Layer, LayerList, LayerNorm,
                        Linear)
from ..nn.layer.transformer import (PreallocKVCache, kv_cache_write,
                                    kv_capacity_check, kv_valid_mask)
from ..ops.math import matmul

__all__ = ["GPTConfig", "GPTBlock", "GPT", "init_params", "gpt_loss_fn",
           "gpt_pipeline_layer"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = None
    dropout: float = 0.0
    tie_embeddings: bool = True
    use_parallel_layers: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    def draft_config(self, num_layers=1, hidden_size=None, num_heads=None,
                     intermediate_size=None):
        """A shrunk config for a speculative-decoding draft model
        (`inference.speculative.DraftModelDrafter`): vocab and position
        table pinned to this one's, so the draft proposes over the same
        tokens and horizon.  Defaults: 1 layer, half the width at this
        config's head_dim."""
        if hidden_size is None:
            head_dim = self.hidden_size // self.num_heads
            hidden_size = max(head_dim, self.hidden_size // 2)
        if num_heads is None:
            num_heads = max(1, min(self.num_heads,
                                   hidden_size //
                                   (self.hidden_size // self.num_heads)))
        if hidden_size % num_heads:
            raise ValueError(
                f"draft hidden_size {hidden_size} not divisible by "
                f"num_heads {num_heads}")
        return GPTConfig(
            vocab_size=self.vocab_size, hidden_size=hidden_size,
            num_layers=num_layers, num_heads=num_heads,
            max_seq_len=self.max_seq_len,
            intermediate_size=intermediate_size, dropout=0.0,
            tie_embeddings=self.tie_embeddings,
            use_parallel_layers=False)


def _adopt(layer: nn.Module, **tensors) -> nn.Module:
    """``layer`` (built on the meta device) over the given tensors, each
    wrapped as a parameter without a copy (keeping the replaced one's
    ``mesh_axes``); a ``None`` tensor stays None."""
    for name, t in tensors.items():
        old = getattr(layer, name, None)
        new = None if t is None else nn.Parameter(t)
        if new is not None and hasattr(old, "mesh_axes"):
            new.mesh_axes = old.mesh_axes
            new.is_distributed = old.is_distributed
        setattr(layer, name, new)
    return layer


def _mp_linear(kind, w, b, group, full_in, full_out, **kw):
    """A parallel linear over this rank's blocks ``w``/``b`` (no copy)."""
    layer = kind(full_in, full_out, has_bias=b is not None, mp_group=group,
                 device="meta", **kw)
    return _adopt(layer, weight=w, bias=b)


def _tp_group(cfg):
    from ..distributed.fleet.meta_parallel.mp_layers import mp_group_of

    return mp_group_of() if cfg.use_parallel_layers else None


def _shard_tree(params: dict, group) -> dict:
    """This rank's blocks of the whole tree (`gpt_tensor_parallel_rules`)."""
    from ..parallel.partition import (gpt_tensor_parallel_rules,
                                      match_partition_rules, shard_leaf,
                                      _map, _at)

    specs = match_partition_rules(gpt_tensor_parallel_rules(), params)
    coords = {"mp": (group.rank, group.nranks)}
    return _map(params, lambda path, t: shard_leaf(t, _at(specs, path),
                                                   coords))


def _linear(w, b):
    return _adopt(Linear(w.shape[0], w.shape[1],
                         bias_attr=False if b is None else None,
                         device="meta"), weight=w, bias=b)


def _layer_norm(w, b):
    return _adopt(LayerNorm(w.shape[0], device="meta"), weight=w, bias=b)


def _embedding(w):
    return _adopt(Embedding(w.shape[0], w.shape[1], device="meta"), weight=w)


def init_params(cfg: GPTConfig, device=None, dtype=torch.float32) -> dict:
    """A weight tree drawn as the JAX package's ``GPT(cfg)`` draws its
    parameters, from the default generator of ``device`` (default: the
    card): ``wte`` N(0, 0.02) with ``use_parallel_layers`` (its
    vocab-parallel embedding) else N(0, 1), ``wpe`` N(0, 1), projections
    Xavier uniform with zero biases, the residual projections (``out``,
    ``fc2``) N(0, 0.02 / sqrt(2 * num_layers)), LayerNorms weight 1 and
    bias 0, an untied head Xavier uniform without bias."""
    device = resolve_device(device)
    h, f = cfg.hidden_size, cfg.intermediate_size
    xavier, one, zero = init.XavierUniform(), init.Constant(1.0), \
        init.Constant(0.0)
    resid = init.Normal(0.0, 0.02 / math.sqrt(2 * cfg.num_layers))

    def draw(ini, *shape):
        return ini._init(shape, dtype, device)

    params = {"wte": draw(init.Normal(0.0, 0.02 if cfg.use_parallel_layers
                                      else 1.0), cfg.vocab_size, h),
              "wpe": draw(init.Normal(0.0, 1.0), cfg.max_seq_len, h)}
    params["blocks"] = [{
        "ln1_w": draw(one, h), "ln1_b": draw(zero, h),
        "ln2_w": draw(one, h), "ln2_b": draw(zero, h),
        "qkv_w": draw(xavier, h, 3 * h), "qkv_b": draw(zero, 3 * h),
        "out_w": draw(resid, h, h), "out_b": draw(zero, h),
        "fc1_w": draw(xavier, h, f), "fc1_b": draw(zero, f),
        "fc2_w": draw(resid, f, h), "fc2_b": draw(zero, h),
    } for _ in range(cfg.num_layers)]
    params["lnf_w"], params["lnf_b"] = draw(one, h), draw(zero, h)
    if not cfg.tie_embeddings:
        params["head_w"], params["head_b"] = \
            draw(xavier, h, cfg.vocab_size), None
    return params


class GPTBlock(Layer):
    def __init__(self, cfg: GPTConfig, p: dict, mp_group=None):
        """``p``: the block's weights, this rank's blocks of them under a
        tensor-parallel ``mp_group``."""
        super().__init__()
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.ln1 = _layer_norm(p["ln1_w"], p["ln1_b"])
        self.ln2 = _layer_norm(p["ln2_w"], p["ln2_b"])
        if mp_group is None:
            self.num_heads = cfg.num_heads
            self.qkv = _linear(p["qkv_w"], p["qkv_b"])
            self.out_proj = _linear(p["out_w"], p["out_b"])
            self.fc1 = _linear(p["fc1_w"], p["fc1_b"])
            self.fc2 = _linear(p["fc2_w"], p["fc2_b"])
        else:
            from ..distributed.fleet.meta_parallel.mp_layers import (
                ColumnParallelLinear as Col, RowParallelLinear as Row)
            from ..parallel.partition import QKV_HEADS

            h, f = cfg.hidden_size, cfg.intermediate_size
            self.num_heads = cfg.num_heads // mp_group.nranks
            self.qkv = _mp_linear(Col, p["qkv_w"], p["qkv_b"], mp_group, h,
                                  3 * h, gather_output=False)
            self.qkv.weight.mesh_axes = (None, QKV_HEADS)
            self.qkv.bias.mesh_axes = (QKV_HEADS,)
            self.out_proj = _mp_linear(Row, p["out_w"], p["out_b"],
                                       mp_group, h, h,
                                       input_is_parallel=True)
            self.fc1 = _mp_linear(Col, p["fc1_w"], p["fc1_b"], mp_group, h,
                                  f, gather_output=False)
            self.fc2 = _mp_linear(Row, p["fc2_w"], p["fc2_b"], mp_group, f,
                                  h, input_is_parallel=True)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache=None, prealloc_mask=None):
        """Pre-LN causal self-attention and a tanh-GELU MLP, each added to
        the residual.  x: [b, s, h].  ``cache`` enables incremental
        decode:

        * ``("concat", k, v)`` or ``("concat", None, None)``: the growth
          cache, K/V concatenated a step (a causal mask aligned
          bottom-right, so an appended row sees the whole prefix);
        * a `PreallocKVCache` (`GPT.gen_caches`): buffers written at
          ``length``, attention under the validity mask ``prealloc_mask``
          (`GPT.forward` builds it once a step; made here when None).

        Returns ``x`` without a cache, else ``(x, new_cache)``."""
        b, s, h = x.shape
        qkv = self.qkv(self.ln1(x))
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [b, H, s, d]
        if cache is None:
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        elif isinstance(cache, PreallocKVCache):
            hoisted = prealloc_mask is not None
            full_k = kv_cache_write(cache.k, k, cache.length,
                                    check_capacity=not hoisted)
            full_v = kv_cache_write(cache.v, v, cache.length,
                                    check_capacity=False)
            mask = prealloc_mask if hoisted else kv_valid_mask(
                cache.length, s, full_k.shape[2], device=x.device)
            attn = F.scaled_dot_product_attention(q, full_k, full_v,
                                                  attn_mask=mask)
            cache = PreallocKVCache(full_k, full_v, int(cache.length) + s)
        else:
            _, k_prev, v_prev = cache
            if k_prev is not None:
                k = torch.cat([k_prev, k], dim=2)
                v = torch.cat([v_prev, v], dim=2)
            cache = ("concat", k, v)
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        attn = attn.permute(0, 2, 1, 3).reshape(b, s, -1)
        x = x + self.dropout(self.out_proj(attn))
        y = self.ln2(x)
        x = x + self.dropout(self.fc2(F.gelu(self.fc1(y), approximate=True)))
        return x if cache is None else (x, cache)


class GPT(Layer):
    def __init__(self, cfg: GPTConfig, params: dict = None, device=None,
                 dtype=torch.float32):
        """``params``: the tensor tree of `params()` (the layout of
        paddle_tpu's ``_extract_gpt_params``), adopted as the model's
        trainable parameters without a copy (`from_params`).  Without
        it the weights are drawn on ``device`` (default: the card) as the
        JAX package's ``GPT(cfg)`` draws them (`init_params`), from the
        default generator (`seed`).  `random` is GPT-2's N(0, 0.02)
        convention from a seed of its own.  Under a tensor-parallel group
        (the current hybrid group's ``mp`` axis, with
        ``use_parallel_layers``) ``params`` is the whole tree and the
        model keeps this rank's blocks (the module docstring)."""
        super().__init__()
        if params is None:
            params = init_params(cfg, device, dtype)
        self.cfg = cfg
        self.mp_group = group = _tp_group(cfg)
        if group is not None:
            from ..distributed.fleet.meta_parallel.mp_layers import \
                VocabParallelEmbedding

            params = _shard_tree(params, group)
            self.wte = _adopt(VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, mp_group=group,
                device="meta"), weight=params["wte"])
        else:
            self.wte = _embedding(params["wte"])
        self.wpe = _embedding(params["wpe"])
        self.blocks = LayerList(GPTBlock(cfg, p, group)
                                for p in params["blocks"])
        self.ln_f = _layer_norm(params["lnf_w"], params["lnf_b"])
        if not cfg.tie_embeddings:
            self.lm_head = _linear(params["head_w"], params.get("head_b"))
            if group is not None:
                self.lm_head.weight.mesh_axes = (None, "mp")
                self.lm_head.weight.is_distributed = True

    def forward(self, input_ids, caches=None, pos_start=0,
                parallel_output=False):
        """Logits [b, s, vocab] of token ids [b, s] at positions
        ``pos_start`` on; with ``caches`` (one a block, `gen_caches`)
        returns ``(logits, new_caches)``.  A prealloc step checks the
        horizon and builds the validity mask once for every block.  The
        tied head is a WHITE ``matmul`` against ``wte``, so under bf16
        `amp.auto_cast` the logits are bf16 while the residual stream
        stays f32.  Under a tensor-parallel group the logits are gathered
        over it, unless ``parallel_output`` (this rank's vocabulary
        block)."""
        b, s = input_ids.shape
        pos = torch.arange(pos_start, pos_start + s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        new_caches = [] if caches is not None else None
        prealloc_mask = None
        if caches and isinstance(caches[0], PreallocKVCache):
            smax = caches[0].k.shape[2]
            kv_capacity_check(caches[0].length, s, smax)
            prealloc_mask = kv_valid_mask(caches[0].length, s, smax,
                                          device=x.device)
        for i, blk in enumerate(self.blocks):
            if caches is None:
                x = blk(x)
            else:
                x, c = blk(x, cache=caches[i], prealloc_mask=prealloc_mask)
                new_caches.append(c)
        x = self.ln_f(x)
        if self.mp_group is not None:
            from ..distributed.fleet.meta_parallel.mp_layers import (
                c_concat, c_identity)

            x = c_identity(x, self.mp_group)
        if self.cfg.tie_embeddings:
            logits = matmul(x, self.wte.weight, transpose_y=True)
        else:
            logits = self.lm_head(x)
        if self.mp_group is not None and not parallel_output:
            logits = c_concat(logits, self.mp_group)
        return logits if caches is None else (logits, new_caches)

    def gen_caches(self, batch_size, mode="prealloc", max_length=None,
                   dtype=None):
        """One decode cache a block.  ``prealloc`` allocates K/V buffers
        of ``max_length`` (default: the position table) once, in
        ``dtype`` (default: the weights'); ``concat`` is the growth
        cache."""
        if mode == "concat":
            return [("concat", None, None) for _ in self.blocks]
        if mode != "prealloc":
            raise ValueError(
                f"cache mode must be 'prealloc' or 'concat', got {mode!r}")
        if max_length is None:
            max_length = self.cfg.max_seq_len
        w = self.wte.weight
        dtype = w.dtype if dtype is None else convert_dtype(dtype)
        caches = []
        for blk in self.blocks:
            shape = (batch_size, blk.num_heads, int(max_length),
                     blk.head_dim)
            caches.append(PreallocKVCache(
                torch.zeros(shape, dtype=dtype, device=w.device),
                torch.zeros(shape, dtype=dtype, device=w.device), 0))
        return caches

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, eos_token_id=None,
                 sampler="greedy", temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, use_cache="prealloc"):
        """Eager autoregressive decode of ``input_ids`` [B, P] (the
        single-model counterpart of `inference.serving.DecodeEngine`):
        the prompt in one pass, then a token a pass through the
        ``use_cache`` cache ("prealloc" or "concat"), each token chosen by
        `nn.decode.sample_logits` (a sampler other than greedy draws
        from a ``torch.Generator`` seeded with ``seed``).  Rows that
        emitted ``eos_token_id`` keep emitting it; decoding stops when
        every row has.  Returns the generated ids [B, <= max_new_tokens]
        int32 on the model's device."""
        b, p_len = input_ids.shape
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.cfg.dropout and self.training:
            # the contract of DecodeEngine: decoding under live dropout
            # would corrupt tokens and break cache-mode parity
            raise ValueError(
                "generate() is inference only: call model.eval() first "
                "(cfg.dropout > 0 and the model is in train mode)")
        if p_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        if use_cache == "prealloc":
            caches = self.gen_caches(b, "prealloc",
                                     max_length=p_len + max_new_tokens)
        elif use_cache == "concat":
            caches = self.gen_caches(b, "concat")
        else:
            raise ValueError(
                f"use_cache must be 'prealloc' or 'concat', "
                f"got {use_cache!r}")
        device = self.wte.weight.device
        input_ids = input_ids.to(device)
        gen = None
        if sampler != "greedy":
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
        logits, caches = self(input_ids, caches=caches, pos_start=0)
        out = []
        finished = torch.zeros(b, dtype=torch.bool, device=device)
        for step in range(max_new_tokens):
            tok = sample_logits(logits[:, -1].float(), sampler=sampler,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, generator=gen)
            if eos_token_id is not None:
                tok = torch.where(finished, torch.full_like(
                    tok, int(eos_token_id)), tok)
                finished |= tok == eos_token_id
            out.append(tok)
            if step == max_new_tokens - 1 or (
                    eos_token_id is not None and bool(finished.all())):
                break
            logits, caches = self(tok[:, None], caches=caches,
                                  pos_start=p_len + step)
        return torch.stack(out, dim=1)

    @classmethod
    def from_params(cls, cfg: GPTConfig, params: dict) -> "GPT":
        """A model over an existing tensor tree (no copy), e.g. the
        output of `inference.weights.params_from_numpy`."""
        return cls(cfg, params)

    @classmethod
    def random(cls, cfg: GPTConfig, seed: int = 0, device=None,
               dtype=torch.float32) -> "GPT":
        """Random weights from ``seed``: projections and embeddings
        N(0, 0.02) with the residual projections scaled by
        1/sqrt(2 * num_layers) (the GPT-2 convention paddle_tpu uses),
        LayerNorms at weight 1 / bias 0, biases 0."""
        device = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        h, f = cfg.hidden_size, cfg.intermediate_size
        resid = 0.02 / math.sqrt(2 * cfg.num_layers)

        def normal(*shape, std=0.02):
            t = torch.randn(*shape, generator=gen) * std
            return t.to(device=device, dtype=dtype)

        def const(n, v):
            return torch.full((n,), float(v), device=device, dtype=dtype)

        blocks = [{
            "ln1_w": const(h, 1), "ln1_b": const(h, 0),
            "ln2_w": const(h, 1), "ln2_b": const(h, 0),
            "qkv_w": normal(h, 3 * h), "qkv_b": const(3 * h, 0),
            "out_w": normal(h, h, std=resid), "out_b": const(h, 0),
            "fc1_w": normal(h, f), "fc1_b": const(f, 0),
            "fc2_w": normal(f, h, std=resid), "fc2_b": const(h, 0),
        } for _ in range(cfg.num_layers)]
        params = {"wte": normal(cfg.vocab_size, h),
                  "wpe": normal(cfg.max_seq_len, h),
                  "lnf_w": const(h, 1), "lnf_b": const(h, 0),
                  "blocks": blocks}
        if not cfg.tie_embeddings:
            params["head_w"] = normal(h, cfg.vocab_size)
            params["head_b"] = None
        return cls(cfg, params)

    def params(self) -> dict:
        """The weight tree in paddle_tpu's ``_extract_gpt_params`` layout:
        the parameters' storage (no copy), detached from autograd, which
        is what the serving engine reads."""
        def blk(b):
            return {k: t.detach() for k, t in {
                "ln1_w": b.ln1.weight, "ln1_b": b.ln1.bias,
                "ln2_w": b.ln2.weight, "ln2_b": b.ln2.bias,
                "qkv_w": b.qkv.weight, "qkv_b": b.qkv.bias,
                "out_w": b.out_proj.weight, "out_b": b.out_proj.bias,
                "fc1_w": b.fc1.weight, "fc1_b": b.fc1.bias,
                "fc2_w": b.fc2.weight, "fc2_b": b.fc2.bias,
            }.items()}

        out = {"wte": self.wte.weight.detach(),
               "wpe": self.wpe.weight.detach(),
               "lnf_w": self.ln_f.weight.detach(),
               "lnf_b": self.ln_f.bias.detach(),
               "blocks": [blk(b) for b in self.blocks]}
        if not self.cfg.tie_embeddings:
            head_b = self.lm_head.bias
            out["head_w"] = self.lm_head.weight.detach()
            out["head_b"] = None if head_b is None else head_b.detach()
        return out


def _inner_gpt(model):
    while not isinstance(model, GPT) and hasattr(model, "_layers"):
        model = model._layers
    return model


def gpt_loss_fn(model, input_ids, labels):
    """Next-token cross entropy (the train-step loss callable); a
    tensor-parallel GPT (under any wrapper) takes its vocabulary block of
    the logits through the vocab-parallel cross entropy, the same
    mean."""
    group = getattr(_inner_gpt(model), "mp_group", None)
    if group is None:
        return cross_entropy(model(input_ids), labels, reduction="mean")
    from ..distributed.fleet.meta_parallel.mp_layers import \
        parallel_cross_entropy

    nll = parallel_cross_entropy(model(input_ids, parallel_output=True),
                                 labels, group)
    return nll.sum() / max(labels.numel(), 1)


class _EmbedPipe(Layer):
    """The pipeline's embedding (``wte`` and ``wpe``); as a shared layer
    its ``wte`` is also the tied head (`_tied_head`)."""

    def __init__(self, wte, wpe, device):
        super().__init__()
        self.wte = _embedding(torch.as_tensor(wte).to(device).clone())
        self.wpe = _embedding(torch.as_tensor(wpe).to(device).clone())

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.wte(input_ids) + self.wpe(pos)


def _tied_head(embed, x):
    return matmul(x, embed.wte.weight, transpose_y=True)


class _BlockPipe(GPTBlock):
    def __init__(self, cfg, p, device):
        super().__init__(cfg, {k: torch.as_tensor(v).to(device).clone()
                               for k, v in p.items()})


class _NormPipe(Layer):
    def __init__(self, w, b, device):
        super().__init__()
        self.ln_f = _layer_norm(torch.as_tensor(w).to(device).clone(),
                                torch.as_tensor(b).to(device).clone())

    def forward(self, x):
        return self.ln_f(x)


def gpt_pipeline_layer(cfg: GPTConfig, params: dict, num_stages=None,
                       device=None, loss_fn=None):
    """The GPT of ``params`` (the whole tree, e.g. ``GPT.random(cfg,
    seed, device="cpu").params()``) as a `PipelineLayer`: the embedding,
    the blocks, the final LayerNorm and the tied head, the embedding a
    `SharedLayerDesc` read by the first and last stage.  Stages hold
    equal numbers of blocks (``seg_method="layer:_BlockPipe"``); a rank
    copies only its stage's weights onto ``device``.  ``loss_fn(logits,
    labels)`` defaults to the mean cross entropy.  Tied embeddings
    only."""
    from ..distributed.fleet.meta_parallel.pipeline_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)

    if not cfg.tie_embeddings:
        raise ValueError("gpt_pipeline_layer builds the tied GPT")
    device = resolve_device(device)
    descs = [SharedLayerDesc("embed", _EmbedPipe, None, "wte",
                             params["wte"], params["wpe"], device)]
    descs += [LayerDesc(_BlockPipe, cfg, blk, device)
              for blk in params["blocks"]]
    descs += [LayerDesc(_NormPipe, params["lnf_w"], params["lnf_b"], device),
              SharedLayerDesc("embed", _EmbedPipe, _tied_head, "wte",
                              params["wte"], params["wpe"], device)]
    if loss_fn is None:
        def loss_fn(logits, labels):
            return cross_entropy(logits, labels, reduction="mean")
    return PipelineLayer(descs, num_stages=num_stages, loss_fn=loss_fn,
                         seg_method="layer:_BlockPipe")
