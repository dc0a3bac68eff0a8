"""GPT decoder-only language model: configuration and parameters
(counterpart: paddle_tpu/models/gpt.py).

`GPT` holds trainable parameters under the JAX package's names
(``blocks.0.qkv.weight`` ...) and in its layout: every projection weight
is ``[in, out]``.  Its ``forward`` (no KV cache) is the training path;
the serving engine reads the same weights through `GPT.params`.  The
cached ``forward`` and ``generate`` come with a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.functional.loss import cross_entropy
from ..nn.layer import Dropout, Embedding, LayerList, LayerNorm, Linear
from ..ops.math import matmul

__all__ = ["GPTConfig", "GPTBlock", "GPT", "gpt_loss_fn"]


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
    wrapped as a parameter without a copy; a ``None`` tensor stays None."""
    for name, t in tensors.items():
        setattr(layer, name, None if t is None else nn.Parameter(t))
    return layer


def _linear(w, b):
    return _adopt(Linear(w.shape[0], w.shape[1],
                         bias_attr=False if b is None else None,
                         device="meta"), weight=w, bias=b)


def _layer_norm(w, b):
    return _adopt(LayerNorm(w.shape[0], device="meta"), weight=w, bias=b)


def _embedding(w):
    return _adopt(Embedding(w.shape[0], w.shape[1], device="meta"), weight=w)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, p: dict):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.ln1 = _layer_norm(p["ln1_w"], p["ln1_b"])
        self.ln2 = _layer_norm(p["ln2_w"], p["ln2_b"])
        self.qkv = _linear(p["qkv_w"], p["qkv_b"])
        self.out_proj = _linear(p["out_w"], p["out_b"])
        self.fc1 = _linear(p["fc1_w"], p["fc1_b"])
        self.fc2 = _linear(p["fc2_w"], p["fc2_b"])
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        """The block without a KV cache: pre-LN causal self-attention and
        a tanh-GELU MLP, each added to the residual.  x: [b, s, h]."""
        b, s, h = x.shape
        qkv = self.qkv(self.ln1(x))
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [b, H, s, d]
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        attn = attn.permute(0, 2, 1, 3).reshape(b, s, h)
        x = x + self.dropout(self.out_proj(attn))
        y = self.ln2(x)
        return x + self.dropout(self.fc2(F.gelu(self.fc1(y),
                                                approximate=True)))


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig, params: dict):
        """``params``: the tensor tree of `params()` (the layout of
        paddle_tpu's ``_extract_gpt_params``), adopted as the model's
        trainable parameters without a copy.  Use `from_params` or
        `random` to build one."""
        super().__init__()
        self.cfg = cfg
        self.wte = _embedding(params["wte"])
        self.wpe = _embedding(params["wpe"])
        self.blocks = LayerList(GPTBlock(cfg, p) for p in params["blocks"])
        self.ln_f = _layer_norm(params["lnf_w"], params["lnf_b"])
        if not cfg.tie_embeddings:
            self.lm_head = _linear(params["head_w"], params.get("head_b"))

    def forward(self, input_ids):
        """Logits [b, s, vocab] of token ids [b, s] (positions from 0),
        without a KV cache.  The tied head is a WHITE ``matmul`` against
        ``wte``, so under bf16 `amp.auto_cast` the logits are bf16 while
        the residual stream stays f32."""
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if self.cfg.tie_embeddings:
            return matmul(x, self.wte.weight, transpose_y=True)
        return self.lm_head(x)

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


def gpt_loss_fn(model, input_ids, labels):
    """Next-token cross entropy (the train-step loss callable)."""
    return cross_entropy(model(input_ids), labels, reduction="mean")
