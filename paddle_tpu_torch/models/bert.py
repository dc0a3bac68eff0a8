"""BERT and ERNIE encoders (counterpart: paddle_tpu/models/bert.py).

Embeddings (word, position, token type; LayerNorm; dropout), a
`TransformerEncoder` of post-norm GELU layers, a tanh pooler over the
first token, and the pretraining heads: the masked-LM head (dense, GELU,
LayerNorm, a decoder tied to the word embeddings) over a fixed number of
masked positions a row, and the next-sentence head.  The encoder always
gets an additive padding mask [B, 1, 1, S] (``-1e4`` at pad tokens), so
on a card its attention is the composed form, as in the JAX package.
Every module takes ``device=`` (default: the expected place).

The tied decoder weight is the embedding's parameter, reached through
``heads.decoder_weight`` but registered once, under
``bert.embeddings.word_embeddings.weight``: ``state_dict()`` has the JAX
model's names, so ``set_state_dict`` loads a JAX
``BertForPretraining``'s state (as numpy arrays) as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..core.place import expected_device
from ..nn import functional as F
from ..ops.math import matmul

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertPretrainingHeads", "BertForPretraining",
           "bert_pretrain_loss_fn", "ErnieModel"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    pad_token_id: int = 0


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        with expected_device(device):
            self.word_embeddings = nn.Embedding(
                cfg.vocab_size, cfg.hidden_size, weight_attr=init)
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size,
                weight_attr=init)
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, cfg.hidden_size, weight_attr=init)
            self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Layer):
    """Embeddings, ``num_layers`` encoder layers, the pooler; returns
    ``(sequence [B, S, H], pooled [B, H])``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        with expected_device(device):
            self.embeddings = BertEmbeddings(cfg)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                dropout=cfg.hidden_dropout, activation="gelu",
                attn_dropout=cfg.attention_dropout, act_dropout=0.0,
                normalize_before=False), cfg.num_layers)
            self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        if attention_mask is None:
            attention_mask = input_ids != self.config.pad_token_id
        b, s = input_ids.shape
        mask = (1.0 - attention_mask.float().reshape(b, 1, 1, s)) * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, src_mask=mask)
        return seq, torch.tanh(self.pooler(seq[:, 0]))


class BertPretrainingHeads(nn.Layer):
    """The masked-LM head over ``masked_positions`` [B, P] (a fixed count
    a row; padded slots are the loss's ``masked_weights``' business) and
    the next-sentence head over the pooled output."""

    def __init__(self, cfg: BertConfig, word_embedding_weight, device=None):
        super().__init__()
        with expected_device(device):
            self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.layer_norm = nn.LayerNorm(cfg.hidden_size)
            self.decoder_bias = self.create_parameter(
                [cfg.vocab_size], is_bias=True,
                device=word_embedding_weight.device)
            self.seq_relationship = nn.Linear(cfg.hidden_size, 2)
        # tied [V, H]: held outside the registry, so it is named once
        self._tied = [word_embedding_weight]

    @property
    def decoder_weight(self):
        return self._tied[0]

    def forward(self, sequence_output, pooled_output, masked_positions):
        b, s, h = sequence_output.shape
        offset = torch.arange(b, device=masked_positions.device)[:, None] * s
        idx = (masked_positions.long() + offset).reshape(-1)
        picked = sequence_output.reshape(b * s, h)[idx]
        x = self.layer_norm(F.gelu(self.transform(picked)))
        logits = matmul(x, self.decoder_weight, transpose_y=True) + \
            self.decoder_bias
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.bert = BertModel(cfg, device)
        self.heads = BertPretrainingHeads(
            cfg, self.bert.embeddings.word_embeddings.weight, device)

    def forward(self, input_ids, token_type_ids, masked_positions,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.heads(seq, pooled, masked_positions)


def bert_pretrain_loss_fn(model, input_ids, token_type_ids,
                          masked_positions, masked_labels, nsp_labels,
                          masked_weights=None):
    """Masked-LM plus next-sentence cross entropy, both in f32;
    ``masked_weights`` [B, P] (1 a real slot) weights the MLM mean."""
    mlm_logits, nsp_logits = model(input_ids, token_type_ids,
                                   masked_positions)
    mlm = F.cross_entropy(mlm_logits.float(), masked_labels.reshape(-1),
                          reduction="none")
    if masked_weights is not None:
        w = masked_weights.reshape(-1).float()
        mlm = (mlm.reshape(-1) * w).sum() / w.sum().clamp(min=1.0)
    else:
        mlm = mlm.mean()
    return mlm + F.cross_entropy(nsp_logits.float(), nsp_labels,
                                 reduction="mean")


class ErnieModel(BertModel):
    """ERNIE's encoder: this BERT trunk at ERNIE's vocabulary (18000) and
    513 positions."""

    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=513, type_vocab_size=2,
                 device=None, **kw):
        super().__init__(BertConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_layers=num_layers, num_heads=num_heads,
            intermediate_size=intermediate_size,
            max_position_embeddings=max_position_embeddings,
            type_vocab_size=type_vocab_size, **kw), device)
