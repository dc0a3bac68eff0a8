"""The Vision Transformer (counterpart: paddle_tpu/vision/models/vit.py):
a stride-P patch-embed conv, the [CLS] token and position embeddings, a
pre-norm GELU `nn.TransformerEncoder` and a linear head.  Its unmasked
self-attention goes through ``F.scaled_dot_product_attention``, which
on the card is ``flash_attention_fwd``: kernel K3 forward and K4
backward."""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["VisionTransformer", "vit_b_16", "vit_l_16", "vit_s_16"]


class VisionTransformer(nn.Layer):
    def __init__(self, image_size=224, patch_size=16, in_channels=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.1, attention_dropout=0.0):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.num_patches = (image_size // patch_size) ** 2
        self.embed_dim = embed_dim
        self.patch_embed = nn.Conv2D(in_channels, embed_dim,
                                     kernel_size=patch_size,
                                     stride=patch_size)
        self.cls_token = self.create_parameter(
            [1, 1, embed_dim],
            default_initializer=nn.initializer.Normal(0.0, 0.02))
        self.pos_embed = self.create_parameter(
            [1, self.num_patches + 1, embed_dim],
            default_initializer=nn.initializer.Normal(0.0, 0.02))
        self.pos_drop = nn.Dropout(dropout)
        layer = nn.TransformerEncoderLayer(
            embed_dim, num_heads, int(embed_dim * mlp_ratio),
            dropout=dropout, activation="gelu",
            attn_dropout=attention_dropout, normalize_before=True)
        self.encoder = nn.TransformerEncoder(layer, depth,
                                             norm=nn.LayerNorm(embed_dim))
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, x):
        b = x.shape[0]
        patches = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, N, D]
        cls = self.cls_token.expand(b, 1, self.embed_dim)
        seq = torch.cat([cls.to(patches.dtype), patches], dim=1) \
            + self.pos_embed
        seq = self.encoder(self.pos_drop(seq))
        return self.head(seq[:, 0])


def vit_s_16(num_classes=1000, **kw):
    return VisionTransformer(embed_dim=384, depth=12, num_heads=6,
                             num_classes=num_classes, **kw)


def vit_b_16(num_classes=1000, **kw):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12,
                             num_classes=num_classes, **kw)


def vit_l_16(num_classes=1000, **kw):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16,
                             num_classes=num_classes, **kw)
