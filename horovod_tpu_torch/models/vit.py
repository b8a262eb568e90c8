"""Vision Transformer — the port of ``horovod_tpu/models/vit.py``.

A VALID stride-``patch_size`` conv embeds the patches, a learned ``cls``
token (zeros at init) is prepended, ``pos_embed`` (N(0, 0.02²)) is added,
and the BERT :class:`~.bert.TransformerLayer` stack runs over the tokens
without a mask, through ``attend_fn`` (default: the flash kernels on the
card). The head is a dense layer on the CLS token, cast to fp32. Images
are NCHW (``(B, 3, H, W)``; the JAX model takes NHWC); H and W are the
``image_size`` given at construction, since ``pos_embed`` has one row
per patch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._layers import LN_EPS, Conv2d, dense, init_weights, layer_norm
from .bert import AttendFn, TransformerLayer


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.bfloat16,
                 attend_fn: Optional[AttendFn] = None,
                 image_size: int = 224, in_channels: int = 3):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(
                f"image size {image_size} not divisible by patch_size "
                f"{patch_size}; SAME-padding a partial patch would "
                "silently change the geometry")
        self.patch_size = patch_size
        self.hidden = hidden
        self.num_layers = num_layers
        self.image_size = image_size
        self.dtype = dtype
        self.attend_fn = attend_fn
        self.patch_embed = Conv2d(in_channels, hidden, patch_size,
                                  patch_size, "VALID", dtype=dtype)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden))
        self.layers = nn.ModuleList(
            TransformerLayer(hidden, num_heads, mlp_dim, dtype)
            for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(hidden, eps=LN_EPS)
        self.head = nn.Linear(hidden, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViT":
        """Seeded random weights in flax's initializer scales."""
        init_weights(self, generator)
        self.cls.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, _, h, w = images.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"ViT built for {self.image_size}x"
                             f"{self.image_size} images, got {h}x{w}")
        x = self.patch_embed(images.to(self.dtype))
        x = x.flatten(2).transpose(1, 2)               # (B, N patches, H)
        cls = self.cls.to(self.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for layer in self.layers:
            x = layer(x, None, self.attend_fn)
        x = layer_norm(self.final_ln, x, self.dtype)
        return dense(self.head, x[:, 0], self.dtype).to(torch.float32)


def vit_base(**kw) -> ViT:
    """ViT-B/16 geometry (~86M params)."""
    return ViT(**kw)


def vit_tiny(**kw) -> ViT:
    """Test-sized ViT: 32x32 images in 8x8 patches (17 tokens)."""
    for k, v in (("patch_size", 8), ("hidden", 32), ("num_layers", 2),
                 ("num_heads", 4), ("mlp_dim", 64), ("num_classes", 10),
                 ("dtype", torch.float32), ("image_size", 32)):
        kw.setdefault(k, v)
    return ViT(**kw)
