"""The CT conditioning encoder and the BEiT-style patch embedding it wraps.

Counterpart of ``diffma_tpu/models/ct_encoder.py`` (upstream's
``block/CT_encoder.py`` and ``block/visionEmbedding.py``). The encoder
patch-embeds the 4-channel VAE latent of a CT slice and gives every token a
soft weight from one token MLP over the avg- and max-pooled features:

    x      = VisionEmbedding(latent)                 # (N, T, D)
    weight = sigmoid(fc(avg_D(x)) + fc(max_D(x)))    # (N, T, 1)
    tokens = LayerNorm(x * weight), eps 1e-5         # (N, T, D)

The pools run over the embedding dim D and ``fc`` over the token axis T,
with a hidden width of ``int(T / 14)``. The key names are upstream's
(``vision_embedding.proj``, ``vision_embedding.mask_token``, ``fc.0``,
``fc.2``, ``norm``), so a reference CT-encoder checkpoint loads as it is;
the patch vector flattens as (C, kh, kw), the Conv2d weight's layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diffma_tpu_torch.models.layers import PatchEmbed
from diffma_tpu_torch.ops.norm import layer_norm

__all__ = ["CTEncoder", "VisionEmbedding"]


class VisionEmbedding(PatchEmbed):
    """Patchify, with the mask token where ``masked_position`` is 1 and an
    optional CLS token in front: (N, C, H, W) -> (N, T (+1), D)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, contain_mask_token: bool = False,
                 prepend_cls_token: bool = False):
        super().__init__(patch_size, in_chans, embed_dim)
        self.img_size = img_size
        self.num_patches = (img_size // patch_size) ** 2
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if contain_mask_token else None
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if prepend_cls_token else None

    def forward(self, x: torch.Tensor,
                masked_position: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.shape[-2:] != (self.img_size, self.img_size):
            raise ValueError(f"expected {self.img_size}x{self.img_size} inputs, got {x.shape}")
        x = super().forward(x)
        if self.mask_token is not None and masked_position is not None:
            w = masked_position[..., None].to(x.dtype)
            x = x * (1 - w) + self.mask_token.to(x.dtype) * w
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        return x


class CTEncoder(nn.Module):
    """Per-token soft-mask encoder: latent (N, 4, s, s) -> (weight (N, T, 1),
    tokens (N, T, D))."""

    def __init__(self, img_size: int = 28, patch_size: int = 2, in_channels: int = 4,
                 embed_dim: int = 1024, contain_mask_token: bool = True,
                 reduction_ratio: int = 14):
        super().__init__()
        tokens = (img_size // patch_size) ** 2
        self.vision_embedding = VisionEmbedding(img_size, patch_size, in_channels, embed_dim,
                                                contain_mask_token=contain_mask_token)
        hidden = int(tokens / reduction_ratio)
        self.fc = nn.Sequential(nn.Linear(tokens, hidden), nn.ReLU(), nn.Linear(hidden, tokens))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CTEncoder":
        """Random weights from ``generator``: Xavier-uniform products, zero
        biases and mask token, unit LayerNorm scale."""
        for m in (self.vision_embedding.proj, self.fc[0], self.fc[2]):
            fan_out, fan_in = m.weight.shape[0], math.prod(m.weight.shape[1:])
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        if self.vision_embedding.mask_token is not None:
            self.vision_embedding.mask_token.zero_()
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        return self

    def forward(self, x: torch.Tensor):
        x = self.vision_embedding(x)
        avg_out = self.fc(x.mean(dim=-1))  # pool over D, MLP over T
        max_out = self.fc(x.amax(dim=-1))
        weight = torch.sigmoid(avg_out + max_out)[..., None]
        return weight, layer_norm(x * weight, self.norm.weight, self.norm.bias, eps=1e-5)
