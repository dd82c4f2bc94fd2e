"""BiomedCLIP's image tower: a ViT-B/16 with a 512-wide projection head.

Counterpart of ``diffma_tpu/models/clip_vit.py``: patch 16, width 768, 12
pre-LN blocks (LayerNorm eps 1e-6) of 12 heads with the softmax in fp32 and
an exact-GELU MLP, CLS pooling, and a head without bias. The key names are
timm's and open_clip's trunk (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1``, ``.attn.qkv``, ``.attn.proj``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``norm``) and ``head``. The
attention and the products are plain torch operators written as the JAX
module writes them: the JAX package leaves them to XLA, not to a Pallas
kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.models.layers import PatchEmbed

__all__ = ["VisionTransformer", "biomedclip_vit_b16"]


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.heads
        q, k, v = self.qkv(x).reshape(B, L, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", att, v).transpose(1, 2).reshape(B, L, D)
        return self.proj(o)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """(N, 3, img, img) images -> (N, output_dim) CLS embeddings."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, width: int = 768,
                 depth: int = 12, heads: int = 12, output_dim: int = 512):
        super().__init__()
        tokens = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, 3, width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, width))
        self.blocks = nn.ModuleList(_Block(width, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.head = nn.Linear(width, output_dim, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """Random weights from ``generator``: products N(0, 1/fan_in), zero
        biases, CLS token and position table N(0, 0.02^2), unit LayerNorm
        scale."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x)[:, 0])


def biomedclip_vit_b16(img_size: int = 224) -> VisionTransformer:
    return VisionTransformer(img_size=img_size, patch_size=16, width=768, depth=12, heads=12,
                             output_dim=512)
