"""Embedding and head layers of the DiffMa model.

Counterpart of ``diffma_tpu/models/layers.py``. Parameter names follow the
upstream DiffMa state dict (``x_embedder.proj``, ``t_embedder.mlp.{0,2}``,
``final_layer.{linear, adaLN_modulation.1}``).

* ``PatchEmbed``: non-overlapping patchify. The weight is a Conv2d kernel
  (D, C, p, p); it is applied as one matmul on channel-major patch vectors,
  which is the same product.
* ``TimestepEmbed``: 256 sinusoidal features (cos, then sin) and a 2-layer MLP.
* ``FinalLayer``: LayerNorm (eps 1e-6, no affine), adaLN modulation, linear.
* ``get_2d_sincos_pos_embed``: the fixed position table, in numpy.

Each takes the compute dtype ``dtype``, as its Flax module does: the
parameters stay fp32 and every product runs in ``dtype`` (``dense``), with
the timestep frequencies in fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.ops.norm import layer_norm

__all__ = [
    "dense",
    "PatchEmbed",
    "TimestepEmbed",
    "FinalLayer",
    "get_2d_sincos_pos_embed",
    "modulate",
]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``, as Flax's ``nn.Dense(dtype=...)``: the
    input and the fp32 weight and bias cast to ``dtype`` at the call."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift, per sample."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid*grid, embed_dim) fixed sin-cos table."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first, as upstream
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class PatchEmbed(nn.Module):
    """(N, C, H, W) -> (N, T, D) patch tokens."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} is not a multiple of patch {p}")
        gh, gw = H // p, W // p
        # (N, C, gh, p, gw, p) -> (N, gh, gw, C, p, p): channel-major patch
        # vector, the layout of the Conv2d weight (out, in, kh, kw).
        x = x.reshape(N, C, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(N, gh * gw, C * p * p)
        w = self.proj.weight.reshape(self.proj.out_channels, -1).to(self.dtype)
        return F.linear(x.to(self.dtype), w, self.proj.bias.to(self.dtype))


class TimestepEmbed(nn.Module):
    """Sinusoidal timestep features and an MLP: (N,) -> (N, D)."""

    def __init__(self, hidden_size: int, freq_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freq_size = freq_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            nn.Linear(freq_size, hidden_size),
            nn.SiLU(),
            nn.Linear(hidden_size, hidden_size),
        )

    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
        half = dim // 2
        freqs = torch.exp(
            -math.log(max_period)
            * torch.arange(half, dtype=torch.float32, device=t.device)
            / half
        )
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = dense(self.mlp[0], self.timestep_embedding(t, self.freq_size), self.dtype)
        return dense(self.mlp[2], F.silu(h), self.dtype)


class FinalLayer(nn.Module):
    """adaLN-modulated linear head; c is (N, 2D)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(2 * hidden_size, 2 * hidden_size)
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        mod = dense(self.adaLN_modulation[1], F.silu(c.to(self.dtype)), self.dtype)
        shift, scale = mod.chunk(2, dim=-1)
        return dense(self.linear, modulate(layer_norm(x, eps=1e-6), shift, scale), self.dtype)
