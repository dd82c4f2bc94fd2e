"""Stable-Diffusion VAE (AutoencoderKL): the encoder and the decoder.

Counterpart of ``diffma_tpu/models/vae.py``. The encoder: conv_in, down
levels of ResNet blocks each but the last ending in a stride-2 conv after an
asymmetric (0, 1) pad, mid ResNet / attention / ResNet, GroupNorm(32, eps
1e-6), SiLU, conv_out to the 8 moments, then ``quant_conv``; the posterior
is a diagonal Gaussian with ``logvar`` clipped to [-30, 20]. The decoder:
``post_quant_conv``, conv_in, mid blocks, up levels of ResNet blocks with 2x
nearest upsampling, GroupNorm, SiLU, conv_out. The layout is NCHW and the
key names are diffusers' (``encoder.down_blocks.{l}.resnets.{b}``,
``encoder.down_blocks.{l}.downsamplers.0.conv``, ``decoder.up_blocks``,
``mid_block.attentions.0.to_q``, ``quant_conv``), so a diffusers state dict
loads as it is.

The convs are plain ``torch.nn.functional.conv2d``: the JAX package leaves
them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AutoencoderKL", "DiagonalGaussian", "SD_VAE_SCALE"]

SD_VAE_SCALE = 0.18215


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over all pixels."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _group_norm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        h = self.group_norm(x).reshape(N, C, H * W).transpose(1, 2)  # (N, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), dim=-1)
        h = self.to_out[0](att @ v)
        return x + h.transpose(1, 2).reshape(N, C, H, W)


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_blocks: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_ch if b == 0 else out_ch, out_ch) for b in range(n_blocks)
        )
        self.downsamplers = nn.ModuleList([_Downsample(out_ch)] if downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d(x)
        return x


class Encoder(nn.Module):
    """RGB in, the 8 posterior moments out, 2 ResNet blocks per level."""

    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4)):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        block_in, blocks = ch, []
        for level, mult in enumerate(ch_mult):
            blocks.append(_DownBlock(block_in, ch * mult, 2, downsample=level != len(ch_mult) - 1))
            block_in = ch * mult
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(block_in)
        self.conv_norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 8, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for down in self.down_blocks:
            h = down(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class DiagonalGaussian:
    """The posterior of moments (N, 2z, h, w): mean, then logvar in [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_blocks: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_ch if b == 0 else out_ch, out_ch) for b in range(n_blocks)
        )
        self.upsamplers = nn.ModuleList([_Upsample(out_ch)] if upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class Decoder(nn.Module):
    """4 latent channels in, RGB out, 3 ResNet blocks per level."""

    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4)):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(4, block_in, 3, padding=1)
        self.mid_block = _MidBlock(block_in)
        # up_blocks[k] is level n-1-k: lowest resolution first, as in diffusers.
        n = len(ch_mult)
        blocks = []
        for k in range(n):
            out = ch * ch_mult[n - 1 - k]
            blocks.append(_UpBlock(block_in, out, 3, upsample=k != n - 1))
            block_in = out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for up in self.up_blocks:
            h = up(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """SD first-stage VAE: ``encode(x)`` with images x (N, 3, H, W) in [-1, 1]
    -> the posterior over latents (N, 4, H/8, W/8); ``decode(z)`` back. The
    encoder half (``encoder``, ``quant_conv``) is built with
    ``with_encoder``; a VAE that only decodes, as the sampler's on synthetic
    conditioning, holds the decoder half alone."""

    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), with_encoder: bool = False):
        super().__init__()
        # The decoder first, so that ``init_weights`` draws it alike with and
        # without the encoder.
        self.decoder = Decoder(ch, ch_mult)
        self.post_quant_conv = nn.Conv2d(4, 4, 1)
        if with_encoder:
            self.encoder = Encoder(ch, ch_mult)
            self.quant_conv = nn.Conv2d(8, 8, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        """Random weights drawn from ``generator`` at the scale of Flax's
        default LeCun init: N(0, 1/fan_in) weights, zero biases, unit
        GroupNorm scale."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def encode_sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      scale: float = SD_VAE_SCALE) -> torch.Tensor:
        """A latent drawn from the posterior, times ``scale``; ``noise`` (N, 4,
        H/8, W/8) replaces the draw from ``generator``."""
        return self.encode(x).sample(generator, noise) * scale

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
