"""The SD-VAE decoder in plain PyTorch, over a dict of weights by name.

Frozen from ``diffma_tpu_torch/models/vae.py``'s decoder at commit 8e06284,
which is Stable Diffusion's AutoencoderKL decoder with diffusers' key names:
``post_quant_conv``, conv_in, a mid block (ResNet, single-head attention
over all pixels, ResNet), ``len(ch_mult)`` up levels of 3 ResNet blocks
each, all but the last ending in 2x nearest upsampling and a conv, then
GroupNorm(32, eps 1e-6), SiLU and conv_out. Products and convolutions go
through ``Products``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.products import Products

__all__ = ["decode"]


def _gn(x, w, b):
    return F.group_norm(x, 32, w, b, eps=1e-6)


def _conv(P, W, pre, x, padding=1):
    return P.conv2d(x, W[pre + ".weight"], W[pre + ".bias"], padding=padding)


def _resnet(P, W, pre, x):
    def norm(v, k):
        return F.silu(_gn(v, W[f"{pre}.norm{k}.weight"], W[f"{pre}.norm{k}.bias"]))

    h = _conv(P, W, pre + ".conv2", norm(_conv(P, W, pre + ".conv1", norm(x, 1)), 2))
    if pre + ".conv_shortcut.weight" in W:
        x = _conv(P, W, pre + ".conv_shortcut", x, padding=0)
    return x + h


def _attention(P, W, pre, x):
    N, C, H, Wd = x.shape
    h = _gn(x, W[pre + ".group_norm.weight"], W[pre + ".group_norm.bias"])
    h = h.reshape(N, C, H * Wd).transpose(1, 2)
    q, k, v = (P.linear(h, W[f"{pre}.to_{s}.weight"], W[f"{pre}.to_{s}.bias"]) for s in "qkv")
    att = torch.softmax(P.matmul(q, k.transpose(1, 2).contiguous()) / math.sqrt(C), dim=-1)
    h = P.linear(P.matmul(att, v), W[pre + ".to_out.0.weight"], W[pre + ".to_out.0.bias"])
    return x + h.transpose(1, 2).reshape(N, C, H, Wd)


def decode(W: Dict[str, torch.Tensor], z: torch.Tensor, products: Products) -> torch.Tensor:
    """Latents z (N, 4, h, w), already divided by the SD scale -> images (N, 3, 8h, 8w)."""
    P = products
    h = P.conv2d(z, W["post_quant_conv.weight"], W["post_quant_conv.bias"])
    h = _conv(P, W, "decoder.conv_in", h)
    m = "decoder.mid_block"
    h = _resnet(P, W, m + ".resnets.1", _attention(P, W, m + ".attentions.0",
                                                   _resnet(P, W, m + ".resnets.0", h)))
    level = 0
    while f"decoder.up_blocks.{level}.resnets.0.conv1.weight" in W:
        pre = f"decoder.up_blocks.{level}"
        for b in range(3):
            h = _resnet(P, W, f"{pre}.resnets.{b}", h)
        if f"{pre}.upsamplers.0.conv.weight" in W:
            h = _conv(P, W, pre + ".upsamplers.0.conv", F.interpolate(h, scale_factor=2.0,
                                                                    mode="nearest"))
        level += 1
    h = F.silu(_gn(h, W["decoder.conv_norm_out.weight"], W["decoder.conv_norm_out.bias"]))
    return _conv(P, W, "decoder.conv_out", h)
