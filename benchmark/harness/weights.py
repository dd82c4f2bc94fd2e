"""Seeded random weights, made on the device in one draw.

The benchmark makes every weight itself from ``--seed`` and hands the same
tensors to the program (loaded by its parameter names) and to the plain
reference. One call draws U[0, 1) numbers for all the leaves; each leaf's
rule maps its slice to the leaf's distribution. The same seed gives the same
bits, so the reference's copy is made again after the window instead of
being held through it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

__all__ = ["denoiser_rule", "generator", "make", "vae_rule"]

Shapes = Dict[str, Tuple[int, ...]]

#: Streams drawn from one --seed: weights of the denoiser, of the VAE, and the data.
SALT = {"denoiser": 0, "vae": 1, "data": 2, "probe": 3}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed``."""
    value = (int(seed) * 1_000_003 + SALT[stream]) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(value)


def make(shapes: Shapes, rule: Callable, seed: int, stream: str, device) -> Dict[str, torch.Tensor]:
    """fp32 weights of ``shapes`` (name -> shape) on ``device``."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=generator(seed, stream, device), device=device)
    out = {}
    for (name, shape), u in zip(shapes.items(), flat.split(sizes)):
        out[name] = rule(name, tuple(shape), u.view(shape))
    return out


def _sym(u):
    return 2.0 * u - 1.0


def denoiser_rule(name: str, shape, u: torch.Tensor) -> torch.Tensor:
    """DiffMa's leaves: xavier-uniform matrices (fan_out the first dim),
    the mixers' conv at +-1/sqrt(taps), Mamba-1's A_log = log(1..n) as
    mamba_ssm sets it, Mamba-2's A_log = log U(1, 16), dt biases the
    softplus inverse of a log-uniform dt in [1e-3, 1e-1], D in [0.8, 1.2],
    norm scales in [0.9, 1.1], other biases in [-0.1, 0.1]. Nothing is
    zero, so every block and both mixers carry the signal and the gradient."""
    if name.endswith("A_log"):
        if len(shape) == 2:
            n = shape[1]
            return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=u.device)
                             ).expand(shape).contiguous()
        return torch.log(1.0 + 15.0 * u)
    if name.endswith("dt_proj.bias") or name.endswith("dt_bias"):
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith(".D"):
        return 0.8 + 0.4 * u
    if "conv1d" in name:
        return _sym(u) / math.sqrt(shape[-1] if len(shape) == 3 else 4)
    if len(shape) >= 2:
        fan_out = shape[0]
        fan_in = math.prod(shape) // fan_out
        return _sym(u) * math.sqrt(6.0 / (fan_in + fan_out))
    if name.endswith("weight"):  # LayerNorm and RMSNorm scales
        return 0.9 + 0.2 * u
    return 0.1 * _sym(u)


def vae_rule(name: str, shape, u: torch.Tensor) -> torch.Tensor:
    """The SD-VAE's leaves at the scale of the port's own random init
    (LeCun: variance 1 / fan_in), drawn uniform; GroupNorm scales in
    [0.9, 1.1], biases in [-0.02, 0.02]."""
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return _sym(u) * math.sqrt(3.0 / fan_in)
    if name.endswith("weight"):
        return 0.9 + 0.2 * u
    return 0.02 * _sym(u)
