"""The inputs' draws, in the order the trainer and the sampler make them.

Frozen from ``diffma_tpu_torch/train/train.py`` at commit 8e06284
(``synthetic_batch`` and ``loss_draws``) and the DDPM loop's noise draws
(``diffusion/gaussian.py::_chain``): the reference makes every input again
from the generator state the harness saved before the program drew it, and
so never reads an input that the program made.
"""

from __future__ import annotations

import torch

__all__ = ["chain_draws", "loss_draws", "synthetic_batch"]


def synthetic_batch(gen: torch.Generator, batch: int, latent: int, tokens: int, dim: int) -> dict:
    """z (B, 4, l, l), y (B, D), y2 (B, T, D), w = sigmoid(N) (B, T, 1)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    return {"z": normal(batch, 4, latent, latent), "y": normal(batch, dim),
            "y2": normal(batch, tokens, dim), "w": torch.sigmoid(normal(batch, tokens, 1))}


def loss_draws(gen: torch.Generator, z: torch.Tensor, num_timesteps: int):
    """The loss's timesteps t (B,) and noise, after the batch."""
    t = torch.randint(0, num_timesteps, z.shape[:1], generator=gen, device=z.device)
    return t, torch.randn(z.shape, generator=gen, device=z.device, dtype=z.dtype)


def chain_draws(gen: torch.Generator, batch: int, latent: int, tokens: int, dim: int,
                steps: int):
    """A sampling request's draws: the start noise z, then the synthetic
    conditioning, then each step's noise for t = T-1 down to 0. Returns
    (z, conditioning, noises) with ``noises[t]`` the noise of step t."""
    z = torch.randn((batch, 4, latent, latent), generator=gen, device=gen.device)
    cond = synthetic_batch(gen, batch, latent, tokens, dim)
    cond.pop("z")
    noises = [torch.randn(z.shape, generator=gen, device=gen.device) for _ in range(steps)]
    return z, cond, noises[::-1]
