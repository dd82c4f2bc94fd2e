"""Training-side helpers needed by sampling.

Counterpart of ``diffma_tpu/train/train.py::synthetic_batch``. The training
loop comes with the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["synthetic_batch"]


def synthetic_batch(generator: torch.Generator, batch_size: int, latent: int,
                    tokens: int, dim: int = 512):
    """Random latents and conditioning shaped like the real ones, drawn on
    the generator's device."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    return {
        "z": normal(batch_size, 4, latent, latent),
        "y": normal(batch_size, dim),
        "y2": normal(batch_size, tokens, dim),
        "w": torch.sigmoid(normal(batch_size, tokens, 1)),
    }
