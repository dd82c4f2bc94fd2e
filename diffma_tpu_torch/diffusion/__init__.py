"""Diffusion process factory.

Counterpart of ``diffma_tpu/diffusion/__init__.py::create_diffusion``.
"""

from __future__ import annotations

import numpy as np

from diffma_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    get_named_beta_schedule,
    space_timesteps,
)

__all__ = ["create_diffusion", "GaussianDiffusion", "space_timesteps"]


def create_diffusion(
    timestep_respacing,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    device="cuda",
) -> GaussianDiffusion:
    """The 1000-step schedule respaced to ``timestep_respacing`` (e.g. "250",
    "ddim50"): the kept steps' betas are rebuilt from their alphas_cumprod.
    The loss is the hybrid MSE + VB unless ``use_kl`` (VB alone, rescaled)
    or ``rescale_learned_sigmas`` (the VB term rescaled)."""
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]

    use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
    base_alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    last = 1.0
    new_betas, timestep_map = [], []
    for i, acp in enumerate(base_alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - acp / last)
            last = acp
            timestep_map.append(i)

    identity_map = timestep_map == list(range(diffusion_steps))
    return GaussianDiffusion.create(
        betas=np.array(new_betas),
        timestep_map=None if identity_map else timestep_map,
        device=device,
        loss_type=loss_type,
    )
