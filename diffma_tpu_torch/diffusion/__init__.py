"""Diffusion process factory and timestep samplers.

Counterpart of ``diffma_tpu/diffusion/__init__.py::create_diffusion``.
"""

from __future__ import annotations

import numpy as np

from diffma_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    discretized_gaussian_log_likelihood,
    get_named_beta_schedule,
    mean_flat,
    normal_kl,
    space_timesteps,
)
from diffma_tpu_torch.diffusion.timestep_samplers import (
    LossAwareSampler,
    LossSecondMomentResampler,
    ScheduleSampler,
    UniformSampler,
    create_named_schedule_sampler,
)

__all__ = [
    "GaussianDiffusion",
    "LossAwareSampler",
    "LossSecondMomentResampler",
    "LossType",
    "ModelMeanType",
    "ModelVarType",
    "ScheduleSampler",
    "UniformSampler",
    "create_diffusion",
    "create_named_schedule_sampler",
    "discretized_gaussian_log_likelihood",
    "get_named_beta_schedule",
    "mean_flat",
    "normal_kl",
    "space_timesteps",
]


def create_diffusion(
    timestep_respacing,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    device="cuda",
) -> GaussianDiffusion:
    """The ``diffusion_steps`` schedule respaced to ``timestep_respacing``
    (e.g. "250", "ddim50"): the kept steps' betas are rebuilt from their
    alphas_cumprod. The defaults are DiffMa's: epsilon prediction, a
    learned-range variance and the hybrid MSE + VB loss. ``predict_xstart``
    predicts x_0; without ``learn_sigma`` the variance is fixed, the
    posterior's with ``sigma_small``, else beta; ``use_kl`` trains on the
    rescaled VB alone, ``rescale_learned_sigmas`` rescales the VB term."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]

    mean_type = ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON
    var_type = (
        ModelVarType.LEARNED_RANGE
        if learn_sigma
        else (ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE)
    )

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
        model_mean_type=mean_type,
        model_var_type=var_type,
        loss_type=loss_type,
        timestep_map=None if identity_map else timestep_map,
        original_num_steps=diffusion_steps,
        device=device,
    )
