"""Gaussian diffusion: coefficient tables and the samplers.

Counterpart of the sampling half of ``diffma_tpu/diffusion/gaussian.py``, for
the configuration DiffMa trains and samples with: the model predicts epsilon
and a learned-range variance (``learn_sigma``), which is the JAX package's
default. Tables are derived in float64 numpy and stored as float32 tensors on
the chosen device; only those the samplers read are kept, the ones the
training losses need come with training. Respacing carries a
``timestep_map``: the model is called with the original timesteps.

Noise is drawn from a caller-given ``torch.Generator``. The loops also take
``step_noise``, a sequence of per-step noise tensors, so a test can feed the
exact noise another implementation drew. The loops are Python loops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Set

import numpy as np
import torch

from diffma_tpu_torch.utils.device import resolve_device

__all__ = ["GaussianDiffusion", "get_named_beta_schedule", "space_timesteps"]


# ---------------------------------------------------------------------------
# Beta schedules
# ---------------------------------------------------------------------------


def _warmup_beta(beta_start, beta_end, num_steps, warmup_frac):
    betas = beta_end * np.ones(num_steps, dtype=np.float64)
    warmup_time = int(num_steps * warmup_frac)
    betas[:warmup_time] = np.linspace(beta_start, beta_end, warmup_time, dtype=np.float64)
    return betas


def get_beta_schedule(beta_schedule, *, beta_start, beta_end, num_diffusion_timesteps):
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    elif beta_schedule == "warmup10":
        betas = _warmup_beta(beta_start, beta_end, n, 0.1)
    elif beta_schedule == "warmup50":
        betas = _warmup_beta(beta_start, beta_end, n, 0.5)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(n, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (n,)
    return betas


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999):
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def get_named_beta_schedule(schedule_name, num_diffusion_timesteps):
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return get_beta_schedule(
            "linear",
            beta_start=scale * 0.0001,
            beta_end=scale * 0.02,
            num_diffusion_timesteps=num_diffusion_timesteps,
        )
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


# ---------------------------------------------------------------------------
# Timestep respacing
# ---------------------------------------------------------------------------


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {num_timesteps} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur))
            cur += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients, broadcast over the trailing dims."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


ModelFn = Callable[..., torch.Tensor]


# ---------------------------------------------------------------------------
# The diffusion process
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Coefficient tables (float32 tensors, derived in float64) + behaviour."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: Optional[torch.Tensor]  # respacing (None => identity)

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(
        betas: np.ndarray,
        timestep_map: Optional[Sequence[int]] = None,
        device="cuda",
    ) -> "GaussianDiffusion":
        device = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = (
            np.log(np.append(post_var[1], post_var[1:]))
            if len(post_var) > 1
            else np.array([])
        )
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return GaussianDiffusion(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_logvar),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            log_betas=f32(np.log(betas)),
            timestep_map=(
                torch.as_tensor(list(timestep_map), dtype=torch.long, device=device)
                if timestep_map is not None
                else None
            ),
        )

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def _map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced step index -> the original timestep the model was trained on."""
        return t if self.timestep_map is None else self.timestep_map[t]

    # -- q and p distributions -------------------------------------------------

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (
            _extract(self.posterior_mean_coef1, t, nd) * x_start
            + _extract(self.posterior_mean_coef2, t, nd) * x_t
        )
        variance = _extract(self.posterior_variance, t, nd)
        log_variance = _extract(self.posterior_log_variance_clipped, t, nd)
        return mean, variance, log_variance

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)

    def p_mean_variance(
        self,
        model: ModelFn,
        x,
        t,
        clip_denoised: bool = True,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Statistics of p(x_{t-1} | x_t); ``model`` gets the remapped
        timesteps and returns [eps, v] on the channel axis, where v places the
        log-variance between the posterior's and beta's."""
        model_output = model(x, self._map_t(t), **(model_kwargs or {}))
        nd = x.ndim
        eps, model_var_values = model_output.chunk(2, dim=1)
        min_log = _extract(self.posterior_log_variance_clipped, t, nd)
        max_log = _extract(self.log_betas, t, nd)
        frac = (model_var_values + 1) / 2
        model_log_variance = frac * max_log + (1 - frac) * min_log

        pred_xstart = self._predict_xstart_from_eps(x, t, eps)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": torch.exp(model_log_variance),
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    # -- sampling ------------------------------------------------------------

    @staticmethod
    def _draw(x, generator, step_noise, i):
        if step_noise is not None:
            return step_noise[i].to(device=x.device, dtype=x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    @staticmethod
    def _init_noise(shape, generator, noise):
        if noise is not None:
            return noise
        if generator is None:
            raise ValueError("a sampling loop needs its start noise or a generator")
        return torch.randn(shape, generator=generator, device=generator.device)

    def p_sample(self, model, x, t, noise, clip_denoised=True, model_kwargs=None):
        out = self.p_mean_variance(
            model, x, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs,
        )
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @torch.no_grad()
    def p_sample_loop(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Ancestral sampler: T steps from t = T-1 down to 0."""
        img = self._init_noise(shape, generator, noise)
        T = self.num_timesteps
        for i in range(T):
            t = torch.full((shape[0],), T - 1 - i, dtype=torch.long, device=img.device)
            img = self.p_sample(
                model, img, t, self._draw(img, generator, step_noise, i),
                clip_denoised=clip_denoised, model_kwargs=model_kwargs,
            )["sample"]
        return img

    def ddim_sample(self, model, x, t, noise, clip_denoised=True, model_kwargs=None,
                    eta=0.0):
        out = self.p_mean_variance(
            model, x, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs,
        )
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
        )
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
        sample = mean_pred + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @torch.no_grad()
    def ddim_sample_loop(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None, eta=0.0,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        img = self._init_noise(shape, generator, noise)
        T = self.num_timesteps
        for i in range(T):
            t = torch.full((shape[0],), T - 1 - i, dtype=torch.long, device=img.device)
            img = self.ddim_sample(
                model, img, t, self._draw(img, generator, step_noise, i),
                clip_denoised=clip_denoised, model_kwargs=model_kwargs, eta=eta,
            )["sample"]
        return img
