"""Gaussian diffusion: coefficient tables, the samplers and the hybrid loss.

Counterpart of ``diffma_tpu/diffusion/gaussian.py`` for the configuration
DiffMa trains and samples with: the model predicts epsilon and a
learned-range variance (``learn_sigma``), which is the JAX package's default.
The loss is the JAX package's ``LossType``: ``"mse"`` (MSE + VB, the
default), ``"rescaled_mse"`` (the VB term times T / 1000) or ``"rescaled_kl"``
(VB alone, times T). Tables are derived in float64 numpy and stored as
float32 tensors on the chosen device. Respacing carries a ``timestep_map``:
the model is called with the original timesteps.

Noise is drawn from a caller-given ``torch.Generator``. The loops also take
``step_noise``, a sequence of per-step noise tensors, and
``training_losses`` takes ``noise``, so a test can feed the exact noise
another implementation drew. The loops are Python loops; given a
``ChainGraph`` they run on the card as a CUDA graph of one step, replayed
once per step, as the JAX package runs its chain as one ``lax.scan``. The
graphed chain draws its T step noises before the first replay, from the
same generator and in the eager loop's order (JAX draws each with
``fold_in(rng, i)``, in no order), so that it gives the eager loop's
images for a seed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Set

import numpy as np
import torch

from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.graphs import Graph

__all__ = [
    "LOSS_TYPES",
    "ChainGraph",
    "GaussianDiffusion",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "get_named_beta_schedule",
    "mean_flat",
    "normal_kl",
    "space_timesteps",
]

#: The JAX package's ``LossType`` values that a learned-range model trains with.
LOSS_TYPES = ("mse", "rescaled_mse", "rescaled_kl")


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


# ---------------------------------------------------------------------------
# Math utilities
# ---------------------------------------------------------------------------


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two gaussians, elementwise."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of x under a gaussian discretised to 8-bit bins in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta),
    )


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
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: Optional[torch.Tensor]  # respacing (None => identity)
    loss_type: str = "mse"

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(
        betas: np.ndarray,
        timestep_map: Optional[Sequence[int]] = None,
        device="cuda",
        loss_type: str = "mse",
    ) -> "GaussianDiffusion":
        device = resolve_device(device)
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type {loss_type!r}; expected one of {LOSS_TYPES}")
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
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
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
            loss_type=loss_type,
        )

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def _map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced step index -> the original timestep the model was trained on."""
        return t if self.timestep_map is None else self.timestep_map[t]

    # -- q and p distributions -------------------------------------------------

    def q_mean_variance(self, x_start, t):
        nd = x_start.ndim
        mean = _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
        variance = _extract(1.0 - self.alphas_cumprod, t, nd)
        log_variance = _extract(self.log_one_minus_alphas_cumprod, t, nd)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

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
        log-variance between the posterior's and beta's. ``model`` may also be
        that output itself, as the hybrid loss passes it."""
        if callable(model):
            model_output = model(x, self._map_t(t), **(model_kwargs or {}))
        else:
            model_output = model
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

    # -- losses ----------------------------------------------------------------

    def _vb_terms_bpd(self, model, x_start, x_t, t, clip_denoised=True, model_kwargs=None):
        """The variational bound's term at t in bits per dimension: the KL to
        the true posterior, or at t = 0 the discretised decoder NLL."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(
            model, x_t, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs
        )
        kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"]))
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl / math.log(2.0))
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(
        self, model: ModelFn, x_start, t, generator: Optional[torch.Generator] = None,
        model_kwargs=None, noise=None,
    ) -> Dict[str, torch.Tensor]:
        """Per-example terms of the hybrid loss at timesteps t: ``loss``, and
        ``mse`` and ``vb`` unless the loss is VB alone. The VB term sees the
        model's epsilon detached, so it trains the variance only."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = torch.randn(
                x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype
            )
        x_t = self.q_sample(x_start, t, noise)
        if self.loss_type == "rescaled_kl":
            vb = self._vb_terms_bpd(
                model, x_start, x_t, t, clip_denoised=False, model_kwargs=model_kwargs
            )["output"]
            return {"loss": vb * self.num_timesteps}

        model_output = model(x_t, self._map_t(t), **model_kwargs)
        eps_pred, var_values = model_output.chunk(2, dim=1)
        frozen = torch.cat([eps_pred.detach(), var_values], dim=1)
        vb = self._vb_terms_bpd(frozen, x_start, x_t, t, clip_denoised=False)["output"]
        if self.loss_type == "rescaled_mse":
            vb = vb * (self.num_timesteps / 1000.0)
        mse = mean_flat((noise - eps_pred) ** 2)
        return {"loss": mse + vb, "mse": mse, "vb": vb}

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

    def _chain(self, step, model, shape, generator, noise, model_kwargs, step_noise, graph):
        """``step(model, x, t, noise, model_kwargs)`` from t = T-1 down to 0."""
        img = self._init_noise(shape, generator, noise)
        T = self.num_timesteps
        if graph is None:
            for i in range(T):
                t = torch.full((shape[0],), T - 1 - i, dtype=torch.long, device=img.device)
                img = step(model, img, t, self._draw(img, generator, step_noise, i), model_kwargs)
            return img
        noises = [self._draw(img, generator, step_noise, i) for i in range(T)]
        return graph.run(functools.partial(step, model), img, noises, model_kwargs)

    @torch.no_grad()
    def p_sample_loop(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        graph: Optional["ChainGraph"] = None,
    ) -> torch.Tensor:
        """Ancestral sampler: T steps from t = T-1 down to 0; with ``graph``,
        its replays."""
        def step(model, x, t, noise, kw):
            return self.p_sample(model, x, t, noise, clip_denoised=clip_denoised,
                                 model_kwargs=kw)["sample"]

        return self._chain(step, model, shape, generator, noise, model_kwargs, step_noise, graph)

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
        graph: Optional["ChainGraph"] = None,
    ) -> torch.Tensor:
        def step(model, x, t, noise, kw):
            return self.ddim_sample(model, x, t, noise, clip_denoised=clip_denoised,
                                    model_kwargs=kw, eta=eta)["sample"]

        return self._chain(step, model, shape, generator, noise, model_kwargs, step_noise, graph)


class ChainGraph:
    """A sampling chain on the card as a CUDA graph of one step, replayed
    once per step with ``t`` and the step's noise in static buffers.

    One ``ChainGraph`` serves one model, one loop and one batch shape: the
    first chain runs its first step eagerly (the warm-up: kernel libraries,
    index tables), captures the step and replays it for the other steps;
    later chains replay it for every step, their start noise and
    conditioning copied into the graph's buffers. ``pool`` is the memory
    pool of the entry point's graphs. After a chain, ``graph.capture_seconds``
    and ``graph.pool_bytes`` say what the capture took."""

    def __init__(self, device, pool=None):
        self.graph = Graph(device, pool)
        self.x = self.t = self.noise = self.kwargs = None

    def run(self, step, img, noises, model_kwargs=None) -> torch.Tensor:
        """The chain from ``img`` with ``noises[i]`` at step i, ``step(x, t,
        noise, model_kwargs) -> x`` one step of it; returns the last x."""
        model_kwargs = model_kwargs or {}
        if self.x is None:
            self.x, self.noise = img.clone(), torch.empty_like(img)
            self.t = torch.empty((img.shape[0],), dtype=torch.long, device=img.device)
            self.kwargs = {k: v.clone() for k, v in model_kwargs.items()}
        else:
            if img.shape != self.x.shape or model_kwargs.keys() != self.kwargs.keys():
                raise ValueError(f"this graph samples {tuple(self.x.shape)} with "
                                 f"{sorted(self.kwargs)}, not {tuple(img.shape)} with "
                                 f"{sorted(model_kwargs)}")
            self.x.copy_(img)
            for k, v in model_kwargs.items():
                self.kwargs[k].copy_(v)

        def body():
            self.x.copy_(step(self.x, self.t, self.noise, self.kwargs))

        T = len(noises)
        for i, n in enumerate(noises):
            self.t.fill_(T - 1 - i)
            self.noise.copy_(n)
            if self.graph.graph is None:
                if i == 0:
                    self.graph.warm_up(body)
                    continue
                self.graph.capture(body)
            self.graph.replay()
        return self.x.clone()
