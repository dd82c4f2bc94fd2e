"""Gaussian diffusion: coefficient tables, the samplers, the losses and the bound.

Counterpart of ``diffma_tpu/diffusion/gaussian.py``, with its types: the
model predicts epsilon, x_0 or x_{t-1} (``ModelMeanType``), its variance is
learned (``LEARNED``: the log-variance; ``LEARNED_RANGE``: a value placing it
between the posterior's and beta's, DiffMa's default) or fixed
(``FIXED_SMALL``: the posterior's; ``FIXED_LARGE``: beta, but at t = 0 the
posterior's at t = 1), and the loss is ``LossType``'s MSE, rescaled MSE, KL
or rescaled KL. Tables are derived in float64 numpy and stored as float32
tensors on the chosen device.
Respacing carries a ``timestep_map``: the model and ``cond_fn`` are called
with the original timesteps.

Noise is drawn from a caller-given ``torch.Generator`` where JAX takes a
key. The loops also take ``step_noise``, a sequence of per-step noise
tensors, ``training_losses`` takes ``noise`` and ``calc_bpd_loop`` the noise
of every step, so a test can feed the exact noise another implementation
drew. The loops are Python loops; given a ``ChainGraph`` they run on the
card as a CUDA graph of one step, replayed once per step, as the JAX
package runs its chain as one ``lax.scan``. The graphed chain draws its T
step noises before the first replay, from the same generator and in the
eager loop's order (JAX draws each with ``fold_in(rng, i)``, in no order),
so that it gives the eager loop's images for a seed. A chain guided by
``cond_fn`` or mapped by ``denoised_fn``, the progressive loops (Python
generators, one dict a step, where JAX stacks them), ``ddim_reverse_sample``
and ``calc_bpd_loop`` run eagerly.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Set

import numpy as np
import torch

from diffma_tpu_torch.utils import trace
from diffma_tpu_torch.utils.device import resolve_device
from diffma_tpu_torch.utils.graphs import Graph

__all__ = [
    "ChainGraph",
    "GaussianDiffusion",
    "LossType",
    "ModelMeanType",
    "ModelVarType",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "get_named_beta_schedule",
    "mean_flat",
    "normal_kl",
    "space_timesteps",
]

class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


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
    alphas_cumprod_next: torch.Tensor
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
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: Optional[torch.Tensor]  # respacing (None => identity)
    model_mean_type: ModelMeanType = ModelMeanType.EPSILON
    model_var_type: ModelVarType = ModelVarType.LEARNED_RANGE
    loss_type: LossType = LossType.MSE
    original_num_steps: int = 1000

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(
        betas: np.ndarray,
        model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
        model_var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
        loss_type: LossType = LossType.MSE,
        timestep_map: Optional[Sequence[int]] = None,
        original_num_steps: Optional[int] = None,
        device="cuda",
    ) -> "GaussianDiffusion":
        device = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = (
            np.log(np.append(post_var[1], post_var[1:]))
            if len(post_var) > 1
            else np.array([])
        )
        fl_var = np.append(post_var[1], betas[1:])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return GaussianDiffusion(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
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
            fixed_large_variance=f32(fl_var),
            fixed_large_log_variance=f32(np.log(fl_var)),
            timestep_map=(
                torch.as_tensor(list(timestep_map), dtype=torch.long, device=device)
                if timestep_map is not None
                else None
            ),
            model_mean_type=ModelMeanType(model_mean_type),
            model_var_type=ModelVarType(model_var_type),
            loss_type=LossType(loss_type),
            original_num_steps=original_num_steps or len(betas),
        )

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def _map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced step index -> the original timestep the model was trained on."""
        return t if self.timestep_map is None else self.timestep_map[t]

    # -- q distributions -------------------------------------------------------

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

    # -- p distributions -------------------------------------------------------

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

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        c1 = _extract(1.0 / self.posterior_mean_coef1, t, nd)
        c2 = _extract(self.posterior_mean_coef2 / self.posterior_mean_coef1, t, nd)
        return c1 * xprev - c2 * x_t

    def p_mean_variance(
        self,
        model: ModelFn,
        x,
        t,
        clip_denoised: bool = True,
        denoised_fn: Optional[Callable] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Statistics of p(x_{t-1} | x_t). ``model`` gets the remapped
        timesteps; a learned variance (``LEARNED``, ``LEARNED_RANGE``) makes
        it return twice x's channels, the prediction then the variance's
        values. ``model`` may also be that output itself, as the hybrid loss
        passes it. ``denoised_fn`` maps the predicted x_0 before the clip."""
        if callable(model):
            model_output = model(x, self._map_t(t), **(model_kwargs or {}))
        else:
            model_output = model
        nd = x.ndim

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t, nd)
                max_log = _extract(self.log_betas, t, nd)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = _extract(self.fixed_large_variance, t, nd)
            model_log_variance = _extract(self.fixed_large_log_variance, t, nd)
        else:  # FIXED_SMALL
            model_variance = _extract(self.posterior_variance, t, nd)
            model_log_variance = _extract(self.posterior_log_variance_clipped, t, nd)

        if self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = model_output
        elif self.model_mean_type == ModelMeanType.EPSILON:
            pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        else:  # PREVIOUS_X
            pred_xstart = self._predict_xstart_from_xprev(x, t, model_output)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    # -- guidance ------------------------------------------------------------

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """The posterior mean shifted by ``variance * cond_fn(x, t)``, where
        ``cond_fn`` gives the gradient of log p(y | x) and gets the remapped
        timesteps. The loops run under ``torch.no_grad``: a ``cond_fn`` that
        differentiates turns grad mode on itself (``torch.enable_grad``)."""
        gradient = cond_fn(x, self._map_t(t), **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """Condition the score instead of the mean: eps shifted by
        ``-sqrt(1 - alphabar) * cond_fn(x, t)``, then pred_xstart and the
        posterior mean derived again from it."""
        nd = x.ndim
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(
            x, self._map_t(t), **(model_kwargs or {})
        )
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # -- sampling ------------------------------------------------------------

    @staticmethod
    def _draw(x, generator, step_noise=None, i=0):
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

    def p_sample(self, model, x, t, generator: Optional[torch.Generator] = None,
                 clip_denoised=True, denoised_fn=None, cond_fn=None, model_kwargs=None,
                 noise=None):
        """One ancestral step from x_t; its noise is ``noise``, else drawn from
        ``generator``. With ``cond_fn``, the mean is conditioned
        (``condition_mean``)."""
        out = self.p_mean_variance(
            model, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            model_kwargs=model_kwargs,
        )
        if noise is None:
            noise = self._draw(x, generator)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        mean = out["mean"]
        if cond_fn is not None:
            mean = self.condition_mean(cond_fn, out, x, t, model_kwargs=model_kwargs)
        sample = mean + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model, x, t, generator: Optional[torch.Generator] = None,
                    clip_denoised=True, denoised_fn=None, cond_fn=None, model_kwargs=None,
                    eta=0.0, noise=None):
        """One DDIM step from x_t; with ``cond_fn``, the score is conditioned
        (``condition_score``)."""
        out = self.p_mean_variance(
            model, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            model_kwargs=model_kwargs,
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        if noise is None:
            noise = self._draw(x, generator)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
        )
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
        sample = mean_pred + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model, x, t, clip_denoised=True, denoised_fn=None,
                            cond_fn=None, model_kwargs=None):
        """The deterministic DDIM step the other way, x_t -> x_{t+1}: the ODE
        that ``ddim_sample`` at eta 0 integrates down, integrated up."""
        out = self.p_mean_variance(
            model, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            model_kwargs=model_kwargs,
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs=model_kwargs)
        nd = x.ndim
        eps = (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x - out["pred_xstart"]
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)
        alpha_bar_next = _extract(self.alphas_cumprod_next, t, nd)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_next)
            + torch.sqrt(1 - alpha_bar_next) * eps
        )
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def _steps(self, step, model, shape, generator, noise, model_kwargs, step_noise):
        """Yields ``step(model, x, t, noise, model_kwargs)``'s dict at t = T-1
        down to 0, each step from the last one's ``sample``."""
        img = self._init_noise(shape, generator, noise)
        T = self.num_timesteps
        for i in range(T):
            t = torch.full((shape[0],), T - 1 - i, dtype=torch.long, device=img.device)
            out = step(model, img, t, self._draw(img, generator, step_noise, i), model_kwargs)
            yield out
            img = out["sample"]

    def _chain(self, step, model, shape, generator, noise, model_kwargs, step_noise, graph,
               eager_only):
        """The last ``sample`` of ``_steps``; with ``graph``, its replays. A
        span, ``diffusion.chain``, from the first draw to the last launch."""
        if graph is not None and eager_only:
            raise ValueError("a chain with cond_fn or denoised_fn runs eagerly: pass no graph")
        with trace.span("diffusion.chain", device=True, alloc=True):
            if graph is None:
                out = None
                for out in self._steps(step, model, shape, generator, noise, model_kwargs,
                                       step_noise):
                    pass
                return out["sample"]
            img = self._init_noise(shape, generator, noise)
            noises = [self._draw(img, generator, step_noise, i)
                      for i in range(self.num_timesteps)]

            def sample(x, t, n, kw):
                return step(model, x, t, n, kw)["sample"]

            return graph.run(sample, img, noises, model_kwargs)

    def _p_step(self, clip_denoised, denoised_fn, cond_fn):
        def step(model, x, t, noise, kw):
            return self.p_sample(model, x, t, clip_denoised=clip_denoised,
                                 denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=kw,
                                 noise=noise)

        return step

    def _ddim_step(self, clip_denoised, denoised_fn, cond_fn, eta):
        def step(model, x, t, noise, kw):
            return self.ddim_sample(model, x, t, clip_denoised=clip_denoised,
                                    denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=kw,
                                    eta=eta, noise=noise)

        return step

    @torch.no_grad()
    def p_sample_loop(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None, denoised_fn=None, cond_fn=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        graph: Optional["ChainGraph"] = None,
    ) -> torch.Tensor:
        """Ancestral sampler: T steps from t = T-1 down to 0; with ``graph``,
        its replays. A chain with ``cond_fn`` or ``denoised_fn`` runs
        eagerly, and refuses a ``graph``."""
        step = self._p_step(clip_denoised, denoised_fn, cond_fn)
        return self._chain(step, model, shape, generator, noise, model_kwargs, step_noise,
                           graph, cond_fn is not None or denoised_fn is not None)

    @torch.no_grad()
    def ddim_sample_loop(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None, eta=0.0, denoised_fn=None, cond_fn=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        graph: Optional["ChainGraph"] = None,
    ) -> torch.Tensor:
        """DDIM sampler, as ``p_sample_loop``; it draws each step's noise even
        at eta 0, so that a generator's stream does not depend on eta."""
        step = self._ddim_step(clip_denoised, denoised_fn, cond_fn, eta)
        return self._chain(step, model, shape, generator, noise, model_kwargs, step_noise,
                           graph, cond_fn is not None or denoised_fn is not None)

    @torch.no_grad()
    def p_sample_loop_progressive(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None, denoised_fn=None, cond_fn=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """``p_sample_loop`` that yields each step's ``{"sample",
        "pred_xstart"}``, at t = T-1 first; eager. The JAX package stacks the
        same dicts from its scan (``sample[i]`` is the i-th yield)."""
        step = self._p_step(clip_denoised, denoised_fn, cond_fn)
        yield from self._steps(step, model, shape, generator, noise, model_kwargs, step_noise)

    @torch.no_grad()
    def ddim_sample_loop_progressive(
        self, model, shape, generator: Optional[torch.Generator] = None, noise=None,
        clip_denoised=True, model_kwargs=None, eta=0.0, denoised_fn=None, cond_fn=None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The DDIM counterpart of ``p_sample_loop_progressive``."""
        step = self._ddim_step(clip_denoised, denoised_fn, cond_fn, eta)
        yield from self._steps(step, model, shape, generator, noise, model_kwargs, step_noise)

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
        """Per-example loss terms at timesteps t. ``KL`` and ``RESCALED_KL``
        give ``loss``, the VB term alone (times T when rescaled). ``MSE`` and
        ``RESCALED_MSE`` give ``mse``, against the noise, x_0 or the
        posterior mean by the mean type, and with a learned variance ``vb``
        (times T / 1000 when rescaled), whose term sees the model's
        prediction detached, so that it trains the variance only; ``loss``
        is their sum."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = self._draw(x_start, generator)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(
                model, x_start, x_t, t, clip_denoised=False, model_kwargs=model_kwargs
            )["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model(x_t, self._map_t(t), **model_kwargs)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, var_values = model_output.chunk(2, dim=1)
            frozen = torch.cat([model_output.detach(), var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(frozen, x_start, x_t, t, clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    # -- evaluation ------------------------------------------------------------

    def _prior_bpd(self, x_start):
        """KL of q(x_T | x_0) to the standard normal prior, in bits per dim."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, t)
        kl = normal_kl(qt_mean, qt_logvar, torch.zeros_like(qt_mean), torch.zeros_like(qt_mean))
        return mean_flat(kl) / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model, x_start, generator: Optional[torch.Generator] = None,
                      clip_denoised=True, model_kwargs=None, noise=None):
        """The whole variational bound in bits per dim, over every timestep,
        eagerly. ``noise[i]`` (a (T, *x_start.shape) tensor) is q_sample's
        noise at loop step i, that is at t = T-1-i; without it each step's
        is drawn from ``generator`` in that order. ``vb``, ``xstart_mse``
        and ``mse`` are (B, T), column j at t = T-1-j."""
        B, T = x_start.shape[0], self.num_timesteps
        vb, xstart_mse, mse = [], [], []
        for i in range(T):
            t = torch.full((B,), T - 1 - i, dtype=torch.long, device=x_start.device)
            eps_in = self._draw(x_start, generator, noise, i)
            x_t = self.q_sample(x_start, t, eps_in)
            out = self._vb_terms_bpd(model, x_start, x_t, t, clip_denoised=clip_denoised,
                                     model_kwargs=model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - eps_in) ** 2))
        vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
        prior_bpd = self._prior_bpd(x_start)
        return {
            "total_bpd": vb.sum(dim=1) + prior_bpd,
            "prior_bpd": prior_bpd,
            "vb": vb,
            "xstart_mse": xstart_mse,
            "mse": mse,
        }


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
        self.graph = Graph(device, pool, name="chain_step")
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
