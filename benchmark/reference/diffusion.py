"""Gaussian diffusion in plain PyTorch: DiffMa's coefficient tables, its
hybrid training loss and one ancestral (DDPM) step.

Frozen from the arithmetic of ``diffma_tpu_torch/diffusion/__init__.py``
and ``gaussian.py`` at commit 8e06284, which follow upstream's
``diffusion/`` (improved-diffusion): a linear beta schedule over 1000
steps, respaced to the sampler's steps by keeping timesteps and rebuilding
their betas from alphas_cumprod; epsilon prediction; a learned-range
variance (the model's second half of channels places the log-variance
between the posterior's and beta's); the loss is the MSE to the noise plus
the variational bound's term, which sees the prediction detached. The
tables are derived in float64 and used as float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Diffusion", "respaced_steps"]


def respaced_steps(num_steps: int, count: int) -> list:
    """The timesteps that respacing to ``count`` keeps (one section)."""
    stride = 1 if count <= 1 else (num_steps - 1) / (count - 1)
    taken, cur = set(), 0.0
    for _ in range(count):
        taken.add(round(cur))
        cur += stride
    return sorted(taken)


def _mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


def _normal_kl(m1, lv1, m2, lv2):
    return 0.5 * (-1.0 + lv2 - lv1 + torch.exp(lv1 - lv2) + (m1 - m2) ** 2 * torch.exp(-lv2))


def _discretized_nll(x, means, log_scales):
    def cdf(v):
        return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (v + 0.044715 * v ** 3)))

    centered = x - means
    inv = torch.exp(-log_scales)
    plus, minus = cdf(inv * (centered + 1 / 255)), cdf(inv * (centered - 1 / 255))
    log_plus = torch.log(plus.clamp_min(1e-12))
    log_one_minus = torch.log((1 - minus).clamp_min(1e-12))
    log_delta = torch.log((plus - minus).clamp_min(1e-12))
    return -torch.where(x < -0.999, log_plus, torch.where(x > 0.999, log_one_minus, log_delta))


class Diffusion:
    """The linear schedule over ``num_steps``, respaced to ``count`` steps
    (``count`` = ``num_steps``: no respacing), as float32 tables on ``device``."""

    def __init__(self, count: int = 1000, num_steps: int = 1000, device="cpu"):
        base = np.linspace(1e-4 * 1000 / num_steps, 0.02 * 1000 / num_steps, num_steps,
                           dtype=np.float64)
        acp_all = np.cumprod(1.0 - base)
        keep = respaced_steps(num_steps, count)
        betas, last = [], 1.0
        for k in keep:
            betas.append(1 - acp_all[k] / last)
            last = acp_all[k]
        betas = np.asarray(betas)
        acp = np.cumprod(1.0 - betas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1 - acp_prev) / (1 - acp)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.num_timesteps = len(betas)
        self.timestep_map = torch.as_tensor(keep, dtype=torch.long, device=device)
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_1m_acp = f32(np.sqrt(1 - acp))
        self.sqrt_recip_acp = f32(np.sqrt(1 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1 / acp - 1))
        self.post_logvar = f32(np.log(np.append(post_var[1], post_var[1:])))
        self.coef1 = f32(betas * np.sqrt(acp_prev) / (1 - acp))
        self.coef2 = f32((1 - acp_prev) * np.sqrt(1 - betas) / (1 - acp))
        self.log_betas = f32(np.log(betas))

    @staticmethod
    def _at(table, t):
        return table[t].reshape(-1, 1, 1, 1)

    def _p_mean(self, out, x, t):
        """(mean, log-variance) of p(x_{t-1} | x_t) from the model's output."""
        eps, v = out.chunk(2, dim=1)
        frac = (v + 1) / 2
        logvar = frac * self._at(self.log_betas, t) + (1 - frac) * self._at(self.post_logvar, t)
        x0 = self._at(self.sqrt_recip_acp, t) * x - self._at(self.sqrt_recipm1_acp, t) * eps
        return self._at(self.coef1, t) * x0 + self._at(self.coef2, t) * x, logvar

    def training_loss(self, model, x0, t, noise, kwargs) -> torch.Tensor:
        """The hybrid loss (MSE to the noise plus the VB term), a mean over the batch."""
        x_t = self._at(self.sqrt_acp, t) * x0 + self._at(self.sqrt_1m_acp, t) * noise
        out = model(x_t, self.timestep_map[t], **kwargs)
        eps, v = out.chunk(2, dim=1)
        mean, logvar = self._p_mean(torch.cat([eps.detach(), v], dim=1), x_t, t)
        true_mean = self._at(self.coef1, t) * x0 + self._at(self.coef2, t) * x_t
        kl = _mean_flat(_normal_kl(true_mean, self._at(self.post_logvar, t), mean, logvar))
        nll = _mean_flat(_discretized_nll(x0, mean, 0.5 * logvar))
        vb = torch.where(t == 0, nll, kl) / math.log(2.0)
        return (_mean_flat((noise - eps) ** 2) + vb).mean()

    def p_sample(self, model, x, t, noise, kwargs) -> torch.Tensor:
        """x_{t-1} from x_t at respaced index t (N,), with the step's noise."""
        mean, logvar = self._p_mean(model(x, self.timestep_map[t], **kwargs), x, t)
        nonzero = (t != 0).float().reshape(-1, 1, 1, 1)
        return mean + nonzero * torch.exp(0.5 * logvar) * noise
