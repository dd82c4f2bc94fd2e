"""Timestep samplers: importance sampling over the diffusion's timesteps.

Counterpart of ``diffma_tpu/diffusion/timestep_samplers.py``.
``UniformSampler`` draws from a caller-given ``torch.Generator`` where JAX
takes a key. ``LossSecondMomentResampler`` keeps its loss history on the
host in numpy, as the JAX package does, and weights each timestep by the
root mean square of its last losses. One process: gathering the losses of
several processes waits for the port's parallel layer, and
``LossAwareSampler.update_with_local_losses`` raises in a process group of
more than one.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "LossAwareSampler",
    "LossSecondMomentResampler",
    "ScheduleSampler",
    "UniformSampler",
    "create_named_schedule_sampler",
]


def create_named_schedule_sampler(name: str, diffusion):
    if name == "uniform":
        return UniformSampler(diffusion)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(diffusion)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(abc.ABC):
    """Importance sampler over diffusion timesteps."""

    @abc.abstractmethod
    def weights(self) -> np.ndarray:
        ...

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timesteps (B,), loss weights (B,)): timesteps drawn with
        probabilities proportional to ``weights()``, on the generator's
        device, each weighted by 1 / (T p(t))."""
        w = np.asarray(self.weights(), np.float64)
        p = torch.as_tensor(w / w.sum(), dtype=torch.float32,
                            device=generator.device if generator is not None else "cpu")
        indices = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        weights = 1.0 / (len(p) * p[indices])
        return indices, weights


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self.diffusion = diffusion
        self._weights = np.ones([diffusion.num_timesteps])

    def weights(self):
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses):
        """Update with this process's timesteps and losses. Gathering them
        from every process waits for the parallel layer, so a process group
        of more than one raises."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError("gathering the losses of several processes waits for the "
                                      "port's parallel layer")
        ts = np.asarray(torch.as_tensor(local_ts).cpu()).reshape(-1)
        losses = np.asarray(torch.as_tensor(local_losses).detach().cpu(), np.float64).reshape(-1)
        self.update_with_all_losses(ts.tolist(), losses.tolist())

    @abc.abstractmethod
    def update_with_all_losses(self, ts, losses):
        ...


class LossSecondMomentResampler(LossAwareSampler):
    def __init__(self, diffusion, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.diffusion = diffusion
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            [diffusion.num_timesteps, history_per_term], dtype=np.float64
        )
        self._loss_counts = np.zeros([diffusion.num_timesteps], dtype=np.int64)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.diffusion.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
