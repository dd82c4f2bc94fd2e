"""Timestep samplers: importance sampling over the diffusion's timesteps.

Counterpart of ``diffma_tpu/diffusion/timestep_samplers.py``.
``UniformSampler`` draws from a caller-given ``torch.Generator`` where JAX
takes a key. ``LossSecondMomentResampler`` keeps its loss history on the
host in numpy, as the JAX package does, and weights each timestep by the
root mean square of its last losses. Over several processes
``LossAwareSampler.update_with_local_losses`` gathers every dp rank's
timesteps and losses, in rank order, before it updates, as the JAX
package's gathers every process's (``process_allgather``).
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


def _gather(values: np.ndarray, group) -> np.ndarray:
    """Every rank's ``values`` (one shape on every rank), end to end in rank
    order: a zero buffer with this rank's at its slot, summed over
    ``group`` in fp64 (exact for the timesteps) on the backend's device."""
    dist = torch.distributed
    n, i = dist.get_world_size(group), dist.get_rank(group)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    buf = torch.zeros((n, values.size), dtype=torch.float64, device=device)
    buf[i] = torch.from_numpy(values.astype(np.float64).reshape(-1)).to(device)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy().reshape(-1)


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses, group=None):
        """Update with every dp rank's timesteps and losses: this rank's are
        gathered with the others' over ``group`` (a mesh's ``group("dp")``;
        by default, in a process group of more than one, all its ranks),
        each rank giving as many. One process updates with its own."""
        dist = torch.distributed
        ts = np.asarray(torch.as_tensor(local_ts).cpu()).reshape(-1)
        losses = np.asarray(torch.as_tensor(local_losses).detach().cpu(), np.float64).reshape(-1)
        if group is not None or (dist.is_available() and dist.is_initialized()
                                 and dist.get_world_size() > 1):
            ts = _gather(ts, group).astype(np.int64)
            losses = _gather(losses, group)
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
