"""Train state and the training step.

Counterpart of ``diffma_tpu/train/state.py``, with its semantics:

* the hybrid diffusion loss, a mean over the batch;
* a non-finite loss leaves the parameters, the EMA, the optimizer state and
  the step count untouched;
* gradient accumulation with the reference's quirks kept: the loss is not
  divided by ``accumulation_steps``, and the optimizer fires on iterations
  whose step count before the increment satisfies
  ``step % accumulation_steps == 0`` (iterations 1, 3, ... for 2);
* the EMA (decay 0.999) is updated on optimizer iterations only, over every
  parameter, and starts as a copy of the model.

PyTorch updates the state in place where JAX returns a new one. The step
checks the loss on the host, once per step, after the backward has been
queued: that is a wait for the device each step.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

__all__ = ["TrainState", "make_train_step", "update_ema"]

LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class TrainState:
    """The model, its EMA copy, the optimizer, the accumulated gradients and
    the count of finite steps."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.optimizer = optimizer
        self.accum_grads: Optional[List[torch.Tensor]] = None  # made when first needed
        self.step = int(step)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> None:
    """ema = decay * ema + (1 - decay) * params, over every parameter."""
    ema_params = list(ema.parameters())
    params = [p.to(e.dtype) for e, p in zip(ema_params, model.parameters())]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1 - decay)


def make_train_step(loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    accumulation_steps: int = 1, ema_decay: float = 0.999):
    """The step ``train_step(state, batch, generator) -> metrics``, where
    ``loss_fn(batch, generator) -> (loss, aux)`` is the loss of
    ``state.model`` and ``optimizer`` steps its parameters. ``metrics`` holds
    the loss, ``finite`` and the aux terms."""
    k = int(accumulation_steps)
    if k < 1:
        raise ValueError(f"accumulation_steps must be at least 1, got {k}")

    def train_step(state: TrainState, batch, generator) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, generator)
        loss.backward()
        finite = bool(torch.isfinite(loss))
        metrics = {"loss": loss.detach(), "finite": finite, **aux}
        if not finite:
            optimizer.zero_grad(set_to_none=True)
            return metrics
        if k > 1:
            if state.accum_grads is None:
                state.accum_grads = [torch.zeros_like(p) for p in params]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            torch._foreach_add_(state.accum_grads, grads)
            if state.step % k == 0:
                for p, acc in zip(params, state.accum_grads):
                    p.grad = acc.clone()
                optimizer.step()
                update_ema(state.ema, state.model, ema_decay)
                torch._foreach_zero_(state.accum_grads)
        else:
            optimizer.step()
            update_ema(state.ema, state.model, ema_decay)
        state.step += 1
        return metrics

    return train_step
