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
decides on the device, as JAX's ``train_step_predicated`` does: it zeroes
the gradients of a non-finite loss, steps the optimizer and the EMA
unconditionally, and then puts back, with ``torch.where`` over flat copies,
the parameters, the EMA and every tensor of the optimizer's state (AdamW's
``exp_avg``, ``exp_avg_sq`` and ``step``) where the loss was not finite. The
count of finite steps, ``TrainState.step``, is a device tensor. With
``accumulation_steps > 1`` the update is kept where the loss was finite and
the iteration updates, the sum of gradients where the loss was finite, as
JAX's ``lax.cond`` path. Nothing in the step reads a device value on the
host, so on the card it is captured whole in a CUDA graph
(``GraphedTrainStep``, at ``accumulation_steps == 1``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from diffma_tpu_torch.utils.graphs import Graph

__all__ = ["GraphedTrainStep", "TrainState", "adamw", "make_train_step", "update_ema"]

LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def adamw(params, lr: float) -> torch.optim.AdamW:
    """The trainers' AdamW: betas 0.9 / 0.999, eps 1e-8, no weight decay, as
    ``optax.adamw`` in the JAX package. On the card it keeps its step counts
    on the device (``capturable``), so that the step reads none on the host;
    its arithmetic stays the foreach one there and the for-loop one on the
    CPU."""
    params = list(params)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                             capturable=any(p.is_cuda for p in params))


class TrainState:
    """The model, its EMA copy, the optimizer, the accumulated gradients and
    the count of finite steps (an int64 tensor on the model's device)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.optimizer = optimizer
        self.accum_grads: Optional[List[torch.Tensor]] = None  # made when first needed
        device = next(model.parameters()).device
        self.step = torch.tensor(int(step), dtype=torch.long, device=device)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> None:
    """ema = decay * ema + (1 - decay) * params, over every parameter."""
    ema_params = list(ema.parameters())
    params = [p.to(e.dtype) for e, p in zip(ema_params, model.parameters())]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1 - decay)


def _pieces(flat: torch.Tensor, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' values end to end in a new tensor, copied by one foreach
    copy (``torch.cat`` of hundreds of small tensors moves its bytes at a
    fraction of the card's rate)."""
    flat = tensors[0].new_empty(sum(t.numel() for t in tensors))
    torch._foreach_copy_(_pieces(flat, tensors), tensors)
    return flat


def _scatter(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy the consecutive pieces of ``flat`` into ``tensors``."""
    torch._foreach_copy_(tensors, _pieces(flat, tensors))


def _keep_where(keep: torch.Tensor, tensors: List[torch.Tensor], other) -> None:
    """``tensors = where(keep, tensors, other)`` in place, ``other`` a flat
    tensor of their consecutive values or a scalar."""
    flat = _flat(tensors)
    if not torch.is_tensor(other):
        other = flat.new_full((), other)
    _scatter(tensors, torch.where(keep, flat, other, out=flat))


def _optimizer_tensors(optimizer: torch.optim.Optimizer, params) -> List[torch.Tensor]:
    return [v for p in params for v in optimizer.state[p].values() if torch.is_tensor(v)]


def _predicated_update(state: TrainState, optimizer, keep: torch.Tensor, params, ema_decay):
    """Step ``optimizer`` over ``params`` (their ``.grad`` set) and the EMA,
    then put every tensor they changed back where ``keep`` is false. The
    state that AdamW makes at its first step was zeros before it."""
    made = [p for p in params if not optimizer.state[p]]
    held = [p for p in params if optimizer.state[p]]
    ema = list(state.ema.parameters())
    tensors = list(params) + ema + _optimizer_tensors(optimizer, held)
    old = _flat(tensors)
    optimizer.step()
    update_ema(state.ema, state.model, ema_decay)
    _keep_where(keep, tensors, old)
    if made:
        _keep_where(keep, _optimizer_tensors(optimizer, made), 0.0)


def make_train_step(loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    accumulation_steps: int = 1, ema_decay: float = 0.999):
    """The step ``train_step(state, batch, generator) -> metrics``, where
    ``loss_fn(batch, generator) -> (loss, aux)`` is the loss of
    ``state.model`` and ``optimizer`` steps its parameters. ``metrics`` holds
    the loss, ``finite`` (a bool tensor) and the aux terms, all on the
    device."""
    k = int(accumulation_steps)
    if k < 1:
        raise ValueError(f"accumulation_steps must be at least 1, got {k}")
    for group in optimizer.param_groups:
        if any(p.is_cuda for p in group["params"]) and not group.get("capturable", True):
            raise ValueError("on the card the step needs an optimizer whose state stays on the "
                             "device: AdamW(capturable=True), as state.adamw makes it")

    def train_step(state: TrainState, batch, generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, generator)
        loss.backward()
        finite = torch.isfinite(loss.detach())
        metrics = {"loss": loss.detach(), "finite": finite, **aux}
        with torch.no_grad():
            if k == 1:
                params = [p for p in state.model.parameters() if p.grad is not None]
                _keep_where(finite, [p.grad for p in params], 0.0)
                _predicated_update(state, optimizer, finite, params, ema_decay)
            else:
                params = [p for p in state.model.parameters() if p.requires_grad]
                if state.accum_grads is None:
                    state.accum_grads = [torch.zeros_like(p) for p in params]
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in params]
                before = _flat(state.accum_grads)
                accum = torch.where(finite, before + _flat(grads), before)
                update = finite & (state.step % k == 0)
                _scatter(grads, accum)
                _predicated_update(state, optimizer, update, params, ema_decay)
                zeros = accum.new_zeros(())
                _scatter(state.accum_grads, torch.where(update, zeros, accum, out=accum))
            state.step += finite.to(state.step.dtype)
        return metrics

    return train_step


class GraphedTrainStep:
    """A ``make_train_step`` step at ``accumulation_steps == 1`` as a CUDA
    graph on ``device``, for one ``TrainState``.

    A replay draws nothing, so each batch carries the loss's ``t`` and
    ``noise``, drawn by the caller in the eager step's order. The first call
    runs the step eagerly on the graph's stream (AdamW makes its state, the
    kernels' first calls set up what a capture refuses); the second
    captures it; every call from the second on copies the batch into the
    graph's static buffers and replays it. Returns a copy of the step's
    metrics, which the next replay does not overwrite."""

    def __init__(self, train_step, device):
        self.train_step = train_step
        self.graph = Graph(device)
        self.state = self.batch = self.metrics = None

    def __call__(self, state: TrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        if "t" not in batch or "noise" not in batch:
            raise ValueError("a graphed step's batch carries its t and noise")
        if self.state is None:
            self.state, self.batch = state, {k: v.clone() for k, v in batch.items()}
            return self.graph.warm_up(self.train_step, state, batch, None)
        if state is not self.state or batch.keys() != self.batch.keys():
            raise ValueError("a graphed step serves one TrainState and one batch layout")
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if self.metrics is None:
            self.metrics = self.graph.capture(self.train_step, state, self.batch, None)
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}
