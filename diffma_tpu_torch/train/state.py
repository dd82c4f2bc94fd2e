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
decides on the device, as JAX's ``train_step_predicated`` does: one masked
update (``ops/masked_adamw.py``: AdamW over the parameters with gradients,
the EMA over every parameter) writes the parameters, the EMA and AdamW's
``exp_avg``, ``exp_avg_sq`` and ``step`` only where the loss was finite, so
a non-finite gradient never reaches the state. ``torch.optim.AdamW`` holds
that state (its ``param_groups`` give lr, betas, eps and weight decay; its
``state_dict`` is the checkpoints'), but its ``step()`` is not called. The
count of finite steps, ``TrainState.step``, is a device tensor. With
``accumulation_steps > 1`` the update is kept where the loss was finite and
the iteration updates, the sum of gradients where the loss was finite, as
JAX's ``lax.cond`` path. Nothing in the step reads a device value on the
host, so on the card it is captured whole in a CUDA graph
(``GraphedTrainStep``, at ``accumulation_steps == 1``).

Over several processes ``make_train_step`` takes the dp ranks' process group:
after the backward one ``all_reduce`` of the loss, its aux terms and the flat
gradients averages them over the group, as JAX's loss and gradients are
means over the global batch (each dp rank's batch has as many rows). The
NaN skip then reads the global loss, so every rank keeps or skips the step
together: with a local predicate, a rank whose own loss is finite would
apply the NaN gradient averaged in from another. At ``accumulation_steps >
1`` each micro-step is averaged so, as JAX's jitted step is. Tensor- and
sequence-parallel weights are whole before it (``parallel/collectives.py``).
A gloo collective cannot be captured in a CUDA graph, so a step over
several processes runs eagerly.

``restore_train_state`` loads a checkpoint's model, EMA and AdamW state into
a ``TrainState``, as the JAX trainer's ``resume_from`` does: before the
graphed step's first call, since a capture holds the optimizer state's
addresses, which loading replaces.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from diffma_tpu_torch.ops.masked_adamw import masked_adamw
from diffma_tpu_torch.utils import trace
from diffma_tpu_torch.utils.graphs import Graph

__all__ = ["GraphedTrainStep", "TrainState", "adamw", "make_train_step", "restore_train_state"]

LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def adamw(params, lr: float) -> torch.optim.AdamW:
    """The trainers' AdamW: betas 0.9 / 0.999, eps 1e-8, no weight decay, as
    ``optax.adamw`` in the JAX package. It holds the state that the step's
    masked update (``ops/masked_adamw.py``) steps; on the card it is
    ``capturable``, so that a loaded checkpoint's step counts land on the
    device, where the update reads them."""
    params = list(params)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                             capturable=any(p.is_cuda for p in params))


class TrainState:
    """The model, its EMA copy, the optimizer, the accumulated gradients and
    the count of finite steps (an int64 tensor on the model's device); the
    trainer sets ``generator``, the generator that drew its batches and the
    loss's draws, when it returns the state."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.optimizer = optimizer
        self.accum_grads: Optional[List[torch.Tensor]] = None  # made when first needed
        device = next(model.parameters()).device
        self.step = torch.tensor(int(step), dtype=torch.long, device=device)
        self.generator: Optional[torch.Generator] = None


def _load_optimizer_state(optimizer: torch.optim.Optimizer, saved: Dict) -> None:
    """Load the per-parameter state of ``saved`` (an optimizer ``state_dict``
    over the same parameters in the same order) into ``optimizer``. Its
    hyperparameters stay the optimizer's own, as the JAX trainer takes the
    learning rate from the config; with ``capturable`` each ``step`` lands
    on its parameter's device. A moment saved in another layout (a
    converted Orbax checkpoint's transposes) is made contiguous, as the
    step's update takes it."""
    current = optimizer.state_dict()
    n = sum(len(g["params"]) for g in current["param_groups"])
    if not set(saved["state"]) <= set(range(n)):
        raise KeyError(f"the optimizer state holds parameter {max(saved['state'])}; the model "
                       f"has {n}")
    optimizer.load_state_dict({"state": saved["state"], "param_groups": current["param_groups"]})
    for state in optimizer.state.values():
        for key, value in state.items():
            if torch.is_tensor(value) and not value.is_contiguous():
                state[key] = value.contiguous()


def restore_train_state(state: TrainState, tree: Dict, step: int) -> None:
    """``tree``'s ``model``, ``ema`` and ``opt`` into ``state``, in place:
    the parameters and the EMA copied into the modules, AdamW's state
    replaced; the count of finite steps set to ``step`` (the JAX trainer
    sets it to the checkpoint's step, the loop's count of iterations, which
    exceeds the count of finite steps after a skipped batch); the
    accumulated gradients zero, since no checkpoint holds them."""
    state.model.load_state_dict(tree["model"], strict=True)
    state.ema.load_state_dict(tree["ema"], strict=True)
    _load_optimizer_state(state.optimizer, tree["opt"])
    state.step.fill_(int(step))
    if state.accum_grads is not None:
        for g in state.accum_grads:
            g.zero_()


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


def _adamw_state(optimizer: torch.optim.Optimizer, p: torch.Tensor) -> Dict:
    """AdamW's state of ``p``, made where it is missing as torch's AdamW
    makes it at its first step: a 0-d fp32 ``step`` on ``p``'s device and
    zero ``exp_avg`` and ``exp_avg_sq``."""
    state = optimizer.state[p]
    if not state:
        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def _predicated_update(state: TrainState, optimizer, keep: torch.Tensor, params, ema_decay):
    """AdamW over ``params`` (their ``.grad`` set) with each param group's
    hyperparameters, and the EMA over every parameter, written only where
    ``keep``. A skipped first step leaves AdamW's state made and zero."""
    stepped = {id(p) for p in params}
    model = list(state.model.parameters())
    ema_of = dict(zip(map(id, model), state.ema.parameters()))
    ema_only = [p for p in model if id(p) not in stepped]
    for group in optimizer.param_groups:
        ps = [p for p in group["params"] if id(p) in stepped]
        adam = [_adamw_state(optimizer, p) for p in ps]
        none = [None] * len(ema_only)
        masked_adamw(keep, ps + ema_only, [p.grad for p in ps] + none,
                     [s["exp_avg"] for s in adam] + none, [s["exp_avg_sq"] for s in adam] + none,
                     [s["step"] for s in adam] + none, [ema_of[id(p)] for p in ps + ema_only],
                     lr=float(group["lr"]), betas=group["betas"], eps=group["eps"],
                     weight_decay=group["weight_decay"], ema_decay=ema_decay)
        ema_only = []  # in the first group's launch


def _mean_over(group, params, loss: torch.Tensor, aux: Dict[str, torch.Tensor]):
    """The loss, the aux terms and ``params``' gradients (a missing one as
    zeros) averaged over ``group`` by one ``all_reduce`` of a flat buffer;
    the gradients in place, the loss and the aux terms returned."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    scalars = [loss.detach().float(), *(v.float() for v in aux.values())]
    flat = _flat([t.reshape(1) for t in scalars] + grads)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    _scatter(grads, flat[len(scalars):])
    return flat[0], {k: flat[1 + i] for i, k in enumerate(aux)}


def make_train_step(loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    accumulation_steps: int = 1, ema_decay: float = 0.999, group=None):
    """The step ``train_step(state, batch, generator) -> metrics``, where
    ``loss_fn(batch, generator) -> (loss, aux)`` is the loss of
    ``state.model`` and ``optimizer`` steps its parameters. ``metrics`` holds
    the loss, ``finite`` (a bool tensor) and the aux terms, all on the
    device. ``group``: the dp ranks' process group, over which the loss,
    the aux terms and the gradients are averaged after the backward (None:
    one process)."""
    k = int(accumulation_steps)
    if k < 1:
        raise ValueError(f"accumulation_steps must be at least 1, got {k}")
    for param_group in optimizer.param_groups:
        if (any(p.is_cuda for p in param_group["params"])
                and not param_group.get("capturable", True)):
            raise ValueError("on the card the step needs an optimizer whose state stays on the "
                             "device: AdamW(capturable=True), as state.adamw makes it")
        if param_group.get("amsgrad") or param_group.get("maximize"):
            raise ValueError("the step's update is AdamW's without amsgrad or maximize")

    def train_step(state: TrainState, batch, generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, generator)
        loss.backward()
        if group is not None:
            loss, aux = _mean_over(group, list(state.model.parameters()), loss, aux)
        finite = torch.isfinite(loss.detach())
        metrics = {"loss": loss.detach(), "finite": finite, **aux}
        with torch.no_grad():
            if k == 1:
                params = [p for p in state.model.parameters() if p.grad is not None]
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
        self.graph = Graph(device, name="train_step")
        self.state = self.batch = self.metrics = None

    def __call__(self, state: TrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        if "t" not in batch or "noise" not in batch:
            raise ValueError("a graphed step's batch carries its t and noise")
        if self.state is None:
            self.state, self.batch = state, {k: v.clone() for k, v in batch.items()}
            return self.graph.warm_up(self.train_step, state, batch, None)
        if state is not self.state or batch.keys() != self.batch.keys():
            raise ValueError("a graphed step serves one TrainState and one batch layout")
        with trace.span("train_step.copy_in"):
            for k, v in batch.items():
                self.batch[k].copy_(v)
        if self.metrics is None:
            self.metrics = self.graph.capture(self.train_step, state, self.batch, None)
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}
