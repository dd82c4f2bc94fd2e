"""Training steps in plain PyTorch: the hybrid loss, its gradients by
autograd, AdamW and the EMA, over the reference denoiser.

AdamW as the port's trainer configures it (betas 0.9 / 0.999, eps 1e-8, no
weight decay, ``optax.adamw``'s defaults in the JAX package): m and v from
zeros, bias-corrected, p -= lr m̂ / (sqrt(v̂) + eps). The EMA starts as the
initial weights and takes ema = decay ema + (1 - decay) p after each update.
Each mixer is recomputed in the backward (``torch.utils.checkpoint``), so
that the step-by-step scans fit in memory at batch 8.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.diffusion import Diffusion
from benchmark.reference.model import Denoiser
from benchmark.reference.products import Products

__all__ = ["leaf_norms", "train_readings"]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's 2-norm, summed in float64."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].detach(), dtype=torch.float64)
                         for k in names])
    return dict(zip(names, norms.tolist()))


def _recompute(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def train_readings(cfg: dict, weights0: Dict[str, torch.Tensor], batches: List[dict],
                   products: Products, lr: float, ema_decay: float,
                   betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Run one training step per batch (``z``, ``y``, ``y2``, ``w``, ``t``,
    ``noise``) from ``weights0``. Returns each step's ``loss``, the first
    step's gradient norm per leaf (``grad``), and per leaf the norm of the
    change of the weights (``change``) and of the EMA (``ema_change``)
    after the last step."""
    device = batches[0]["z"].device
    cuda = device.type == "cuda"
    diffusion = Diffusion(1000, 1000, device=device)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights0.items()}
    den = Denoiser(cfg, params, products)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    ema = {k: v.detach().clone() for k, v in params.items()}

    def model(x, t, y, y2, w):
        return den(x, t, y, y2, w, mixer_wrap=_recompute)

    losses, grad = [], None
    for step, b in enumerate(batches, start=1):
        loss = diffusion.training_loss(model, b["z"].float(), b["t"], b["noise"],
                                       {"y": b["y"], "y2": b["y2"], "w": b["w"]})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if step == 1:
            grad = leaf_norms(grads)
        # the bias corrections as the trainer's AdamW computes them: in fp32
        # on the card (``capturable``), where 1 - 0.999 is 1.3e-5 off, and
        # in double on the CPU
        if cuda:
            t = torch.tensor(float(step))
            bc1, bc2 = (1 - torch.tensor(beta) ** t for beta in betas)
        else:
            bc1, bc2 = (1 - beta ** step for beta in betas)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                p.sub_(lr * (m[k] / bc1) / ((v2[k] / bc2).sqrt() + eps))
                ema[k].mul_(ema_decay).add_(p, alpha=1 - ema_decay)
    return {"loss": losses, "grad": grad,
            "change": leaf_norms({k: params[k] - weights0[k] for k in params}),
            "ema_change": leaf_norms({k: ema[k] - weights0[k] for k in params})}
