"""The training step's AdamW and EMA update, masked by the step's finite flag.

Counterpart of the update in ``diffma_tpu/train/state.py``: optax's adamw
(no weight decay in the trainers), the EMA over every parameter, and the
NaN skip, which keeps the old state where the loss is not finite. XLA fuses
that select into the update; here one pass over each tensor does the same.
Per fp32 parameter, where the 0-d bool ``keep`` is true:

    m   = b1 m + (1 - b1) g
    v   = b2 v + (1 - b2) g^2
    p   = p (1 - lr wd) - lr (m / bc1) / (sqrt(v / bc2) + eps)
    ema = decay ema + (1 - decay) p
    step += 1

with ``bc1 = 1 - b1^(step + 1)`` and ``bc2 = 1 - b2^(step + 1)``; where
``keep`` is false every tensor and every step count stays as it was, bit
for bit. Each tensor has its own step count (AdamW's ``state["step"]``, a
0-d fp32 tensor). A tensor whose gradient is None takes the EMA alone.

Two implementations:

* ``masked_adamw_plain``: the plain PyTorch version, per tensor, each new
  value kept by ``torch.where`` on ``keep``; the EMA's sum is torch's add
  with alpha (one fused multiply-add on the card), the kernel's too. On
  CUDA tensors its bias corrections are the kernel's: fp32 on the device,
  from the fp32 step count (torch's capturable AdamW). On CPU tensors they
  are torch's CPU AdamW's: in double, from the step count read on the host.
* ``masked_adamw_cuda``: the hand-written kernel (``csrc/masked_adamw.cu``),
  which replaces no TPU kernel; ``masked_adamw_cuda.launches`` counts its
  calls (each launches the update and a small kernel that adds to the step
  counts, per 512 tensors).

``masked_adamw`` takes the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback, and raises on tensors that are not fp32,
not contiguous or not all on ``keep``'s device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from diffma_tpu_torch.ops import cuda_build

__all__ = ["masked_adamw", "masked_adamw_cuda", "masked_adamw_plain"]

_KERNEL_SOURCE = "masked_adamw"
Tensors = Sequence[Optional[torch.Tensor]]


def _check(keep, params, grads, exp_avgs, exp_avg_sqs, steps, emas) -> torch.device:
    """Raise on what the update does not take; return ``keep``'s device."""
    n = len(params)
    if not all(len(x) == n for x in (grads, exp_avgs, exp_avg_sqs, steps, emas)):
        raise ValueError("the update takes one gradient, moment pair, step and EMA per parameter")
    if keep.dtype != torch.bool or keep.numel() != 1:
        raise ValueError(f"keep must be one bool, got {keep.dtype} of shape {tuple(keep.shape)}")
    device = keep.device
    for i, (p, g, m, v, step, e) in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs, steps,
                                                  emas)):
        state = (g, m, v, step)
        if g is None and any(t is not None for t in state):
            raise ValueError(f"tensor {i} has no gradient but has AdamW's state")
        if g is not None and any(t is None for t in state):
            raise ValueError(f"tensor {i} has a gradient but lacks AdamW's state")
        for t in (p, e, *state):
            if t is None:
                continue
            if t.device != device:
                raise ValueError(f"tensor {i} is on {t.device}, keep on {device}")
            if t.dtype != torch.float32:
                raise ValueError(f"the update takes float32 tensors, got {t.dtype} at tensor {i}")
            if not t.is_contiguous():
                raise ValueError(f"tensor {i} must be contiguous")
        if any(t is not None and t.shape != p.shape for t in (g, m, v, e)):
            raise ValueError(f"tensor {i}: the gradient, the moments and the EMA must have the "
                             f"parameter's shape {tuple(p.shape)}")
        if step is not None and step.numel() != 1:
            raise ValueError(f"tensor {i}: the step count must be one number")
    return device


@torch.no_grad()
def masked_adamw_plain(keep, params, grads, exp_avgs, exp_avg_sqs, steps, emas, *, lr: float,
                       betas, eps: float, weight_decay: float, ema_decay: float) -> None:
    """The update in plain PyTorch, in place (see the module's docstring)."""
    beta1, beta2 = betas
    for p, g, m, v, step, e in zip(params, grads, exp_avgs, exp_avg_sqs, steps, emas):
        if g is not None:
            t = step + 1
            if step.is_cuda:
                bc1, bc2 = (1 - torch.pow(torch.full((), b, device=t.device), t)
                            for b in (beta1, beta2))
            else:
                bc1, bc2 = (1 - b ** float(t) for b in (beta1, beta2))
            m_new = m * beta1 + g * (1 - beta1)
            v_new = v * beta2 + g * g * (1 - beta2)
            p_new = p * (1 - lr * weight_decay) - lr * (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
            for old, new in ((m, m_new), (v, v_new), (p, p_new), (step, t)):
                old.copy_(torch.where(keep, new, old))
        e.copy_(torch.where(keep, torch.add(e * ema_decay, p, alpha=1 - ema_decay), e))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.load(_KERNEL_SOURCE).masked_adamw
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_adamw_cuda(keep, params, grads, exp_avgs, exp_avg_sqs, steps, emas, *, lr: float,
                      betas, eps: float, weight_decay: float, ema_decay: float) -> None:
    """The update by the CUDA kernel, in place, on the current stream.

    Raises on inputs the kernel does not take; ``masked_adamw_cuda.launches``
    counts the calls."""
    device = _check(keep, params, grads, exp_avgs, exp_avg_sqs, steps, emas)
    if device.type != "cuda":
        raise ValueError(f"the masked AdamW kernel needs CUDA tensors, got {device}")
    if not params:
        return
    beta1, beta2 = betas

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rows = torch.tensor([[ptr(t) for t in row] + [row[0].numel()]
                         for row in zip(params, grads, exp_avgs, exp_avg_sqs, emas, steps)],
                        dtype=torch.int64)
    coef = (ctypes.c_float * 9)(lr, beta1, beta2, eps, 1 - beta1, 1 - beta2, ema_decay,
                                1 - ema_decay, 1 - lr * weight_decay)
    err = _kernel_fn()(rows.data_ptr(), len(params), keep.data_ptr(), coef,
                       torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_adamw launch failed: error {err}")
    masked_adamw_cuda.launches += 1


masked_adamw_cuda.launches = 0


def masked_adamw(keep: torch.Tensor, params: Tensors, grads: Tensors, exp_avgs: Tensors,
                 exp_avg_sqs: Tensors, steps: Tensors, emas: Tensors, *, lr: float, betas,
                 eps: float, weight_decay: float = 0.0, ema_decay: float = 0.999) -> None:
    """AdamW over ``params`` and the EMA in ``emas``, in place, written only
    where ``keep``: the kernel on CUDA tensors, the plain version on CPU
    tensors. A parameter whose gradient is None (and whose moments and step
    are None) takes the EMA alone."""
    args = (keep, params, grads, exp_avgs, exp_avg_sqs, steps, emas)
    hyper = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, ema_decay=ema_decay)
    if keep.device.type == "cuda":
        return masked_adamw_cuda(*args, **hyper)  # checks its inputs
    device = _check(*args)
    if device.type != "cpu":
        raise ValueError(f"the masked AdamW takes CPU or CUDA tensors, got {device}")
    masked_adamw_plain(*args, **hyper)
