"""LayerNorm with fp32 statistics.

Counterpart of ``diffma_tpu/ops/norm.py::layer_norm``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["layer_norm"]


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
