"""LayerNorm and the gated group RMSNorm of Mamba-2, with fp32 statistics.

Counterpart of ``diffma_tpu/ops/norm.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "rms_norm_gated"]


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


def rms_norm_gated(
    x: torch.Tensor,
    weight: torch.Tensor,
    z: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    group_size: Optional[int] = None,
    norm_before_gate: bool = False,
) -> torch.Tensor:
    """Gated group RMSNorm, as mamba_ssm's ``RMSNormGated``:

        norm_before_gate=False:  out = rmsnorm(x * silu(z)) * weight
        norm_before_gate=True:   out = rmsnorm(x) * weight * silu(z)

    with the RMS statistic of each ``group_size`` slice of the last axis.
    """
    xf = x.float()
    if z is not None and not norm_before_gate:
        xf = xf * F.silu(z.float())
    d = x.shape[-1]
    gs = group_size or d
    if d % gs:
        raise ValueError(f"group_size {gs} does not divide the last axis {d}")
    shaped = xf.reshape(*xf.shape[:-1], d // gs, gs)
    rms = torch.rsqrt(shaped.square().mean(dim=-1, keepdim=True) + eps)
    y = (shaped * rms).reshape(xf.shape) * weight.float()
    if z is not None and norm_before_gate:
        y = y * F.silu(z.float())
    return y.to(x.dtype)
