"""Causal depthwise 1-D convolution, feature-last.

Counterpart of ``diffma_tpu/ops/conv.py::causal_conv1d``. Both mixers use
kernel size 4 with left padding 3 and a SiLU activation. A K-tap depthwise
causal conv is K shifted multiply-adds in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d"]


def causal_conv1d(
    x: torch.Tensor,  # (G, L, C) feature-last
    weight: torch.Tensor,  # (C, K)
    bias: Optional[torch.Tensor] = None,  # (C,)
    activation: Optional[str] = "silu",
) -> torch.Tensor:
    """y[t] = act(sum_k w[:, k] * x[t - K + 1 + k] + b), zero left-pad."""
    K = weight.shape[-1]
    L = x.shape[1]
    w = weight.float()
    pad = F.pad(x.float(), (0, 0, K - 1, 0))
    y = pad[:, 0:L, :] * w[:, 0]
    for k in range(1, K):
        y = y + pad[:, k : k + L, :] * w[:, k]
    if bias is not None:
        y = y + bias.float()
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(activation)
    return y.to(x.dtype)
