"""Causal depthwise 1-D convolution, feature-last.

Counterpart of ``diffma_tpu/ops/conv.py::causal_conv1d``. Both mixers use
kernel size 4 with left padding 3 and a SiLU activation. A K-tap depthwise
causal conv is K shifted multiply-adds in fp32. ``causal_conv1d_update`` is
the single-token step of incremental decode
(``diffma_tpu/ops/conv.py::causal_conv1d_update``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d", "causal_conv1d_update"]


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


def causal_conv1d_update(
    x_t: torch.Tensor,  # (G, C) new token
    conv_state: torch.Tensor,  # (G, K, C) rolling window, oldest first
    weight: torch.Tensor,  # (C, K)
    bias: Optional[torch.Tensor] = None,  # (C,)
    activation: Optional[str] = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: roll the window, apply the K-tap filter in fp32.
    Returns ``(y in x_t's dtype, the new window)``; the window passed in is
    not changed."""
    window = torch.cat([conv_state[:, 1:], x_t[:, None].to(conv_state.dtype)], dim=1)
    w, xf = weight.float(), window.float()
    y = xf[:, 0] * w[:, 0]
    for k in range(1, w.shape[-1]):
        y = y + xf[:, k] * w[:, k]
    if bias is not None:
        y = y + bias.float()
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(activation)
    return y.to(x_t.dtype), window
