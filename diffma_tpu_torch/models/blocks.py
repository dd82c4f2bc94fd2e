"""The Spiral Mamba block.

Counterpart of ``diffma_tpu/models/blocks.py::SpiralMambaBlock`` without
``fuse_block`` (a Mamba-2 path): adaLN-Zero modulation from the conditioning
vector c (N, 2D), two Mamba branches where the second sees the soft-masked
tokens ``x_mod * w``, mixed by a learned per-token sigmoid weight, and a
gated residual. With ``scan_impl="fused"`` both branches run in one call of
the fused mixer (kernel C on the card, and kernel D in the backward);
otherwise each mixer runs its own path. Parameter names follow upstream
DiffMa's ``block/mamba_block.py`` (``adaLN_modulation.1``, ``norm1``,
``mamba1``, ``mamba2``, ``attention_network.{0,1,3}``) on both paths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.models.layers import modulate
from diffma_tpu_torch.models.mamba import Mamba, check_scan_impl
from diffma_tpu_torch.ops.fused_mixer import mamba_dual_mixer_fused
from diffma_tpu_torch.ops.norm import layer_norm
from diffma_tpu_torch.ops.scan_orders import ScanSpec

__all__ = ["SpiralMambaBlock"]


class SpiralMambaBlock(nn.Module):
    def __init__(self, hidden: int, spec: ScanSpec, d_state: int = 16, scan_impl: str = "auto"):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(2 * hidden, 3 * hidden))
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mamba1 = Mamba(hidden, spec, d_state=d_state, scan_impl=scan_impl)
        self.mamba2 = Mamba(hidden, spec, d_state=d_state, scan_impl=scan_impl)
        self.attention_network = nn.Sequential(
            nn.LayerNorm(2 * hidden, eps=1e-5),
            nn.Linear(2 * hidden, hidden),
            nn.SiLU(),
            nn.Linear(hidden, 1),
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.adaLN_modulation(c).chunk(3, dim=-1)
        x_mod = modulate(
            layer_norm(x, self.norm1.weight, self.norm1.bias, eps=self.norm1.eps),
            shift, scale,
        )
        if check_scan_impl(self.scan_impl) == "fused":
            x_ssm, w_ssm = mamba_dual_mixer_fused(  # soft mask from the CT encoder
                self.spec, x_mod, x_mod * w, self.mamba1.weights(), self.mamba2.weights()
            )
        else:
            x_ssm = self.mamba1(x_mod)
            w_ssm = self.mamba2(x_mod * w)  # soft mask from the CT encoder

        an, fc1, _, fc2 = self.attention_network
        h = layer_norm(torch.cat([x_ssm, w_ssm], dim=-1), an.weight, an.bias, eps=an.eps)
        alpha = torch.sigmoid(fc2(F.silu(fc1(h))))
        mixed = alpha * x_ssm + (1.0 - alpha) * w_ssm
        return x + gate[:, None, :] * mixed
