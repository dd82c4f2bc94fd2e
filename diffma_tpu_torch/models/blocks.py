"""The Spiral Mamba block.

Counterpart of ``diffma_tpu/models/blocks.py::SpiralMambaBlock``: adaLN-Zero
modulation from the conditioning vector c (N, 2D), two mixer branches
(Mamba-1, or Mamba-2 with ``use_mamba2``) where the second sees the
soft-masked tokens ``x_mod * w``, mixed by a learned per-token sigmoid
weight, and a gated residual. Three routes, as in the JAX block:

* ``fuse_block`` with ``use_mamba2`` and ``scan_impl="fused"``: the whole
  block in one call of ``spiral_block_fused`` (on the card kernel E in
  prologue mode and kernel G; its backward recomputes the block through the
  next route, so it is the inference route);
* ``scan_impl="fused"``: both branches in one call of the fused mixer
  (Mamba-1: kernel C, and kernel D in the backward; Mamba-2: kernel E, and
  kernel F in the backward);
* otherwise each mixer runs its own path.

Parameter names follow upstream DiffMa's ``block/mamba_block.py``
(``adaLN_modulation.1``, ``norm1``, ``mamba1``, ``mamba2``,
``attention_network.{0,1,3}``) on every route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.models.layers import modulate
from diffma_tpu_torch.models.mamba import Mamba, check_scan_impl
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops.fused_mixer import mamba_dual_mixer_fused
from diffma_tpu_torch.ops.fused_ssd import mamba2_dual_mixer_fused, spiral_block_fused
from diffma_tpu_torch.ops.norm import layer_norm
from diffma_tpu_torch.ops.scan_orders import ScanSpec

__all__ = ["SpiralMambaBlock"]


class SpiralMambaBlock(nn.Module):
    def __init__(
        self,
        hidden: int,
        spec: ScanSpec,
        d_state: int = 16,
        scan_impl: str = "auto",
        use_mamba2: bool = False,
        fuse_block: bool = False,
    ):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.use_mamba2 = bool(use_mamba2)
        self.fuse_block = bool(fuse_block)
        mixer = Mamba2 if use_mamba2 else Mamba
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(2 * hidden, 3 * hidden))
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mamba1 = mixer(hidden, spec, d_state=d_state, scan_impl=scan_impl)
        self.mamba2 = mixer(hidden, spec, d_state=d_state, scan_impl=scan_impl)
        self.attention_network = nn.Sequential(
            nn.LayerNorm(2 * hidden, eps=1e-5),
            nn.Linear(2 * hidden, hidden),
            nn.SiLU(),
            nn.Linear(hidden, 1),
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.adaLN_modulation(c).chunk(3, dim=-1)
        fused = check_scan_impl(self.scan_impl) == "fused"
        an, fc1, _, fc2 = self.attention_network
        m1, m2 = self.mamba1, self.mamba2
        if self.fuse_block and self.use_mamba2 and fused:
            return spiral_block_fused(
                self.spec, x, w, shift, scale, gate, self.norm1.weight, self.norm1.bias,
                an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                m1.weights(), m2.weights(), m1.dt_limit, m1.norm_eps,
            )
        x_mod = modulate(
            layer_norm(x, self.norm1.weight, self.norm1.bias, eps=self.norm1.eps),
            shift, scale,
        )
        w_in = x_mod * w  # soft mask from the CT encoder
        if fused and self.use_mamba2:
            x_ssm, w_ssm = mamba2_dual_mixer_fused(
                self.spec, x_mod, w_in, m1.weights(), m2.weights(), m1.dt_limit, m1.norm_eps,
                m1.chunk_size,
            )
        elif fused:
            x_ssm, w_ssm = mamba_dual_mixer_fused(
                self.spec, x_mod, w_in, m1.weights(), m2.weights()
            )
        else:
            x_ssm = m1(x_mod)
            w_ssm = m2(w_in)

        h = layer_norm(torch.cat([x_ssm, w_ssm], dim=-1), an.weight, an.bias, eps=an.eps)
        alpha = torch.sigmoid(fc2(F.silu(fc1(h))))
        mixed = alpha * x_ssm + (1.0 - alpha) * w_ssm
        return x + gate[:, None, :] * mixed
