"""Mamba-2 (SSD) mixer.

Counterpart of the single-device paths of
``diffma_tpu/models/mamba2.py::Mamba2``. ``scan_impl`` picks the path, with
the JAX package's values:

* ``"auto"``, ``"pallas"``, ``"ref"`` or ``"assoc"``: the composable path
  (``ops/fused_ssd.py::ssd_mixer_ref``: in_proj, stream gather, conv,
  ``ssd_chunked_grouped``, gated RMSNorm per stream, merge, out_proj) from
  PyTorch operators on any device; it carries gradients;
* ``"fused"``: the whole mixer in one call of kernel E
  (``ops/fused_ssd.py::mamba2_mixer_fused``) on CUDA tensors, its plain
  version on CPU tensors; where a gradient is needed, kernel E keeps its
  residual and kernel F is the backward. Only for one B/C group; with
  ``ngroups > 1`` the composable path runs, as in the JAX package.

Parameter names follow mamba_ssm's ``Mamba2`` state dict, whatever the path:
``in_proj.weight`` with rows ``[z | x | B | C | dt]``, ``conv1d`` over the
``d_inner + 2 * ngroups * d_state`` channels ``[x | B | C]``, ``dt_bias``,
``A_log`` and ``D`` per head, ``norm.weight`` of the gated RMSNorm, and
``out_proj.weight``. d_inner is 2 * d_model and the conv has 4 taps. The
tensor- and sequence-parallel branches come with the parallel layer.

``dtype`` is the compute dtype, as the JAX mixer's: the parameters stay
fp32, x is cast to it, and the output is in it. At bfloat16 the composable
path runs ``ssd_mixer_ref`` in bf16 and the fused path the bf16 variants of
kernels E and F (``ops/fused_ssd.py`` says where each rounds).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from diffma_tpu_torch.models.mamba import SCAN_IMPLS, check_scan_impl
from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights, mamba2_mixer_fused, ssd_mixer_ref
from diffma_tpu_torch.ops.scan_orders import ScanSpec

__all__ = ["Mamba2"]


class Mamba2(nn.Module):
    """SSD mixer over one layer's ``ScanSpec``: (B, L, D) -> (B, L, D)."""

    def __init__(
        self,
        d_model: int,
        spec: ScanSpec,
        d_state: int = 16,
        scan_impl: str = "auto",
        headdim: int = 64,
        ngroups: int = 1,
        chunk_size: int = 256,
        dt_limit: Tuple[float, float] = (0.0, float("inf")),
        norm_eps: float = 1e-5,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.dtype = dtype
        d_in = 2 * d_model
        if d_in % headdim:
            raise ValueError(f"d_inner {d_in} is not a multiple of headdim {headdim}")
        nheads = d_in // headdim
        if nheads % ngroups:
            raise ValueError(f"nheads {nheads} is not divisible by ngroups {ngroups}")
        self.headdim, self.ngroups, self.chunk_size = headdim, ngroups, chunk_size
        self.dt_limit, self.norm_eps = tuple(dt_limit), norm_eps
        conv_dim = d_in + 2 * ngroups * d_state
        self.in_proj = nn.Linear(d_model, 2 * d_in + 2 * ngroups * d_state + nheads, bias=False)
        self.conv1d = nn.Conv1d(conv_dim, conv_dim, 4, groups=conv_dim, padding=3)
        self.dt_bias = nn.Parameter(torch.zeros(nheads))
        self.A_log = nn.Parameter(torch.zeros(nheads))
        self.D = nn.Parameter(torch.ones(nheads))
        self.norm = nn.Module()
        self.norm.weight = nn.Parameter(torch.ones(d_in))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)

    def weights(self) -> Mamba2Weights:
        """The parameters in the order the mixer functions take them."""
        return Mamba2Weights(
            self.in_proj.weight, self.conv1d.weight, self.conv1d.bias, self.dt_bias,
            self.A_log, self.D, self.norm.weight, self.out_proj.weight,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        fused = SCAN_IMPLS[check_scan_impl(self.scan_impl)] is None
        if fused and self.ngroups == 1:
            return mamba2_mixer_fused(
                self.spec, x, self.weights(), self.dt_limit, self.norm_eps, self.chunk_size
            )
        return ssd_mixer_ref(
            self.spec, x, self.weights(), self.dt_limit, self.norm_eps, self.chunk_size,
            self.ngroups,
        )
