"""Mamba-1 mixer (selective-scan SSM).

Counterpart of the single-device paths of
``diffma_tpu/models/mamba.py::Mamba``. ``scan_impl`` picks the path, with the
JAX package's values:

* ``"auto"`` or ``"pallas"``: the composable path
  (``ops/fused_mixer.py::mixer_composable``) with the selective-scan kernels
  A (forward) and B (backward) on CUDA tensors and the plain scan on CPU
  tensors;
* ``"ref"``: the composable path with the plain scan on any device;
* ``"fused"``: the whole mixer in one call of kernel C forward and one of
  kernel D backward (``ops/fused_mixer.py::mamba_mixer_fused``) on CUDA
  tensors, its plain version on CPU tensors. Every scan spec that
  ``build_scan_spec`` makes goes this way (full-length streams, the vim
  quirk, EfficientVMamba's exact partition). A hand-made spec that kernel C
  cannot run (streams that are neither full-length nor an exact partition)
  keeps the composable path's gather, in_proj, merge and out_proj and sends
  what lies between them through ``ops/fused_mamba.py::mamba_inner_fused``
  (kernel H on CUDA tensors), as the JAX mixer does.

Every path carries gradients to the input and to every parameter.

``dtype`` is the compute dtype, as the JAX mixer's: the parameters stay
fp32, x is cast to it, and the output is in it. At bfloat16 the composable
path runs kernels A and B in bf16 and the fused path the bf16 variants of
kernels C and D (``ops/fused_mixer.py`` says where each rounds); kernel H
has no bf16 variant and refuses bf16 on the card.

Parameter names follow mamba_ssm's ``Mamba`` state dict, whatever the path.
d_inner is 2 * d_model, the conv has 4 taps, and ``dt_rank`` is
ceil(d_model / 16) whatever the config says, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diffma_tpu_torch.ops.fused_mixer import (
    MixerWeights,
    mamba_mixer_fused,
    mixer_composable,
    mixer_fused_eligible,
)
from diffma_tpu_torch.ops.scan_orders import ScanSpec

__all__ = ["Mamba", "SCAN_IMPLS", "check_scan_impl"]

#: ``scan_impl`` -> the ``selective_scan`` impl of the composable path (None: fused).
SCAN_IMPLS = {"auto": "auto", "pallas": "auto", "ref": "ref", "fused": None}


def check_scan_impl(scan_impl: str) -> str:
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {scan_impl!r}; expected one of {sorted(SCAN_IMPLS)}")
    return scan_impl


class Mamba(nn.Module):
    """Selective-scan mixer over one layer's ``ScanSpec``: (B, L, D) -> (B, L, D)."""

    def __init__(self, d_model: int, spec: ScanSpec, d_state: int = 16, scan_impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.dtype = dtype
        d_in, n, r = 2 * d_model, d_state, math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=False)
        self.conv1d = nn.Conv1d(d_in, d_in, 4, groups=d_in, padding=3)
        self.x_proj = nn.Linear(d_in, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, d_in)
        self.A_log = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d_in, 1)
        )
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)

    def weights(self) -> MixerWeights:
        """The parameters in the order the mixer functions take them."""
        return MixerWeights(
            self.in_proj.weight, self.conv1d.weight, self.conv1d.bias, self.x_proj.weight,
            self.dt_proj.weight, self.dt_proj.bias, self.A_log, self.D, self.out_proj.weight,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        impl = SCAN_IMPLS[check_scan_impl(self.scan_impl)]
        if impl is not None:
            return mixer_composable(self.spec, x, self.weights(), scan_impl=impl)
        if mixer_fused_eligible(self.spec, partition=True):
            return mamba_mixer_fused(self.spec, x, self.weights())
        return mixer_composable(self.spec, x, self.weights(), fused_inner=True)
