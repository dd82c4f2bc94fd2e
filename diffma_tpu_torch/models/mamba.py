"""Mamba-1 mixer (selective-scan SSM).

Counterpart of the composable, single-device path of
``diffma_tpu/models/mamba.py::Mamba``:

1. gather the scan streams from the token sequence, then ``in_proj``
   (a per-token matmul commutes with the token permutation);
2. split u and z; causal conv + SiLU on u;
3. ``x_proj`` -> [dt_r, B, C]; ``delta = dt_r @ dt_w + dt_b`` in fp32;
4. the selective scan with ``A = -exp(A_log)``, gated by silu(z);
5. scatter-add merge of the streams times ``spec.scale``, then ``out_proj``
   (no bias, so merging first is exact).

Parameter names follow mamba_ssm's ``Mamba`` state dict. d_inner is
2 * d_model, the conv has 4 taps, and ``dt_rank`` is ceil(d_model / 16)
whatever the config says, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.scan_orders import ScanSpec
from diffma_tpu_torch.ops.selective_scan import selective_scan

__all__ = ["Mamba"]


class Mamba(nn.Module):
    """Selective-scan mixer over one layer's ``ScanSpec``: (B, L, D) -> (B, L, D).

    The attribute ``scan_impl`` is passed to ``selective_scan``: "auto" (the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors), or "ref"
    to hold the kernel against the plain scan on the card.
    """

    def __init__(self, d_model: int, spec: ScanSpec, d_state: int = 16):
        super().__init__()
        if spec.mamba1_vim_quirk:
            raise NotImplementedError("the vim scan family is not ported yet")
        self.d_inner = 2 * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.scale = spec.scale
        self.scan_impl = "auto"
        d_in, n, r = self.d_inner, d_state, self.dt_rank
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=False)
        self.conv1d = nn.Conv1d(d_in, d_in, 4, groups=d_in, padding=3)
        self.x_proj = nn.Linear(d_in, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, d_in)
        self.A_log = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d_in, 1)
        )
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)
        # The layer's stream gather and merge tables live with the module, so
        # a forward pass copies no index from the host.
        self.register_buffer(
            "fwd_idx", torch.as_tensor(spec.fwd.reshape(-1), dtype=torch.long),
            persistent=False,
        )
        self.register_buffer(
            "merge_idx", torch.as_tensor(spec.merge.reshape(-1), dtype=torch.long),
            persistent=False,
        )
        self.n_streams, self.stream_len = spec.fwd.shape
        self.merge_k = spec.merge.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B_, L, _ = x.shape
        d_in, n, r = self.d_inner, self.d_state, self.dt_rank
        S, Ls = self.n_streams, self.stream_len

        xz = self.in_proj(x.index_select(1, self.fwd_idx))  # (B, S*Ls, 2d)
        xs = xz.reshape(B_ * S, Ls, 2 * d_in)
        u, z = xs.split(d_in, dim=-1)
        u = causal_conv1d(u, self.conv1d.weight[:, 0, :], self.conv1d.bias)
        dt_r, B_ssm, C_ssm = self.x_proj(u).split([r, n, n], dim=-1)
        delta = F.linear(dt_r.float(), self.dt_proj.weight.float(), self.dt_proj.bias.float())
        A = -torch.exp(self.A_log.float())
        y = selective_scan(
            u, delta, A, B_ssm.contiguous(), C_ssm.contiguous(), self.D.float(),
            z=z.contiguous(), impl=self.scan_impl,
        )

        ys = y.reshape(B_, S * Ls, d_in)
        merged = ys.index_select(1, self.merge_idx).reshape(B_, L, self.merge_k, d_in)
        return self.out_proj(merged.sum(dim=2) * self.scale)
