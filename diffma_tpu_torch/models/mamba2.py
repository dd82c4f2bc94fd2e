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
``out_proj.weight``. d_inner is 2 * d_model and the conv has 4 taps.

Under a mesh (``parallel/mesh.py::Mesh``; ``mesh``, ``tp_axis``,
``sp_axis``, as in the JAX mixer), for one B/C group only (JAX's assert,
``diffma_tpu/models/mamba2.py:183-191``; ``ngroups > 1`` raises
``ValueError``) and never on the fused route:

* ``tp_axis``: each tp rank owns a contiguous slice of the heads
  (``mixer_tensor_parallel``, ``diffma_tpu/models/mamba2.py:229-264``): the
  column groups ``[z | x | B, C shared | dt]`` of in_proj, the conv over its
  x slice and the shared B/C channels, ``ssd_chunked`` from a zero state,
  the gated RMSNorm over the whole d_inner through a sum of the shards'
  sums of squares (``psum_mid``), and out_proj's rows of its slice, summed
  over tp (``psum_out``); x and every weight enter through
  ``collectives.enter``.
* ``tp_axis`` and ``sp_axis``: the same, with each sp rank scanning its
  slice of the streams (``parallel/sequence.py::_local_with_carry``) and
  one sum over the tp × sp block; a stream length not divisible by the sp
  size raises ``ValueError``.
* ``sp_axis`` alone: the composable path with ``ssd_sequence_parallel``.

``dtype`` is the compute dtype, as the JAX mixer's: the parameters stay
fp32, x is cast to it, and the output is in it. At bfloat16 the composable
path runs ``ssd_mixer_ref`` in bf16 and the fused path the bf16 variants of
kernels E and F (``ops/fused_ssd.py`` says where each rounds).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.models.mamba import SCAN_IMPLS, axis_size, check_mesh, check_scan_impl
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.fused_mixer import index_tables
from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights, mamba2_mixer_fused, ssd_mixer_ref
from diffma_tpu_torch.ops.scan_orders import ScanSpec
from diffma_tpu_torch.ops.ssd import ssd_chunked
from diffma_tpu_torch.parallel.collectives import enter, psum_mid, psum_out
from diffma_tpu_torch.parallel.sequence import (
    _local_with_carry,
    _seq_shard,
    _seq_unshard,
    ssd_sequence_parallel,
)

__all__ = ["Mamba2", "mixer_tensor_parallel"]


def mixer_tensor_parallel(spec: ScanSpec, x: torch.Tensor, w: Mamba2Weights, mesh, tp_axis: str,
                          sp_axis=None, dt_limit=(0.0, float("inf")), eps: float = 1e-5,
                          chunk_size: int = 256) -> torch.Tensor:
    """This tp rank's heads of the mixer (with ``sp_axis``, this tp × sp
    rank's share), summed over the group: the full output on every rank of
    it. The JAX mixer's ``_forward(tp=True)``, one B/C group."""
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d = w.norm_w.shape[0]
    H = w.A_log.shape[0]
    Ph = d // H
    n = (w.conv_w.shape[0] - d) // 2
    ntp, nsp = mesh.size(tp_axis), axis_size(mesh, sp_axis)
    H_l, rem = divmod(H, ntp)
    if rem:
        raise ValueError(f"nheads {H} is not divisible by the tp axis size {ntp}")
    sp = nsp > 1
    axes = (tp_axis, sp_axis) if sp else tp_axis
    group = mesh.group(axes)
    x = enter(x, group)
    w = Mamba2Weights(*(enter(t, group) for t in w))
    t = mesh.index(tp_axis)
    d_l, off = H_l * Ph, t * H_l * Ph
    heads = slice(t * H_l, (t + 1) * H_l)
    cd = x.dtype
    # the column groups of the fused [z | x | B, C | dt] projection this shard owns
    rows = torch.cat([w.in_w[off:off + d_l], w.in_w[d + off:d + off + d_l],
                      w.in_w[2 * d:2 * d + 2 * n], w.in_w[2 * d + 2 * n:][heads]])
    zxbcdt = F.linear(x, rows.to(cd))
    # conv channels: this shard's x slice and the shared B/C tail
    conv_w = torch.cat([w.conv_w[off:off + d_l], w.conv_w[d:]])[:, 0, :]
    conv_b = torch.cat([w.conv_b[off:off + d_l], w.conv_b[d:]])
    fwd, merge = index_tables(spec, x.device)
    xs = zxbcdt.index_select(1, fwd).reshape(B_ * S, Ls, -1)
    z, xBC, dt = xs.split([d_l, d_l + 2 * n, H_l], dim=-1)
    xBC = causal_conv1d(xBC, conv_w, conv_b)
    x_ssm, B_ssm, C_ssm = xBC.split([d_l, n, n], dim=-1)
    x_h = x_ssm.reshape(B_ * S, Ls, H_l, Ph)
    A = -torch.exp(w.A_log[heads].float())
    D, dt_bias = w.D[heads], w.dt_bias[heads]
    if sp:
        shd = lambda a: _seq_shard(a, mesh, sp_axis)  # noqa: E731
        y = _local_with_carry(shd(x_h), shd(dt.float()), A, shd(B_ssm), shd(C_ssm), D, dt_bias,
                              True, dt_limit, chunk_size, mesh, sp_axis)
        z = shd(z)
    else:
        y = ssd_chunked(x_h, dt.float(), A, B_ssm, C_ssm, D, dt_bias=dt_bias, dt_softplus=True,
                        dt_limit=dt_limit, chunk_size=chunk_size)
    y = y.reshape(B_ * S, -1, d_l)
    # the gated RMSNorm's one group spans all of d_inner: the shards' sums of
    # squares, summed
    yf = y.float() * F.silu(z.float())
    sumsq = psum_mid(yf.square().sum(dim=-1, keepdim=True), mesh.group(tp_axis))
    y = (yf * torch.rsqrt(sumsq / d + eps) * w.norm_w[off:off + d_l].float()).to(y.dtype)
    if sp:
        y = _seq_unshard(y, Ls, mesh, sp_axis)
    merged = y.reshape(B_, S * Ls, d_l).index_select(1, merge)
    merged = merged.reshape(B_, L, spec.merge.shape[1], d_l).sum(dim=2) * spec.scale
    return psum_out(F.linear(merged.to(cd), w.out_w[:, off:off + d_l].to(cd)), group)


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
        mesh=None,
        tp_axis=None,
        sp_axis=None,
    ):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.dtype = dtype
        if ngroups != 1 and axis_size(mesh, tp_axis) * axis_size(mesh, sp_axis) > 1:
            raise ValueError("tensor/sequence parallel Mamba2 requires ngroups=1")
        check_mesh(spec, mesh, tp_axis, sp_axis)
        self.mesh, self.tp_axis, self.sp_axis = mesh, tp_axis, sp_axis
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
        mesh = self.mesh
        if axis_size(mesh, self.tp_axis) > 1:
            return mixer_tensor_parallel(self.spec, x, self.weights(), mesh, self.tp_axis,
                                         self.sp_axis, self.dt_limit, self.norm_eps,
                                         self.chunk_size)
        if axis_size(mesh, self.sp_axis) > 1:
            scan = functools.partial(ssd_sequence_parallel, mesh=mesh, axis=self.sp_axis)
            return ssd_mixer_ref(self.spec, x, self.weights(), self.dt_limit, self.norm_eps,
                                 self.chunk_size, scan=scan)
        if fused and self.ngroups == 1:
            return mamba2_mixer_fused(
                self.spec, x, self.weights(), self.dt_limit, self.norm_eps, self.chunk_size
            )
        return ssd_mixer_ref(
            self.spec, x, self.weights(), self.dt_limit, self.norm_eps, self.chunk_size,
            self.ngroups,
        )
