"""Mamba-1 mixer (selective-scan SSM).

Counterpart of the single-device paths of
``diffma_tpu/models/mamba.py::Mamba``. ``scan_impl`` picks the path, with the
JAX package's values:

* ``"auto"`` or ``"pallas"``: the composable path
  (``ops/fused_mixer.py::mixer_composable``) with the selective-scan kernels
  A (forward) and B (backward) on CUDA tensors and the plain scan on CPU
  tensors;
* ``"ref"``: the composable path with the plain scan on any device;
* ``"assoc"``: the composable path with the parallel prefix scan
  (``ops/selective_scan.py::selective_scan_assoc``) on any device, as the
  JAX package's ``assoc``: plain PyTorch operators on the card too, taken
  only when a config asks for it, never as a fallback;
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

Under a mesh (``parallel/mesh.py::Mesh``; ``mesh``, ``tp_axis``,
``sp_axis``, as in the JAX mixer) the weights stay replicated and:

* ``tp_axis``: each tp rank owns a contiguous d_inner slice
  (``mixer_tensor_parallel``, ``diffma_tpu/models/mamba.py:230-341``):
  in_proj's u and z columns of its slice (z's at ``d_inner + off``), the
  streams, the conv, x_proj's partial product summed over tp
  (``psum_mid``), dt, the scan (``"fused"`` becomes ``"auto"``: kernels A
  and B per shard on the card), the merge (the vim quirk's out_proj per
  stream with flipped columns) and out_proj's rows of the slice, summed
  over tp (``psum_out``). x and every weight enter through
  ``collectives.enter``.
* ``tp_axis`` and ``sp_axis``: the same, with the conv and the projections
  at full length; each sp rank scans its slice of the streams
  (``parallel/sequence.py::_sel_scan_local``), puts it back in a zero
  full-length buffer, and one sum over the tp × sp block closes the mixer.
  A stream length not divisible by the sp size raises ``ValueError``.
* ``sp_axis`` alone: the composable path with
  ``selective_scan_sequence_parallel``. JAX quirk, copied: with
  ``scan_impl="fused"`` the JAX mixer runs ``mamba_inner_fused`` on the
  whole sequence before its sp branch is reached
  (``diffma_tpu/models/mamba.py:265-268,299``), so sp is ignored there;
  here too (kernel H on the card). The trainer never reaches it: it takes
  ``"auto"`` under tp or sp.

``dtype`` is the compute dtype, as the JAX mixer's: the parameters stay
fp32, x is cast to it, and the output is in it. At bfloat16 the composable
path runs kernels A and B in bf16 and the fused path the bf16 variants of
kernels C and D, or on a spec that C cannot take that of kernel H
(``ops/fused_mixer.py`` and ``ops/fused_mamba.py`` say where each rounds).

Parameter names follow mamba_ssm's ``Mamba`` state dict, whatever the path.
d_inner is 2 * d_model, the conv has 4 taps, and ``dt_rank`` is
ceil(d_model / 16) whatever the config says, as in the JAX package.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from diffma_tpu_torch.ops.fused_mixer import (
    MixerWeights,
    index_tables,
    mamba_mixer_fused,
    mixer_composable,
    mixer_fused_eligible,
)
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.scan_orders import ScanSpec
from diffma_tpu_torch.ops.selective_scan import selective_scan
from diffma_tpu_torch.parallel.collectives import enter, psum_mid, psum_out
from diffma_tpu_torch.parallel.sequence import (
    _sel_scan_local,
    _seq_shard,
    _seq_unshard,
    selective_scan_sequence_parallel,
)

__all__ = ["Mamba", "SCAN_IMPLS", "check_scan_impl", "check_mesh", "mixer_tensor_parallel"]

#: ``scan_impl`` -> the ``selective_scan`` impl of the composable path (None: fused).
SCAN_IMPLS = {"auto": "auto", "pallas": "auto", "ref": "ref", "assoc": "assoc", "fused": None}


def check_scan_impl(scan_impl: str) -> str:
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {scan_impl!r}; expected one of {sorted(SCAN_IMPLS)}")
    return scan_impl


def axis_size(mesh, axis) -> int:
    return 1 if mesh is None or axis is None else mesh.size(axis)


def check_mesh(spec: ScanSpec, mesh, tp_axis, sp_axis) -> None:
    """JAX's refusal (``diffma_tpu/models/mamba.py:179-184``): tp and sp
    together need the stream length divisible by the sp size."""
    nsp = axis_size(mesh, sp_axis)
    if axis_size(mesh, tp_axis) > 1 and nsp > 1 and spec.fwd.shape[1] % nsp:
        raise ValueError(f"tp+sp composition needs the stream length {spec.fwd.shape[1]} "
                         f"divisible by the sp axis size {nsp}")


def mixer_tensor_parallel(spec: ScanSpec, x: torch.Tensor, w: MixerWeights, mesh, tp_axis: str,
                          sp_axis=None, scan_impl: str = "auto") -> torch.Tensor:
    """This tp rank's share of the mixer (with ``sp_axis``, this tp × sp
    rank's), summed over the group: the full output on every rank of it.
    The JAX mixer's ``_forward(tp=True)``, in its order: in_proj, then the
    streams."""
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d_in, n = w.A_log.shape
    r = w.dt_w.shape[1]
    ntp, nsp = mesh.size(tp_axis), axis_size(mesh, sp_axis)
    d_l, rem = divmod(d_in, ntp)
    if rem:
        raise ValueError(f"d_inner {d_in} is not divisible by the tp axis size {ntp}")
    sp = nsp > 1
    axes = (tp_axis, sp_axis) if sp else tp_axis
    group = mesh.group(axes)
    x = enter(x, group)
    w = MixerWeights(*(enter(t, group) for t in w))
    off = mesh.index(tp_axis) * d_l
    rows = slice(off, off + d_l)
    cd = x.dtype
    xz = torch.cat([F.linear(x, w.in_w[rows].to(cd)),
                    F.linear(x, w.in_w[d_in + off:d_in + off + d_l].to(cd))], dim=-1)
    fwd, merge = index_tables(spec, x.device)
    xs = xz.index_select(1, fwd).reshape(B_ * S, Ls, 2 * d_l)
    u, z = xs.split(d_l, dim=-1)
    u = causal_conv1d(u, w.conv_w[rows, 0, :], w.conv_b[rows])
    # x_proj mixes the whole d_inner: the shards' partial products, summed
    x_dbl = psum_mid(F.linear(u, w.xp_w[:, rows].to(cd)), mesh.group(tp_axis))
    dt_r, B_ssm, C_ssm = x_dbl.split([r, n, n], dim=-1)
    delta = F.linear(dt_r.float(), w.dt_w[rows].float(), w.dt_b[rows].float())
    A = -torch.exp(w.A_log[rows].float())
    D = w.D[rows].float()
    if sp:
        # each sp rank scans its slice of the full-length streams
        shd = lambda t: _seq_shard(t, mesh, sp_axis)  # noqa: E731
        y = _sel_scan_local(shd(u), shd(delta), A, shd(B_ssm), shd(C_ssm), D, shd(z), True,
                            mesh, sp_axis)
        y = _seq_unshard(y, Ls, mesh, sp_axis)
    else:
        impl = "auto" if scan_impl == "fused" else SCAN_IMPLS[scan_impl]
        y = selective_scan(u.contiguous(), delta, A, B_ssm.contiguous(), C_ssm.contiguous(), D,
                           z=z.contiguous(), impl=impl)
    out_w = w.out_w[:, rows].to(cd)
    if spec.mamba1_vim_quirk:
        ys = y.reshape(B_, S, Ls, d_l)
        out = F.linear(ys[:, 0], out_w) + F.linear(ys[:, 1], out_w).flip(-1)
        return psum_out(out * spec.scale, group)
    merged = y.reshape(B_, S * Ls, d_l).index_select(1, merge)
    merged = merged.reshape(B_, L, spec.merge.shape[1], d_l).sum(dim=2) * spec.scale
    return psum_out(F.linear(merged, out_w), group)


class Mamba(nn.Module):
    """Selective-scan mixer over one layer's ``ScanSpec``: (B, L, D) -> (B, L, D)."""

    def __init__(self, d_model: int, spec: ScanSpec, d_state: int = 16, scan_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, mesh=None, tp_axis=None, sp_axis=None):
        super().__init__()
        self.spec = spec
        self.scan_impl = check_scan_impl(scan_impl)
        self.dtype = dtype
        check_mesh(spec, mesh, tp_axis, sp_axis)
        self.mesh, self.tp_axis, self.sp_axis = mesh, tp_axis, sp_axis
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
        mesh = self.mesh
        if axis_size(mesh, self.tp_axis) > 1:
            return mixer_tensor_parallel(self.spec, x, self.weights(), mesh, self.tp_axis,
                                         self.sp_axis, self.scan_impl)
        sp = axis_size(mesh, self.sp_axis) > 1
        if impl is not None:
            scan = None if not sp else functools.partial(
                selective_scan_sequence_parallel, mesh=mesh, axis=self.sp_axis)
            return mixer_composable(self.spec, x, self.weights(), scan_impl=impl, scan=scan)
        if not sp and mixer_fused_eligible(self.spec, partition=True):
            return mamba_mixer_fused(self.spec, x, self.weights())
        # under sp the fused route runs kernel H on the whole sequence and
        # ignores sp, as diffma_tpu/models/mamba.py:265-268 does
        return mixer_composable(self.spec, x, self.weights(), fused_inner=True)
