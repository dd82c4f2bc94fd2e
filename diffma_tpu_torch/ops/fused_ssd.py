"""Whole Mamba-2 (SSD) mixer and the Spiral block around it: forward and
backward.

Counterpart of ``diffma_tpu/ops/fused_ssd.py``. The mixer takes the tokens
``x (B, L, h)`` of one layer to ``(B, L, h)``, with in_proj's columns in the
order ``[z | x | B | C | dt]``:

    zx = in_proj(x); per stream s (token order fwd[s]):
      [xs | Bs | Cs] = silu(conv(zx[xBC columns])), dt = clip(softplus(dt + dt_bias)),
      y_s = SSD(xs by head, dt, -exp(A_log), Bs, Cs, D),
      n_s = rmsnorm(y_s * silu(z)) * norm_w        (per stream: the norm is nonlinear)
    out = out_proj(scale * sum_s n_s, back in token order)

and the Spiral block wraps two of them: LayerNorm + adaLN modulation in
front (the second branch sees the soft-masked tokens), the learned mix of
the two outputs and the gated residual behind.

Two implementations of each:

* ``ssd_mixer_ref``: the plain PyTorch version, built on ``ssd_chunked`` and
  ``rms_norm_gated``. It is the composable Mamba-2 path of
  ``models/mamba2.py``, the CPU path, and what kernel E is held against.
  ``ssd_mixer_bwd_ref`` is autograd over it, what kernel F is held against.
  ``spiral_epilogue_ref`` is the block's tail and ``spiral_block_ref`` the
  whole block from these. At bf16 the plain version of kernels E and F is
  ``_ssd_mixer_fused_lowp`` (see below).
* ``ssd_mixer_fused_cuda``: the hand-written CUDA kernel E
  (``csrc/fused_ssd_fwd.cu``), which replaces the TPU kernel
  ``diffma_tpu/ops/fused_ssd.py::_ssd_kernel``: one or two mixers per call,
  and in prologue mode the block's LayerNorm + modulate + soft mask too. In
  residual mode (``want_res``) it also returns ``zx = in_proj(x)`` in token
  order, ``(M, B * L, 2d + 2n + H)``, which holds everything the TPU kernel's
  two residuals hold. ``ssd_mixer_fused_bwd_cuda`` is kernel F
  (``csrc/fused_ssd_bwd.cu``), which replaces ``_ssd_bwd_kernel``: the
  gradients of x and the 8 weights from x, dL/dout, the weights and that
  residual. ``spiral_epilogue_cuda`` is kernel G
  (``csrc/spiral_epilogue.cu``), which replaces ``_spiral_epilogue_kernel``.
  ``ssd_core_cuda`` is kernel P (``csrc/ssd_core_fwd.cu``),
  which replaces ``tools/probes/probe_split_ssd.py::_core_kernel``: the
  mixer's middle alone (conv, dt, the SSD, the gate and the norm, no merge)
  on gathered streams ``zx (G, L, 2d + 2n + H)``; ``ssd_core_ref`` is its
  plain version, the middle of ``ssd_mixer_ref`` (at a bf16 zx the TPU
  kernel's rounding, ``_ssd_core_lowp``; the CUDA variant rounds the same
  head products inside each 64-step chunk, as E bf16). Their ``launches``
  attributes count calls (each launches a chain of device kernels).

``FusedSsdFn`` joins E and F for autograd: forward through kernel E in
residual mode, backward through one call of kernel F. ``SpiralBlockFn`` is
the whole block: forward through kernel E in prologue mode and kernel G,
backward by recomputing the block through ``FusedSsdFn`` and differentiating
that, as the JAX package's ``spiral_block_fused`` does (exact gradients for
one more forward).

``mamba2_mixer_fused``, ``mamba2_dual_mixer_fused`` and ``spiral_block_fused``
dispatch on the tensors' device: the kernels for CUDA tensors (through the
autograd Functions when a gradient is needed, else plain kernel E with no
residual written), the plain versions under autograd for CPU tensors;
``impl="ref"`` takes the plain version on any device. fp32 or bf16, one B/C
group.
Kernels E and F run full-length stream permutations (a vim spec merges the
standard way here: Mamba-2 never takes Mamba-1's quirk) and, in their one-
and two-mixer modes, exact partitions of the tokens (EfficientVMamba's four
quarter-length atrous streams, each a sequence of its own, whose merge is a
scatter). Prologue mode takes full-length specs only (the Spiral block's
specs are), and raises ``NotImplementedError`` on a partition. The kernels
cut each stream into chunks of 64 steps with a carried state, so a stream may
be of any length; within a chunk the decay is the quadratic form, and every
exponent is a sum of dt * A (never positive), exact at every span, forward
and backward.

bf16. x may be bf16 (the JAX package's bf16 model, ``dtype=bfloat16``): the
weights stay fp32, the outputs (and the gradient of x) are bf16, the
weights' gradients fp32. The two routes then round at different places, as
the JAX package's do. ``ssd_mixer_ref`` at bf16 is the composable route
(``Mamba2._forward``): in_proj in bf16, the conv's output, the SSD's y and
the normed rows bf16, the merge in bf16, then out_proj in bf16. The fused
route (``_ssd_mixer_fused_lowp``: kernels E and F, and their plain version
on CPU tensors) rounds where the TPU kernel casts: zx to bf16 after
in_proj; the conv, dt and the cumsum fp32 from the rounded columns; inside
each 64-step chunk the masked decay ``(C_t . B_u) exp(cs_t - cs_u)`` and
``dt_u x_u`` rounded at the head products, with fp32 sums, and the state
carried from chunk to chunk fp32 (the TPU kernel has one chunk per stream;
the kernels here round the products it rounds and keep the state exact);
y + D x fp32, rounded before the merge but for a stream in token order; the
gate, the norm and the stream sum fp32; the merge rounded at out_proj's
operand, whose output is bf16. Its backward (kernel F, autograd over the
plain version) rounds the gradient where the forward rounds a value it
reads back, and every product's operands, with fp32 results: g and g
W_out, the SSD's head products, each non-identity stream's g_y and its
conv and dt columns' gradient; g_C and g_B, which the TPU kernel takes from
the sum over heads of a rounded matrix, stay fp32 here, where each head's
block holds its own share. In prologue mode x is LN + modulate + mask in
fp32, rounded to bf16. Kernel G at bf16 rounds the normed concat and fc1
for the 2h -> h product, silu(h) and fc2 for the h -> 1 dot, and the
output; the LayerNorm, the mix and the residual are fp32.
``spiral_block_ref`` at bf16 is the composition through which the JAX
block's backward recomputes (bf16 LayerNorm, modulation, tail products and
residual around the fused mixers); ``spiral_block_fused`` runs the kernels'
rounding forward and differentiates that composition, on any device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops import cuda_build
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.cuda_build import LaunchCount, _count
from diffma_tpu_torch.ops.fused_mixer import (
    _identity_streams,
    index_tables,
    mixer_fused_eligible,
)
from diffma_tpu_torch.ops.norm import layer_norm, rms_norm_gated
from diffma_tpu_torch.ops.scan_orders import ScanSpec
from diffma_tpu_torch.ops.selective_scan import _DTYPE_CODE
from diffma_tpu_torch.ops.ssd import RoundedProduct, ssd_chunked_grouped

__all__ = [
    "FusedSsdFn",
    "Mamba2Weights",
    "Prologue",
    "SpiralBlockFn",
    "mamba2_dual_mixer_fused",
    "mamba2_mixer_fused",
    "spiral_block_fused",
    "spiral_block_ref",
    "spiral_epilogue_cuda",
    "spiral_epilogue_ref",
    "ssd_core_cuda",
    "ssd_core_ref",
    "ssd_mixer_bwd_ref",
    "ssd_mixer_fused_bwd_cuda",
    "ssd_mixer_fused_cuda",
    "ssd_mixer_ref",
]

_KERNEL_SOURCE = "fused_ssd_fwd"
_BWD_SOURCE = "fused_ssd_bwd"
_EPILOGUE_SOURCE = "spiral_epilogue"
_CORE_SOURCE = "ssd_core_fwd"
_KERNEL_MAX_CORE_HEADS = 16  # kernel P: one cluster of up to 8 blocks, two heads each
_KERNEL_D_STATE = 16
_KERNEL_HEADDIM = 64
_KERNEL_CONV = 4
_KERNEL_MAX_STREAMS = 4
_KERNEL_MAX_D_INNER = 2048
_KERNEL_CHUNK = 64  # steps of a chunk in kernels E and F
_NO_LIMIT = (0.0, float("inf"))
_LN_EPS = 1e-5  # the block's LayerNorms (torch's default)
BF16 = torch.bfloat16


class Mamba2Weights(NamedTuple):
    """One Mamba-2 mixer's parameters, as its torch modules hold them."""

    in_w: torch.Tensor  # in_proj.weight (2d + 2n + H, h), rows [z | x | B | C | dt]
    conv_w: torch.Tensor  # conv1d.weight (d + 2n, 1, K)
    conv_b: torch.Tensor  # conv1d.bias (d + 2n,)
    dt_bias: torch.Tensor  # (H,)
    A_log: torch.Tensor  # (H,); A = -exp(A_log)
    D: torch.Tensor  # (H,)
    norm_w: torch.Tensor  # norm.weight (d,)
    out_w: torch.Tensor  # out_proj.weight (h, d)


class Prologue(NamedTuple):
    """What kernel E's prologue mode computes in front of in_proj:
    ``LN(x) * ln_w + ln_b``, ``* (1 + scale) + shift``, and for the second
    branch ``* wmask``."""

    wmask: torch.Tensor  # (B, L, 1) soft mask
    ln_w: torch.Tensor  # (h,)
    ln_b: torch.Tensor  # (h,)
    shift: torch.Tensor  # (B, h)
    scale: torch.Tensor  # (B, h)


def ssd_mixer_ref(
    spec: ScanSpec,
    x: torch.Tensor,
    w: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT,
    eps: float = 1e-5,
    chunk_size: int = 256,
    ngroups: int = 1,
    scan=None,
) -> torch.Tensor:
    """The mixer from PyTorch operators: project, then fan out the streams (a
    per-token matmul commutes with the token permutation, and projecting first
    is S times less work), conv, ``ssd_chunked`` (or ``scan``, with its
    arguments, where one is given: the sequence-parallel scan), the gated
    norm per stream, merge, out_proj; in x's dtype, with the weights cast to
    it at the projections (the composable route)."""
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d = w.out_w.shape[1]
    fwd, merge = index_tables(spec, x.device)

    zxbcdt = F.linear(x, w.in_w.to(x.dtype))  # (B, L, 2d + 2gn + H)
    xs = zxbcdt.index_select(1, fwd).reshape(B_ * S, Ls, -1)
    y = _core(xs, w, dt_limit, eps, chunk_size, ngroups, scan=scan)
    merged = y.reshape(B_, S * Ls, d).index_select(1, merge)
    merged = merged.reshape(B_, L, spec.merge.shape[1], d).sum(dim=2) * spec.scale
    return F.linear(merged, w.out_w.to(x.dtype))


def _core(zx: torch.Tensor, w, dt_limit, eps: float, chunk_size: int, ngroups: int,
          **ssd_kw) -> torch.Tensor:
    """The mixer's middle on gathered streams ``zx (N, Ls, 2d + 2gn + H)``
    with one weight set ``w`` (its core fields): conv, ``ssd_chunked``, the
    gated norm; ``(N, Ls, d)``."""
    d = w.norm_w.shape[0]
    z, y = _conv_ssd(zx, w, dt_limit, chunk_size, ngroups, **ssd_kw)
    return rms_norm_gated(y, w.norm_w, z, eps=eps, group_size=d // ngroups, norm_before_gate=False)


def _conv_ssd(zx: torch.Tensor, w, dt_limit, chunk_size: int, ngroups: int, scan=None,
              **ssd_kw):
    """z and the pre-gate SSD output y ``(N, Ls, d)`` of gathered streams
    ``zx``; ``ssd_kw`` goes to ``ssd_chunked`` (``lowp=True``: the SSD's
    intra-chunk products on bf16 operands); ``scan``, one B/C group's scan
    with ``ssd_chunked``'s arguments, replaces ``ssd_chunked_grouped``."""
    N, Ls, _ = zx.shape
    d = w.norm_w.shape[0]
    H = w.A_log.shape[0]
    gn = (w.conv_w.shape[0] - d) // 2  # ngroups * d_state
    z, xBC, dt = zx.split([d, d + 2 * gn, H], dim=-1)
    xBC = causal_conv1d(xBC, w.conv_w[:, 0, :], w.conv_b)
    x_ssm, B_ssm, C_ssm = xBC.split([d, gn, gn], dim=-1)
    if scan is None:
        scan = functools.partial(ssd_chunked_grouped, ngroups=ngroups)
    y = scan(
        x_ssm.reshape(N, Ls, H, d // H), dt.float(), -torch.exp(w.A_log.float()),
        B_ssm, C_ssm, w.D, dt_bias=w.dt_bias, dt_softplus=True,
        dt_limit=dt_limit, chunk_size=chunk_size, **ssd_kw,
    ).reshape(N, Ls, d)
    return z, y


class _Round(torch.autograd.Function):
    """Rounding to bf16 where a kernel stores a value in bf16. ``value``:
    the value rounds (the gradient passes as it is); ``grad``: the gradient
    rounds (the value passes): a value the kernels keep in bf16 only on the
    way back. Both are fp32 tensors of bf16 values."""

    @staticmethod
    def forward(ctx, t, what):
        ctx.what = what
        return t.to(BF16).float() if what == "value" else t.clone()

    @staticmethod
    def backward(ctx, g):
        return (g.to(BF16).float() if ctx.what == "grad" else g), None


def _lin(a: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``a . weight^T`` on bf16-rounded operands, fp32 sums, fp32 out; the
    gradients as kernel F computes them (``RoundedProduct``)."""
    k = a.shape[-1]
    out = RoundedProduct.apply(a.reshape(-1, k), weight.t())
    return out.reshape(*a.shape[:-1], weight.shape[0])


def _ssd_mixer_fused_lowp(
    spec: ScanSpec, x: torch.Tensor, w: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
) -> torch.Tensor:
    """Kernel E's arithmetic at x's dtype bf16, and under autograd kernel
    F's: where ``diffma_tpu/ops/fused_ssd.py::_ssd_kernel`` casts, it rounds
    (see the module's note on bf16), in chunks of 64 steps as the kernels
    run the SSD; the output is bf16."""
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d = w.out_w.shape[1]
    fwd, merge = index_tables(spec, x.device)
    ident = _identity_streams(spec)

    zx = _Round.apply(_lin(x, w.in_w), "value")  # (B, L, 2d + 2n + H) of bf16 values
    xs = zx.index_select(1, fwd).reshape(B_, S, Ls, -1)
    # A non-identity stream's conv and dt columns: the kernels round their
    # gradient before they add it back to token order (z's is fp32).
    xs = torch.stack([xs[:, s] if ident[s] else torch.cat(
        [xs[:, s, :, :d], _Round.apply(xs[:, s, :, d:], "grad")], dim=-1) for s in range(S)], dim=1)
    z, y = _conv_ssd(xs.reshape(B_ * S, Ls, -1), w, dt_limit, _KERNEL_CHUNK, 1, lowp=True)
    y = y.reshape(B_, S, Ls, d)
    y = torch.stack([y[:, s] if ident[s] else y[:, s].to(BF16).float() for s in range(S)], dim=1)
    normed = rms_norm_gated(y.reshape(B_ * S, Ls, d), w.norm_w, z, eps=eps, group_size=d,
                            norm_before_gate=False)
    parts = normed.reshape(B_, S * Ls, d).index_select(1, merge).reshape(B_, L, -1, d)
    acc = parts[:, :, 0]
    for q in range(1, parts.shape[2]):  # in stream order, as the kernels sum
        acc = acc + parts[:, :, q]
    return _lin(acc * spec.scale, w.out_w).to(BF16)


def _ssd_mixer_plain(spec: ScanSpec, x: torch.Tensor, w: Mamba2Weights, dt_limit, eps,
                     chunk_size: int = 256) -> torch.Tensor:
    """The plain version of kernel E on x's dtype: ``ssd_mixer_ref``, at
    bf16 the kernel's own rounding (``_ssd_mixer_fused_lowp``, which chunks
    as the kernel does and ignores ``chunk_size``)."""
    if x.dtype == BF16:
        return _ssd_mixer_fused_lowp(spec, x, w, dt_limit, eps)
    return ssd_mixer_ref(spec, x, w, dt_limit, eps, chunk_size)


def ssd_core_ref(
    zx: torch.Tensor, ws, dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
    chunk_size: int = 256,
) -> torch.Tensor:
    """Kernel P's plain version: the mixer's middle on ``zx (G, L, 2d + 2n +
    H)``, G gathered streams in stream order, sequence g taking the core
    weights (``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``D``,
    ``norm_w``; ``Mamba2Weights`` serve) of ``ws[g // (G / len(ws))]``.
    Returns the normed streams ``(G, L, d)``, not merged, in zx's dtype; at
    bf16 with the rounding of the TPU kernel (``_ssd_core_lowp``)."""
    per = zx.shape[0] // len(ws)
    core = _ssd_core_lowp if zx.dtype == BF16 else functools.partial(
        _core, chunk_size=chunk_size, ngroups=1)
    return torch.cat([core(zx[m * per : (m + 1) * per], w, dt_limit, eps)
                      for m, w in enumerate(ws)])


def _ssd_core_lowp(zx: torch.Tensor, w, dt_limit, eps: float) -> torch.Tensor:
    """Kernel P's arithmetic at zx's dtype bf16, as
    ``tools/probes/probe_split_ssd.py::_core_kernel`` rounds at a bf16 zx:
    the conv, dt, the cumsum of dt * A (taken in fp64, rounded once), the
    masked decay ``(C_t . B_u) exp(cs_t - cs_u)`` and ``dt_u x_u`` in fp32,
    each of those two rounded to bf16 at the heads' products, which sum in
    fp32 over the whole stream (the TPU kernel's quadratic form); the D skip,
    the gate on z and the RMSNorm fp32; the output bf16."""
    G, L, _ = zx.shape
    d = w.norm_w.shape[0]
    H = w.A_log.shape[0]
    n = (w.conv_w.shape[0] - d) // 2
    z, xBC, dt = zx.float().split([d, d + 2 * n, H], dim=-1)
    x, B_ssm, C_ssm = causal_conv1d(xBC, w.conv_w[:, 0, :], w.conv_b).split([d, n, n], dim=-1)
    dt = F.softplus(dt + w.dt_bias.float()).clamp(*dt_limit)
    cs = torch.cumsum(dt.double() * -torch.exp(w.A_log.double()), dim=1).float()  # (G, L, H)
    causal = torch.ones(L, L, dtype=torch.bool, device=zx.device).tril()[None, :, :, None]
    decay = torch.exp((cs[:, :, None] - cs[:, None]).masked_fill(~causal, -math.inf))
    mh = (torch.einsum("gtn,gun->gtu", C_ssm, B_ssm)[..., None] * decay).to(BF16).float()
    xdt = (x.reshape(G, L, H, -1) * dt[..., None]).to(BF16).float()
    y = torch.einsum("gtuh,guhc->gthc", mh, xdt).reshape(G, L, d)
    y = y + w.D.float().repeat_interleave(d // H) * x
    yg = y * F.silu(z)
    rms = torch.rsqrt(yg.square().mean(dim=-1, keepdim=True) + eps)
    return (yg * rms * w.norm_w.float()).to(BF16)


def ssd_mixer_bwd_ref(
    spec: ScanSpec, x: torch.Tensor, g: torch.Tensor, w: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
) -> Tuple[torch.Tensor, Mamba2Weights]:
    """The mixer's backward by autograd over kernel E's plain version
    (``ssd_mixer_ref``; at bf16 ``_ssd_mixer_fused_lowp``): the gradients of
    ``<g, out>`` with respect to x and each weight."""
    leaves = [t.detach().requires_grad_() for t in (x, *w)]
    with torch.enable_grad():
        out = _ssd_mixer_plain(spec, leaves[0], Mamba2Weights(*leaves[1:]), dt_limit, eps)
        grads = torch.autograd.grad(out, leaves, g)
    return grads[0], Mamba2Weights(*grads[1:])


def spiral_epilogue_ref(
    o0: torch.Tensor, o1: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
    an_w: torch.Tensor, an_b: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
) -> torch.Tensor:
    """The block's tail: LayerNorm over the concat of the branch outputs, a
    2h -> h SiLU layer, a sigmoid h -> 1 head alpha, and
    ``x + gate * (alpha * o0 + (1 - alpha) * o1)``. Weights in torch layout:
    ``fc1_w (h, 2h)``, ``fc2_w (1, h)``. At bf16 (the branch outputs and x
    bf16), kernel G's rounding: the normed concat and fc1, silu(h) and fc2
    rounded at the products, fp32 sums, bias and tail; the output bf16."""
    if x.dtype == BF16:
        hmid = layer_norm(torch.cat([o0, o1], dim=-1).float(), an_w, an_b, eps=_LN_EPS)
        hpre = _lin(hmid, fc1_w) + fc1_b.float()
        alpha = torch.sigmoid(_lin(F.silu(hpre), fc2_w) + fc2_b.float())
        mixed = alpha * o0.float() + (1.0 - alpha) * o1.float()
        return (x.float() + gate.float()[:, None, :] * mixed).to(BF16)
    return _tail(o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b)


def _tail(o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b) -> torch.Tensor:
    """The block's tail in x's dtype, the weights cast to it at the
    products: in fp32 ``spiral_epilogue_ref``, at bf16 the JAX block's
    ``_spiral_block_ref``."""
    cd = x.dtype
    hmid = layer_norm(torch.cat([o0, o1], dim=-1), an_w, an_b, eps=_LN_EPS)
    hmid = F.silu(F.linear(hmid, fc1_w.to(cd), fc1_b.to(cd)))
    alpha = torch.sigmoid(F.linear(hmid, fc2_w.to(cd), fc2_b.to(cd)))
    return x + gate[:, None, :] * (alpha * o0 + (1.0 - alpha) * o1)


def _modulated(x: torch.Tensor, pro: Prologue) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm, modulation and the second branch's mask in x's dtype."""
    xm = layer_norm(x, pro.ln_w, pro.ln_b, eps=_LN_EPS)
    xm = xm * (1.0 + pro.scale[:, None, :]) + pro.shift[:, None, :]
    return xm, xm * pro.wmask


def _modulated_fp32(x: torch.Tensor, pro: Prologue) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's prologue: LayerNorm, modulation and mask in fp32, both
    branches' inputs rounded to x's dtype."""
    xm = layer_norm(x.float(), pro.ln_w, pro.ln_b, eps=_LN_EPS)
    xm = xm * (1.0 + pro.scale.float()[:, None, :]) + pro.shift.float()[:, None, :]
    return xm.to(x.dtype), (xm * pro.wmask.float()).to(x.dtype)


def spiral_block_ref(
    spec: ScanSpec, x, wmask, shift, scale, gate, ln_w, ln_b, an_w, an_b, fc1_w, fc1_b,
    fc2_w, fc2_b, w0: Mamba2Weights, w1: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
) -> torch.Tensor:
    """The whole Spiral block from the plain versions, in x's dtype: at bf16
    the composition the JAX block's backward recomputes (``_tail``)."""
    x0, x1 = _modulated(x, Prologue(wmask, ln_w, ln_b, shift, scale))
    o0 = _ssd_mixer_plain(spec, x0, w0, dt_limit, eps)
    o1 = _ssd_mixer_plain(spec, x1, w1, dt_limit, eps)
    return _tail(o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b)


def _check_spec(spec: ScanSpec) -> None:
    """Raise on a spec that kernel E does not run."""
    # Mamba-2 never takes the Mamba-1 vim quirk: vim specs merge the standard way.
    if not mixer_fused_eligible(spec, partition=True):
        raise NotImplementedError(
            "the fused SSD mixer takes full-length stream permutations and exact partitions "
            "of the tokens"
        )


def _check_spec_prologue(spec: ScanSpec) -> None:
    """Raise on a spec that kernel E's prologue mode does not run."""
    if not mixer_fused_eligible(spec):
        raise NotImplementedError(
            "kernel E's prologue mode (the whole Spiral block) takes full-length stream "
            "permutations only; a partition spec runs through the one- and two-mixer modes"
        )


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _check_tensors(named, device) -> None:
    """``named``: (name, tensor, shape) or (name, tensor, shape, dtype), the
    dtype fp32 where none is given."""
    for name, t, shape, *dtype in named:
        dtype = dtype[0] if dtype else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {_name(dtype)}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(name: str, t: torch.Tensor, B_: int, h: int, device, dtype) -> None:
    """A (B, h) chunk of the adaLN output: rows may lie a stride apart."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (B_, h):
        raise ValueError(f"{name} must be {_name(dtype)} ({B_}, {h}) on {device}")
    if t.stride(1) != 1:
        raise ValueError(f"{name} must be contiguous along its last axis")


def _check_kernel_inputs(spec: ScanSpec, xs, ws, pro: Optional[Prologue]) -> dict:
    """Raise on what kernel E does not take; return its dimensions."""
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"the CUDA fused SSD mixer needs CUDA tensors, got {x0.device}")
    if x0.dtype not in _DTYPE_CODE:
        raise ValueError(f"x0 must be float32 or bfloat16, got {x0.dtype}")
    if x0.dim() != 3:
        raise ValueError(f"x must be (B, L, h), got {tuple(x0.shape)}")
    B_, L, h = x0.shape
    if L != spec.seq_len:
        raise ValueError(f"x has {L} tokens, the scan spec {spec.seq_len}")
    d = ws[0].out_w.shape[-1]
    H = ws[0].A_log.shape[0]
    K = ws[0].conv_w.shape[-1]
    n, rem = divmod(ws[0].conv_w.shape[0] - d, 2)
    if rem or n != _KERNEL_D_STATE:
        raise ValueError(
            f"the kernel is built for one B/C group of d_state {_KERNEL_D_STATE}, got "
            f"{ws[0].conv_w.shape[0] - d} B and C columns"
        )
    if d != H * _KERNEL_HEADDIM:
        raise ValueError(f"the kernel is built for headdim {_KERNEL_HEADDIM}, got d {d}, H {H}")
    if d > _KERNEL_MAX_D_INNER:
        raise ValueError(f"the kernel takes d_inner up to {_KERNEL_MAX_D_INNER}, got {d}")
    if K != _KERNEL_CONV:
        raise ValueError(f"the kernel is built for {_KERNEL_CONV} conv taps, got {K}")
    if spec.n_streams > _KERNEL_MAX_STREAMS:
        raise ValueError(f"the kernel takes up to {_KERNEL_MAX_STREAMS} streams")
    dproj, conv_dim = 2 * d + 2 * n + H, d + 2 * n
    shapes = Mamba2Weights(
        in_w=(dproj, h), conv_w=(conv_dim, 1, K), conv_b=(conv_dim,), dt_bias=(H,),
        A_log=(H,), D=(H,), norm_w=(d,), out_w=(h, d),
    )
    named = [(f"x{i}", x, (B_, L, h), x0.dtype) for i, x in enumerate(xs)]
    for i, w in enumerate(ws):
        named += [(f"w{i}.{f}", t, s) for f, t, s in zip(Mamba2Weights._fields, w, shapes)]
    if pro is not None:
        named += [("wmask", pro.wmask, (B_, L, 1), x0.dtype), ("ln_w", pro.ln_w, (h,)),
                  ("ln_b", pro.ln_b, (h,))]
        for name in ("shift", "scale"):
            _check_rows(name, getattr(pro, name), B_, h, x0.device, x0.dtype)
        if pro.shift.stride(0) != pro.scale.stride(0):
            raise ValueError("shift and scale must have the same row stride")
    _check_tensors(named, x0.device)
    for i, w in enumerate(ws):
        if w.conv_w.data_ptr() % 16:  # read as one float4 per channel
            raise ValueError(f"w{i}.conv_w must be 16-byte aligned")
    return dict(B=B_, L=L, Ls=spec.stream_len, h=h, d=d, n=n, H=H, K=K, S=spec.n_streams,
                dtype=_DTYPE_CODE[x0.dtype],
                ident=sum(1 << s for s, i in enumerate(_identity_streams(spec)) if i))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.load(_KERNEL_SOURCE)
    fwd = lib.ssd_mixer_fwd
    fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 9
        + [ctypes.c_float] * 4
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    size = lib.ssd_mixer_workspace_floats
    size.argtypes = [ctypes.c_int] * 9
    size.restype = ctypes.c_longlong
    return fwd, size


def ssd_mixer_fused_cuda(
    spec: ScanSpec, xs, ws, dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
    prologue: Optional[Prologue] = None, want_res: bool = False,
):
    """Launch kernel E on the current stream for the mixers ``ws[m]`` applied
    to ``xs[m]`` (one or two of them); returns their outputs. With
    ``prologue``, ``xs`` is the block's one input ``(x,)``, ``ws`` both
    branches' weights, and the kernel computes LayerNorm, modulation and the
    second branch's soft mask itself; the two outputs are the halves of one
    ``(2, B, L, h)`` tensor. A partition spec runs in the one- and two-mixer
    modes, not in prologue mode.

    With ``want_res`` (residual mode) it returns ``(outputs, zx)``: ``zx (M,
    B * L, 2d + 2n + H)`` is in_proj's output in token order, which kernel F
    reads in the backward. The kernel writes it into a tensor of its own in
    either mode, so the outputs are the same bit for bit; without
    ``want_res`` it is dropped with the workspace.

    x (and in prologue mode wmask, shift and scale) fp32 or bf16, the
    outputs x's dtype; the weights fp32; zx fp32 (at bf16 it holds bf16
    values). Raises on inputs the kernel does not take;
    ``ssd_mixer_fused_cuda.launches`` counts the fp32 calls,
    ``ssd_mixer_fused_cuda.bf16.launches`` the bf16 ones.
    """
    _check_spec(spec)
    M = len(ws)
    if M not in (1, 2) or len(xs) != (1 if prologue is not None else M):
        raise ValueError(f"{len(xs)} inputs for {M} mixers")
    if prologue is not None and M != 2:
        raise ValueError("prologue mode runs both branches of a block")
    if prologue is not None and want_res:
        raise ValueError("prologue mode writes no residual: kernel F takes the mixers' inputs")
    if prologue is not None:
        _check_spec_prologue(spec)
    dims = _check_kernel_inputs(spec, xs, ws, prologue)
    fwd_fn, size_fn = _kernel_fns()
    x0 = xs[0]
    out = torch.empty((M, *x0.shape), dtype=x0.dtype, device=x0.device)
    workspace = torch.empty(
        size_fn(M, dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["H"], dims["S"],
                int(prologue is not None)),
        dtype=torch.float32, device=x0.device,
    )
    dproj = 2 * dims["d"] + 2 * dims["n"] + dims["H"]
    zx = torch.empty((M, dims["B"] * dims["L"], dproj), dtype=torch.float32, device=x0.device)
    fwd, _ = index_tables(spec, x0.device)
    ptrs = []
    for m, w in enumerate(ws):
        x = x0 if prologue is not None else xs[m]
        ptrs += [x.data_ptr(), *(t.data_ptr() for t in w), out[m].data_ptr()]
    pro_ptrs, mod_stride = None, 0
    if prologue is not None:
        pro_ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in prologue))
        mod_stride = prologue.shift.stride(0)
    err = fwd_fn(
        (ctypes.c_void_p * len(ptrs))(*ptrs), M, fwd.data_ptr(), workspace.data_ptr(),
        zx.data_ptr(), pro_ptrs, mod_stride, _LN_EPS, dims["B"], dims["L"], dims["Ls"], dims["h"],
        dims["d"], dims["n"], dims["H"], dims["K"], dims["S"], float(spec.scale), float(eps),
        float(dt_limit[0]), float(dt_limit[1]), dims["dtype"], dims["ident"],
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_mixer_fwd launch failed: error {err}")
    _count(ssd_mixer_fused_cuda, dims["dtype"])
    outs = tuple(out.unbind(0))
    return (outs, zx) if want_res else outs


ssd_mixer_fused_cuda.launches = 0
ssd_mixer_fused_cuda.bf16 = LaunchCount()


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fns():
    lib = cuda_build.load(_BWD_SOURCE)
    bwd = lib.ssd_mixer_bwd
    bwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9
        + [ctypes.c_float] * 4
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    size = lib.ssd_mixer_bwd_workspace_floats
    size.argtypes = [ctypes.c_int] * 8
    size.restype = ctypes.c_longlong
    return bwd, size


def ssd_mixer_fused_bwd_cuda(
    spec: ScanSpec, xs, gs, ws, residual: torch.Tensor,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
):
    """Launch kernel F on the current stream: the backward of the mixers
    ``ws[m]`` applied to ``xs[m]``, given ``gs[m]`` = dL/dout (one or two of
    them) and the ``residual`` that ``ssd_mixer_fused_cuda(..., want_res=True)``
    returned for the same inputs. Returns ``(gxs, grads)``, ``grads[m]`` a
    ``Mamba2Weights`` of gradients. Full-length specs and exact partitions,
    as in kernel E's one- and two-mixer modes.

    x and g fp32 or bf16 (gx their dtype), the weights and their gradients
    fp32. Raises on inputs the kernel does not take;
    ``ssd_mixer_fused_bwd_cuda.launches`` counts the fp32 calls,
    ``ssd_mixer_fused_bwd_cuda.bf16.launches`` the bf16 ones.
    """
    _check_spec(spec)
    M = len(ws)
    if M not in (1, 2) or len(xs) != M:
        raise ValueError(f"{len(xs)} inputs for {M} mixers")
    dims = _check_kernel_inputs(spec, xs, ws, None)
    if len(gs) != M:
        raise ValueError(f"{M} inputs but {len(gs)} output gradients")
    x0 = xs[0]
    dproj = 2 * dims["d"] + 2 * dims["n"] + dims["H"]
    _check_tensors(
        [(f"g{i}", g, tuple(x0.shape), x0.dtype) for i, g in enumerate(gs)]
        + [("residual", residual, (M, dims["B"] * dims["L"], dproj))],
        x0.device,
    )
    bwd_fn, size_fn = _bwd_kernel_fns()
    gxs = tuple(torch.empty_like(x) for x in xs)
    grads = tuple(Mamba2Weights(*(torch.empty_like(t) for t in w)) for w in ws)
    workspace = torch.empty(
        size_fn(M, dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["H"], dims["S"]),
        dtype=torch.float32, device=x0.device,
    )
    fwd, merge = index_tables(spec, x0.device)
    ptrs = []
    for x, g, w, gx, gw in zip(xs, gs, ws, gxs, grads):
        ptrs += [x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in w),
                 gx.data_ptr(), *(t.data_ptr() for t in gw)]
    err = bwd_fn(
        (ctypes.c_void_p * len(ptrs))(*ptrs), M, fwd.data_ptr(), merge.data_ptr(),
        residual.data_ptr(), workspace.data_ptr(), dims["B"], dims["L"], dims["Ls"], dims["h"],
        dims["d"], dims["n"], dims["H"], dims["K"], dims["S"], float(spec.scale), float(eps),
        float(dt_limit[0]), float(dt_limit[1]), dims["dtype"], dims["ident"],
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_mixer_bwd launch failed: error {err}")
    _count(ssd_mixer_fused_bwd_cuda, dims["dtype"])
    return gxs, grads


ssd_mixer_fused_bwd_cuda.launches = 0
ssd_mixer_fused_bwd_cuda.bf16 = LaunchCount()


def _split(M: int, tensors):
    n = len(Mamba2Weights._fields)
    xs = tuple(tensors[:M])
    ws = tuple(Mamba2Weights(*tensors[M + n * i : M + n * (i + 1)]) for i in range(M))
    return xs, ws


class FusedSsdFn(torch.autograd.Function):
    """One or two Mamba-2 mixers with kernel E forward and kernel F backward.

    ``apply(spec, M, dt_limit, eps, *xs, *weights)`` with the M inputs first,
    then the 8 weights of each mixer in ``Mamba2Weights`` order; returns the
    M outputs. The forward runs kernel E in residual mode and keeps the
    inputs, the weights and the residual for the backward's one call of F.
    """

    @staticmethod
    def forward(ctx, spec, M, dt_limit, eps, *tensors):
        xs, ws = _split(M, tensors)
        outs, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, eps, want_res=True)
        ctx.spec, ctx.M, ctx.dt_limit, ctx.eps = spec, M, dt_limit, eps
        ctx.save_for_backward(*tensors, zx)
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        *tensors, zx = ctx.saved_tensors
        xs, ws = _split(ctx.M, tensors)
        gs = tuple(
            torch.zeros_like(x) if g is None else g.contiguous() for g, x in zip(gouts, xs)
        )
        gxs, grads = ssd_mixer_fused_bwd_cuda(ctx.spec, xs, gs, ws, zx, ctx.dt_limit, ctx.eps)
        return (None, None, None, None, *gxs, *(t for gw in grads for t in gw))


@functools.lru_cache(maxsize=None)
def _epilogue_fns():
    lib = cuda_build.load(_EPILOGUE_SOURCE)
    fwd = lib.spiral_epilogue_fwd
    fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    size = lib.spiral_epilogue_workspace_floats
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    return fwd, size


def spiral_epilogue_cuda(
    o0: torch.Tensor, o1: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
    an_w: torch.Tensor, an_b: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
) -> torch.Tensor:
    """Launch kernel G on the current stream: ``spiral_epilogue_ref`` of the
    same arguments. ``gate (B, h)`` may be a chunk of the adaLN output (rows a
    stride apart); everything else is contiguous. o0, o1, x, gate and the
    output are fp32 or bf16 (all one dtype), the weights fp32.

    Raises on inputs the kernel does not take;
    ``spiral_epilogue_cuda.launches`` counts the fp32 calls,
    ``spiral_epilogue_cuda.bf16.launches`` the bf16 ones.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA spiral epilogue needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, h), got {tuple(x.shape)}")
    B_, L, h = x.shape
    _check_tensors(
        [("o0", o0, (B_, L, h), x.dtype), ("o1", o1, (B_, L, h), x.dtype),
         ("x", x, (B_, L, h), x.dtype), ("an_w", an_w, (2 * h,)), ("an_b", an_b, (2 * h,)),
         ("fc1_w", fc1_w, (h, 2 * h)), ("fc1_b", fc1_b, (h,)), ("fc2_w", fc2_w, (1, h)),
         ("fc2_b", fc2_b, (1,))],
        x.device,
    )
    _check_rows("gate", gate, B_, h, x.device, x.dtype)
    if h % 4 or gate.stride(0) % 4 or any(t.data_ptr() % 16 for t in (
            o0, o1, x, gate, an_w, an_b, fc1_w)):
        raise ValueError("kernel G reads rows in fours: h and gate's row stride must be "
                         "multiples of 4 and o0, o1, x, gate, an_w, an_b, fc1_w 16-byte aligned")
    fwd_fn, size_fn = _epilogue_fns()
    out = torch.empty_like(x)
    workspace = torch.empty(size_fn(B_, L, h), dtype=torch.float32, device=x.device)
    tensors = (o0, o1, x, gate, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b, out)
    err = fwd_fn(
        (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors)),
        workspace.data_ptr(), B_, L, h, gate.stride(0), _LN_EPS, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"spiral_epilogue_fwd launch failed: error {err}")
    _count(spiral_epilogue_cuda, _DTYPE_CODE[x.dtype])
    return out


spiral_epilogue_cuda.launches = 0
spiral_epilogue_cuda.bf16 = LaunchCount()


@functools.lru_cache(maxsize=None)
def _core_kernel_fns():
    lib = cuda_build.load(_CORE_SOURCE)
    fwd = lib.ssd_core_fwd
    fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6
        + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    size = lib.ssd_core_workspace_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return fwd, size


def ssd_core_cuda(
    zx: torch.Tensor, ws, dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch kernel P on the current stream: ``ssd_core_ref`` of the same
    arguments, ``ws`` one or two weight sets (``Mamba2Weights``; in_w and
    out_w are not read); zx and the output float32 or bfloat16, the weights
    float32.

    Raises on inputs the kernel does not take; ``ssd_core_cuda.launches``
    counts the fp32 calls, ``ssd_core_cuda.bf16.launches`` the bf16 ones.
    """
    if zx.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel P takes zx in float32 or bfloat16, got {zx.dtype}")
    if zx.device.type != "cuda":
        raise ValueError(f"kernel P, the CUDA SSD core, needs CUDA tensors, got {zx.device}")
    M = len(ws)
    if M not in (1, 2) or zx.dim() != 3 or zx.shape[0] % M:
        raise ValueError(f"zx must be (G, L, dproj) with G a multiple of {M} weight sets, got "
                         f"{tuple(zx.shape)}")
    G, L, _ = zx.shape
    d = ws[0].norm_w.shape[0]
    H = ws[0].A_log.shape[0]
    K = ws[0].conv_w.shape[-1]
    n, rem = divmod(ws[0].conv_w.shape[0] - d, 2)
    if rem or n != _KERNEL_D_STATE or K != _KERNEL_CONV:
        raise ValueError(f"the kernel is built for one B/C group of d_state {_KERNEL_D_STATE} "
                         f"and {_KERNEL_CONV} conv taps")
    if d != H * _KERNEL_HEADDIM or H > _KERNEL_MAX_CORE_HEADS or H % 4:
        raise ValueError(f"the kernel is built for headdim {_KERNEL_HEADDIM} and a multiple of 4 "
                         f"heads up to {_KERNEL_MAX_CORE_HEADS}, got d {d}, H {H}")
    conv_dim = d + 2 * n
    named = [("zx", zx, (G, L, 2 * d + 2 * n + H), zx.dtype)]
    for i, w in enumerate(ws):
        named += [(f"w{i}.conv_w", w.conv_w, (conv_dim, 1, K)),
                  (f"w{i}.conv_b", w.conv_b, (conv_dim,)), (f"w{i}.dt_bias", w.dt_bias, (H,)),
                  (f"w{i}.A_log", w.A_log, (H,)), (f"w{i}.D", w.D, (H,)),
                  (f"w{i}.norm_w", w.norm_w, (d,))]
    _check_tensors(named, zx.device)
    for name, t in [("zx", zx)] + [(f"w{i}.{k}", getattr(w, k)) for i, w in enumerate(ws)
                                   for k in ("conv_w", "conv_b", "norm_w")]:
        if t.data_ptr() % 16:  # read in float4s
            raise ValueError(f"{name} must be 16-byte aligned")
    fwd_fn, size_fn = _core_kernel_fns()
    out = torch.empty((G, L, d), dtype=zx.dtype, device=zx.device)
    workspace = torch.empty(size_fn(M, G, L, d, H), dtype=torch.float32, device=zx.device)
    ptrs = [t.data_ptr() for w in ws
            for t in (w.conv_w, w.conv_b, w.dt_bias, w.A_log, w.D, w.norm_w)]
    err = fwd_fn(
        (ctypes.c_void_p * len(ptrs))(*ptrs), M, zx.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), G, L, d, n, H, K, float(eps), float(dt_limit[0]),
        float(dt_limit[1]), _DTYPE_CODE[zx.dtype],
        torch.cuda.current_stream(zx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_core_fwd launch failed: error {err}")
    _count(ssd_core_cuda, _DTYPE_CODE[zx.dtype])
    return out


ssd_core_cuda.launches = 0
ssd_core_cuda.bf16 = LaunchCount()


def _use_kernels(impl: str, tensors) -> bool:
    """Whether the call goes to the CUDA kernels."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl: {impl!r}")
    return impl != "ref" and tensors[0].device.type == "cuda"


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _mixers_cuda(spec: ScanSpec, xs, ws, dt_limit, eps) -> Tuple[torch.Tensor, ...]:
    """Kernel E on CUDA tensors: through ``FusedSsdFn`` when a gradient is
    needed, else plainly, with no residual written."""
    flat = (*xs, *(t for w in ws for t in w))
    if _needs_grad(flat):
        return FusedSsdFn.apply(spec, len(ws), tuple(dt_limit), eps, *flat)
    return ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, eps)


def _mixers(spec: ScanSpec, xs, ws, dt_limit, eps) -> Tuple[torch.Tensor, ...]:
    """The fused route's mixers: kernels E and F on CUDA tensors, their plain
    version under autograd elsewhere."""
    if xs[0].device.type == "cuda":
        return _mixers_cuda(spec, xs, ws, dt_limit, eps)
    return tuple(_ssd_mixer_plain(spec, x, w, dt_limit, eps) for x, w in zip(xs, ws))


def _spiral_block_composed(spec: ScanSpec, block, w0, w1, dt_limit, eps) -> torch.Tensor:
    """The block as its backward differentiates it: the prologue and the tail
    from torch operators in x's dtype around the fused route's mixers (at
    bf16 the JAX block's ``_spiral_block_ref``)."""
    x, wmask, shift, scale, gate, ln_w, ln_b, *tail = block
    x0, x1 = _modulated(x, Prologue(wmask, ln_w, ln_b, shift, scale))
    o0, o1 = _mixers(spec, (x0, x1), (w0, w1), dt_limit, eps)
    return _tail(o0, o1, x, gate, *tail)


_N_BLOCK = 13  # x, wmask, shift, scale, gate, ln_w, ln_b and the tail's six


def _split_block(tensors):
    n = len(Mamba2Weights._fields)
    return (tuple(tensors[:_N_BLOCK]), Mamba2Weights(*tensors[_N_BLOCK : _N_BLOCK + n]),
            Mamba2Weights(*tensors[_N_BLOCK + n :]))


class SpiralBlockFn(torch.autograd.Function):
    """The whole Spiral block with kernel E in prologue mode and kernel G
    forward (their plain versions on CPU tensors); the backward recomputes
    the block through ``_spiral_block_composed`` (kernel E in residual mode
    on the card) and differentiates that (kernel F and torch autograd), so
    the gradients are exact and cost one more forward.

    ``apply(spec, dt_limit, eps, *block, *w0, *w1)`` with the 13 block
    tensors in ``spiral_block_fused``'s order.
    """

    @staticmethod
    def forward(ctx, spec, dt_limit, eps, *tensors):
        ctx.spec, ctx.dt_limit, ctx.eps = spec, dt_limit, eps
        ctx.save_for_backward(*tensors)
        return _spiral_block_kernels(spec, *_split_block(tensors), dt_limit, eps)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = _spiral_block_composed(ctx.spec, *_split_block(leaves), ctx.dt_limit, ctx.eps)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], g))
        return (None, None, None, *(next(grads) if n else None for n in needs))


def _spiral_block_kernels(spec: ScanSpec, block, w0, w1, dt_limit, eps) -> torch.Tensor:
    """Kernel E in prologue mode and kernel G on CUDA tensors; elsewhere
    their plain versions."""
    x, wmask, shift, scale, gate, ln_w, ln_b, *tail = block
    pro = Prologue(wmask, ln_w, ln_b, shift, scale)
    if x.device.type == "cuda":
        o0, o1 = ssd_mixer_fused_cuda(spec, (x,), (w0, w1), dt_limit, eps, pro)
        return spiral_epilogue_cuda(o0, o1, x, gate, *tail)
    x0, x1 = _modulated_fp32(x, pro)
    o0, o1 = (_ssd_mixer_plain(spec, xi, w, dt_limit, eps) for xi, w in ((x0, w0), (x1, w1)))
    return spiral_epilogue_ref(o0, o1, x, gate, *tail)


def mamba2_mixer_fused(
    spec: ScanSpec, x: torch.Tensor, w: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5, chunk_size: int = 256,
    impl: str = "auto",
) -> torch.Tensor:
    """One mixer, ``(B, L, h) -> (B, L, h)``, in one call of kernel E on CUDA
    tensors (and one of kernel F in the backward). ``chunk_size`` matters to
    the fp32 plain version only: the kernels cut each stream into chunks of
    64."""
    _check_spec(spec)
    if _use_kernels(impl, (x, *w)):
        return _mixers_cuda(spec, (x,), (w,), dt_limit, eps)[0]
    return _ssd_mixer_plain(spec, x, w, dt_limit, eps, chunk_size)


def mamba2_dual_mixer_fused(
    spec: ScanSpec, x0: torch.Tensor, x1: torch.Tensor, w0: Mamba2Weights, w1: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5, chunk_size: int = 256,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches of a dual block, ``x0 -> w0`` and ``x1 -> w1``, each
    ``(B, L, h)``, in one call of kernel E on CUDA tensors (and one of kernel
    F in the backward)."""
    _check_spec(spec)
    if _use_kernels(impl, (x0, x1, *w0, *w1)):
        return _mixers_cuda(spec, (x0, x1), (w0, w1), dt_limit, eps)
    return (_ssd_mixer_plain(spec, x0, w0, dt_limit, eps, chunk_size),
            _ssd_mixer_plain(spec, x1, w1, dt_limit, eps, chunk_size))


def spiral_block_fused(
    spec: ScanSpec, x, wmask, shift, scale, gate, ln_w, ln_b, an_w, an_b, fc1_w, fc1_b,
    fc2_w, fc2_b, w0: Mamba2Weights, w1: Mamba2Weights,
    dt_limit: Tuple[float, float] = _NO_LIMIT, eps: float = 1e-5, impl: str = "auto",
) -> torch.Tensor:
    """The whole Spiral block (LayerNorm, modulate, both SSD mixers, the
    learned mix, the gated residual) in one call of kernel E in prologue mode
    and one of kernel G on CUDA tensors (``SpiralBlockFn`` when a gradient is
    needed); ``spiral_block_ref`` elsewhere in fp32. At bf16 the CPU takes
    the kernels' plain versions forward and ``SpiralBlockFn``'s backward, as
    the card does."""
    _check_spec(spec)
    block = (x, wmask, shift, scale, gate, ln_w, ln_b, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b)
    if _use_kernels(impl, (*block, *w0, *w1)) or (impl == "auto" and x.dtype == BF16):
        _check_spec_prologue(spec)
        if _needs_grad((*block, *w0, *w1)):
            return SpiralBlockFn.apply(spec, tuple(dt_limit), eps, *block, *w0, *w1)
        return _spiral_block_kernels(spec, block, w0, w1, dt_limit, eps)
    return spiral_block_ref(spec, *block, w0, w1, dt_limit, eps)
