"""Whole Mamba-1 mixer: in_proj, streams, scan, merge, out_proj; forward and
backward.

Counterpart of ``diffma_tpu/ops/fused_mixer.py``. The mixer takes the tokens
``x (B, L, h)`` of one layer to ``(B, L, h)``:

    xz = in_proj(x); per stream s (token order fwd[s]): u = silu(conv(xz_u)),
    [dt_r, B, C] = x_proj(u), delta = dt_proj(dt_r) in fp32,
    y_s = selective_scan(u, delta, -exp(A_log), B, C, D, z=xz_z);
    out = out_proj(scale * sum_s y_s, back in token order)

Two implementations of each direction:

* ``mixer_ref``: the plain PyTorch version, the CPU path and the yardstick
  the kernels are held against. In fp32 it is ``mixer_composable`` with the
  plain scan; ``models/mamba.py`` runs the same function with the scan
  kernels A and B. ``mixer_bwd_ref`` is autograd over it.
* ``mixer_fused_cuda``: the hand-written CUDA kernel C
  (``csrc/fused_mixer_fwd.cu``), which replaces the TPU kernel
  ``diffma_tpu/ops/fused_mixer.py::_mixer_kernel``; ``mixer_fused_bwd_cuda``
  is kernel D (``csrc/fused_mixer_bwd.cu``), which replaces
  ``_mixer_bwd_kernel``. One call runs one mixer or both branches of a Spiral
  block; their ``launches`` attributes count calls (each launches a chain of
  device kernels).

``FusedMixerFn`` joins them for autograd: forward through kernel C, backward
through kernel D, saving only the inputs and the weights, as the JAX
monolithic VJP does. ``mamba_mixer_fused`` and ``mamba_dual_mixer_fused``
dispatch on the tensors' device: ``FusedMixerFn`` for CUDA tensors,
``mixer_ref`` (plain autograd) for CPU tensors. ``impl="ref"`` takes the
plain version on any device, to hold the kernels against it on the card.
Weights are in torch layout (``MixerWeights``), fp32 only.

bf16. x may be bf16 (the JAX package's bf16 model, ``dtype=bfloat16``): the
weights stay fp32, the output (and the gradient of x) is bf16, the weights'
gradients fp32. The two routes then round at different places, as the JAX
package's do. ``mixer_composable`` (the composable route) keeps x, xz, u,
x_proj's output, the scan's output and the merge in bf16, casting each
weight to bf16 at its product, with dt_proj in fp32. The fused route
(``mixer_ref`` at bf16, and kernels C and D) rounds where the TPU kernel
casts: xz to bf16, u fp32 and rounded at x_proj's operand, x_proj's output
fp32 and dt_r rounded at dt_proj's operand, the scan and gate fp32, each
stream's output rounded before the merge but for a stream in token order,
the scaled merge rounded, and every product on bf16 operands with an fp32
sum (``_dot``).

Every registry scan spec runs through kernels C and D in their one-mixer
form: full-length permutation streams (spiral, zig, vmamba), the Mamba-1
'vim' spec with its feature-flip quirk (out_proj per stream, the reverse
stream left in reversed token order and its output features flipped), and
exact partitions (EfficientVMamba's four quarter-length atrous streams, each
a sequence of its own). Other specs (streams that neither cover every token
nor partition them) go through ``mamba_inner_fused``; the dual (two-mixer)
call never carries the quirk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops import cuda_build
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused
from diffma_tpu_torch.ops.scan_orders import ScanSpec
from diffma_tpu_torch.ops.selective_scan import _DTYPE_CODE, selective_scan

__all__ = [
    "FusedMixerFn",
    "MixerWeights",
    "index_tables",
    "mamba_dual_mixer_fused",
    "mamba_mixer_fused",
    "mixer_bwd_ref",
    "mixer_composable",
    "mixer_fused_bwd_cuda",
    "mixer_fused_cuda",
    "mixer_fused_eligible",
    "mixer_ref",
]

_KERNEL_SOURCE = "fused_mixer_fwd"
_BWD_SOURCE = "fused_mixer_bwd"
_KERNEL_D_STATE = 16
_KERNEL_CONV = 4
_KERNEL_MAX_RANK = 32
_KERNEL_MAX_STREAMS = 4


class MixerWeights(NamedTuple):
    """One Mamba-1 mixer's parameters, as its torch modules hold them."""

    in_w: torch.Tensor  # in_proj.weight (2d, h)
    conv_w: torch.Tensor  # conv1d.weight (d, 1, K)
    conv_b: torch.Tensor  # conv1d.bias (d,)
    xp_w: torch.Tensor  # x_proj.weight (r + 2n, d)
    dt_w: torch.Tensor  # dt_proj.weight (d, r)
    dt_b: torch.Tensor  # dt_proj.bias (d,)
    A_log: torch.Tensor  # (d, n); A = -exp(A_log)
    D: torch.Tensor  # (d,)
    out_w: torch.Tensor  # out_proj.weight (h, d)


def _exact_partition(spec: ScanSpec) -> bool:
    """Streams jointly cover every token exactly once (atrous partition)."""
    return sorted(spec.fwd.reshape(-1).tolist()) == list(range(spec.seq_len))


def mixer_fused_eligible(spec: ScanSpec, partition: bool = False) -> bool:
    """Full-length permutation streams (spiral / zigma / vim / vmamba) always
    qualify; with ``partition``, exact disjoint partitions (EfficientVMamba's
    atrous streams) do too. The JAX package's rule."""
    if spec.fwd.shape[1] == spec.seq_len:
        return True
    return partition and _exact_partition(spec)


@functools.lru_cache(maxsize=None)
def _identity_streams(spec: ScanSpec) -> Tuple[bool, ...]:
    """Per stream, whether it visits every token in token order: the TPU
    kernel's identity streams, which its merge adds without rounding."""
    S, Ls = spec.fwd.shape
    if Ls != spec.seq_len:
        return (False,) * S
    return tuple(bool((spec.fwd[s] == np.arange(Ls)).all()) for s in range(S))


@functools.lru_cache(maxsize=None)
def index_tables(spec: ScanSpec, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spec's gather table ``fwd`` (S * Ls,) and merge table (L * k,) as
    int64 tensors on ``device``, made once per spec and device so that a
    forward pass copies no index from the host."""
    fwd = torch.as_tensor(spec.fwd.reshape(-1), dtype=torch.long, device=device)
    merge = torch.as_tensor(spec.merge.reshape(-1), dtype=torch.long, device=device)
    return fwd, merge


def mixer_composable(
    spec: ScanSpec, x: torch.Tensor, w: MixerWeights, scan_impl: str = "auto",
    fused_inner: bool = False,
) -> torch.Tensor:
    """The mixer from PyTorch operators, with ``selective_scan(impl=scan_impl)``.

    The streams are gathered before in_proj (a per-token matmul commutes with
    the token permutation), and merged before out_proj (it has no bias). With
    ``fused_inner`` everything between in_proj and the merge is one call of
    ``mamba_inner_fused`` (kernel H on CUDA tensors) and ``scan_impl`` is not
    read. A spec with the Mamba-1 vim quirk is not merged: out_proj runs per
    stream, the reverse stream stays in reversed token order, and its output
    features are flipped before the average.
    """
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d_in, n = w.A_log.shape
    r = w.dt_w.shape[1]
    cd = x.dtype
    fwd, merge = index_tables(spec, x.device)

    xz = F.linear(x.index_select(1, fwd), w.in_w.to(cd)).reshape(B_ * S, Ls, 2 * d_in)
    A = -torch.exp(w.A_log.float())
    if fused_inner:
        y = mamba_inner_fused(xz, w.conv_w[:, 0, :], w.conv_b, w.xp_w, w.dt_w, w.dt_b, A, w.D)
    else:
        u, z = xz.split(d_in, dim=-1)
        u = causal_conv1d(u, w.conv_w[:, 0, :], w.conv_b)
        dt_r, B_ssm, C_ssm = F.linear(u, w.xp_w.to(cd)).split([r, n, n], dim=-1)
        delta = F.linear(dt_r.float(), w.dt_w.float(), w.dt_b.float())
        y = selective_scan(
            u, delta, A, B_ssm.contiguous(), C_ssm.contiguous(), w.D.float(),
            z=z.contiguous(), impl=scan_impl,
        )
    out_w = w.out_w.to(cd)
    if spec.mamba1_vim_quirk:
        ys = y.reshape(B_, S, Ls, d_in)
        out = F.linear(ys[:, 0], out_w) + F.linear(ys[:, 1], out_w).flip(-1)
        return out * spec.scale
    merged = y.reshape(B_, S * Ls, d_in).index_select(1, merge)
    merged = merged.reshape(B_, L, spec.merge.shape[1], d_in).sum(dim=2) * spec.scale
    return F.linear(merged, out_w)


def _dot(a: torch.Tensor, weight: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``a . weight^T`` on operands rounded to ``cd``, summed in fp32."""
    return F.linear(a.to(cd).float(), weight.to(cd).float())


def _mixer_fused_lowp(spec: ScanSpec, x: torch.Tensor, w: MixerWeights) -> torch.Tensor:
    """Kernel C's arithmetic at x's low-precision dtype cd, with the plain
    scan: where ``diffma_tpu/ops/fused_mixer.py::_mixer_kernel`` casts, it
    rounds to cd (see the module's note on bf16); the output is cd."""
    cd = x.dtype
    B_, L, _ = x.shape
    S, Ls = spec.fwd.shape
    d_in, n = w.A_log.shape
    r = w.dt_w.shape[1]
    fwd, merge = index_tables(spec, x.device)

    xz = _dot(x, w.in_w, cd).to(cd)
    xs = xz.index_select(1, fwd).reshape(B_ * S, Ls, 2 * d_in).float()
    u0, z = xs.split(d_in, dim=-1)
    u = causal_conv1d(u0, w.conv_w[:, 0, :], w.conv_b)
    dt_r, B_ssm, C_ssm = _dot(u, w.xp_w, cd).split([r, n, n], dim=-1)
    delta = _dot(dt_r, w.dt_w, cd) + w.dt_b.float()
    y = selective_scan(
        u, delta, -torch.exp(w.A_log.float()), B_ssm.contiguous(), C_ssm.contiguous(),
        w.D.float(), z=z.contiguous(), impl="ref",
    ).reshape(B_, S, Ls, d_in)
    if spec.mamba1_vim_quirk:
        out = _dot(y[:, 0], w.out_w, cd) + _dot(y[:, 1], w.out_w, cd).flip(-1)
        return (out * spec.scale).to(cd)
    ident = _identity_streams(spec)
    y = torch.stack([y[:, s] if ident[s] else y[:, s].to(cd).float() for s in range(S)], dim=1)
    parts = y.reshape(B_, S * Ls, d_in).index_select(1, merge).reshape(B_, L, -1, d_in)
    acc = parts[:, :, 0]
    for q in range(1, parts.shape[2]):  # in stream order, as the kernels sum
        acc = acc + parts[:, :, q]
    return _dot((acc * spec.scale).to(cd), w.out_w, cd).to(cd)


def mixer_ref(spec: ScanSpec, x: torch.Tensor, w: MixerWeights) -> torch.Tensor:
    """The plain version of kernel C: in fp32 ``mixer_composable`` with the
    plain scan, at a lower x dtype kernel C's own rounding."""
    if x.dtype == torch.float32:
        return mixer_composable(spec, x, w, scan_impl="ref")
    return _mixer_fused_lowp(spec, x, w)


def mixer_bwd_ref(
    spec: ScanSpec, x: torch.Tensor, g: torch.Tensor, w: MixerWeights
) -> Tuple[torch.Tensor, MixerWeights]:
    """The mixer's backward by autograd over ``mixer_ref``: the gradients of
    ``<g, mixer_ref(spec, x, w)>`` with respect to x and each weight."""
    leaves = [t.detach().requires_grad_() for t in (x, *w)]
    with torch.enable_grad():
        out = mixer_ref(spec, leaves[0], MixerWeights(*leaves[1:]))
        grads = torch.autograd.grad(out, leaves, g)
    return grads[0], MixerWeights(*grads[1:])


def _check_spec(spec: ScanSpec, M: int = 1) -> None:
    """Raise on a spec that kernel C does not run."""
    if not mixer_fused_eligible(spec, partition=True):
        raise NotImplementedError(
            "the fused mixer takes full-length stream permutations and exact partitions "
            "of the tokens; other specs go through mamba_inner_fused (models/mamba.py)"
        )
    if M == 2 and spec.mamba1_vim_quirk:
        raise ValueError("a dual (two-branch) call never carries the vim quirk")


def _check_kernel_inputs(spec: ScanSpec, xs, ws) -> dict:
    """Raise on what the kernel does not take; return its dimensions."""
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"the CUDA fused mixer needs CUDA tensors, got {x0.device}")
    if x0.dtype not in _DTYPE_CODE:
        raise ValueError(f"x0 must be float32 or bfloat16, got {x0.dtype}")
    if x0.dim() != 3:
        raise ValueError(f"x must be (B, L, h), got {tuple(x0.shape)}")
    B_, L, h = x0.shape
    if L != spec.seq_len:
        raise ValueError(f"x has {L} tokens, the scan spec {spec.seq_len}")
    d, n = ws[0].A_log.shape
    r = ws[0].dt_w.shape[1]
    K = ws[0].conv_w.shape[-1]
    if n != _KERNEL_D_STATE:
        raise ValueError(f"the kernel is built for d_state {_KERNEL_D_STATE}, got {n}")
    if K != _KERNEL_CONV:
        raise ValueError(f"the kernel is built for {_KERNEL_CONV} conv taps, got {K}")
    if not 1 <= r <= _KERNEL_MAX_RANK:
        raise ValueError(f"the kernel takes dt_rank up to {_KERNEL_MAX_RANK}, got {r}")
    if spec.n_streams > _KERNEL_MAX_STREAMS:
        raise ValueError(f"the kernel takes up to {_KERNEL_MAX_STREAMS} streams")
    if spec.mamba1_vim_quirk and spec.n_streams != 2:
        raise ValueError("the vim quirk needs a forward and a reverse stream")
    shapes = MixerWeights(
        in_w=(2 * d, h), conv_w=(d, 1, K), conv_b=(d,), xp_w=(r + 2 * n, d),
        dt_w=(d, r), dt_b=(d,), A_log=(d, n), D=(d,), out_w=(h, d),
    )
    named = [(f"x{i}", x, (B_, L, h), x0.dtype) for i, x in enumerate(xs)]
    for i, w in enumerate(ws):
        named += [(f"w{i}.{f}", t, s, torch.float32)
                  for f, t, s in zip(MixerWeights._fields, w, shapes)]
    for name, t, shape, dtype in named:
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for i, w in enumerate(ws):
        if w.conv_w.data_ptr() % 16:  # read as one float4 per channel
            raise ValueError(f"w{i}.conv_w must be 16-byte aligned")
    return dict(B=B_, L=L, Ls=spec.stream_len, h=h, d=d, n=n, r=r, K=K, S=spec.n_streams,
                quirk=int(spec.mamba1_vim_quirk), dtype=_DTYPE_CODE[x0.dtype],
                ident=sum(1 << s for s, i in enumerate(_identity_streams(spec)) if i))


class LaunchCount:
    """The launch count of a kernel's variant that shares its wrapper with
    another (kernels C's and D's bf16 variants)."""

    def __init__(self):
        self.launches = 0


def _count(wrapper, dtype: int) -> None:
    (wrapper.bf16 if dtype else wrapper).launches += 1


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.load(_KERNEL_SOURCE)
    fwd = lib.mixer_fused_fwd
    fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 10
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    size = lib.mixer_fused_workspace_floats
    size.argtypes = [ctypes.c_int] * 9
    size.restype = ctypes.c_longlong
    return fwd, size


def mixer_fused_cuda(spec: ScanSpec, xs, ws) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on the current stream for the mixers ``ws[m]``
    applied to ``xs[m]`` (one or two of them, fp32 or bf16); returns their
    outputs. One mixer may carry the vim quirk or a partition spec.

    Raises on inputs the kernel does not take; ``mixer_fused_cuda.launches``
    counts the fp32 calls, ``mixer_fused_cuda.bf16.launches`` the bf16 ones.
    """
    M = len(xs)
    _check_spec(spec, M)
    dims = _check_kernel_inputs(spec, xs, ws)
    fwd_fn, size_fn = _kernel_fns()
    x0 = xs[0]
    outs = tuple(torch.empty_like(x) for x in xs)
    workspace = torch.empty(
        size_fn(M, dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["r"],
                dims["S"], dims["quirk"]),
        dtype=torch.float32, device=x0.device,
    )
    fwd, _ = index_tables(spec, x0.device)
    ptrs = []
    for x, w, out in zip(xs, ws, outs):
        ptrs += [x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr()]
    err = fwd_fn(
        (ctypes.c_void_p * len(ptrs))(*ptrs), M, fwd.data_ptr(), workspace.data_ptr(),
        dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["n"], dims["r"], dims["K"],
        dims["S"], dims["quirk"], float(spec.scale), dims["dtype"], dims["ident"],
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mixer_fused_fwd launch failed: error {err}")
    _count(mixer_fused_cuda, dims["dtype"])
    return outs


mixer_fused_cuda.launches = 0
mixer_fused_cuda.bf16 = LaunchCount()


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fns():
    lib = cuda_build.load(_BWD_SOURCE)
    bwd = lib.mixer_fused_bwd
    bwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 10
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    bwd.restype = ctypes.c_int
    size = lib.mixer_fused_bwd_workspace_floats
    size.argtypes = [ctypes.c_int] * 9
    size.restype = ctypes.c_longlong
    return bwd, size


def mixer_fused_bwd_cuda(spec: ScanSpec, xs, gs, ws):
    """Launch kernel D on the current stream: the backward of the mixers
    ``ws[m]`` applied to ``xs[m]``, given ``gs[m]`` = dL/dout (one or two of
    them). Returns ``(gxs, grads)``, ``grads[m]`` a ``MixerWeights`` of
    gradients (dA_log for A_log). Nothing from the forward's call is needed:
    the kernel recomputes the forward from x and the weights. One mixer may
    carry the vim quirk or a partition spec, as in kernel C.

    x and g are fp32 or bf16 (gx their dtype), the weights and their
    gradients fp32. Raises on inputs the kernel does not take;
    ``mixer_fused_bwd_cuda.launches`` counts the fp32 calls,
    ``mixer_fused_bwd_cuda.bf16.launches`` the bf16 ones.
    """
    _check_spec(spec, len(xs))
    dims = _check_kernel_inputs(spec, xs, ws)
    if len(gs) != len(xs):
        raise ValueError(f"{len(xs)} inputs but {len(gs)} output gradients")
    for i, (g, x) in enumerate(zip(gs, xs)):
        if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"g{i} must match x{i}: {x.dtype} {tuple(x.shape)} on {x.device}")
        if not g.is_contiguous():
            raise ValueError(f"g{i} must be contiguous")
    M = len(xs)
    bwd_fn, size_fn = _bwd_kernel_fns()
    x0 = xs[0]
    gxs = tuple(torch.empty_like(x) for x in xs)
    grads = tuple(MixerWeights(*(torch.empty_like(t) for t in w)) for w in ws)
    workspace = torch.empty(
        size_fn(M, dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["r"], dims["S"],
                dims["quirk"]),
        dtype=torch.float32, device=x0.device,
    )
    fwd, merge = index_tables(spec, x0.device)
    ptrs = []
    for x, g, w, gx, gw in zip(xs, gs, ws, gxs, grads):
        ptrs += [x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in w),
                 gx.data_ptr(), *(t.data_ptr() for t in gw)]
    err = bwd_fn(
        (ctypes.c_void_p * len(ptrs))(*ptrs), M, fwd.data_ptr(), merge.data_ptr(),
        workspace.data_ptr(), dims["B"], dims["L"], dims["Ls"], dims["h"], dims["d"], dims["n"],
        dims["r"], dims["K"], dims["S"], dims["quirk"], float(spec.scale), dims["dtype"],
        dims["ident"], torch.cuda.current_stream(x0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mixer_fused_bwd launch failed: error {err}")
    _count(mixer_fused_bwd_cuda, dims["dtype"])
    return gxs, grads


mixer_fused_bwd_cuda.launches = 0
mixer_fused_bwd_cuda.bf16 = LaunchCount()


class FusedMixerFn(torch.autograd.Function):
    """One or two mixers with kernel C forward and kernel D backward.

    ``apply(spec, M, *xs, *weights)`` with the M inputs first, then the 9
    weights of each mixer in ``MixerWeights`` order; returns the M outputs.
    """

    @staticmethod
    def forward(ctx, spec, M, *tensors):
        ctx.spec, ctx.M = spec, M
        ctx.save_for_backward(*tensors)
        xs, ws = _split(M, tensors)
        return mixer_fused_cuda(spec, xs, ws)

    @staticmethod
    def backward(ctx, *gouts):
        xs, ws = _split(ctx.M, ctx.saved_tensors)
        gs = tuple(
            torch.zeros_like(x) if g is None else g.contiguous() for g, x in zip(gouts, xs)
        )
        gxs, grads = mixer_fused_bwd_cuda(ctx.spec, xs, gs, ws)
        return (None, None, *gxs, *(t for gw in grads for t in gw))


def _split(M: int, tensors):
    n = len(MixerWeights._fields)
    xs = tuple(tensors[:M])
    ws = tuple(MixerWeights(*tensors[M + n * i : M + n * (i + 1)]) for i in range(M))
    return xs, ws


def _fused(spec: ScanSpec, xs, ws, impl: str) -> Tuple[torch.Tensor, ...]:
    _check_spec(spec, len(xs))
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "ref" or xs[0].device.type != "cuda":
        return tuple(mixer_ref(spec, x, w) for x, w in zip(xs, ws))
    flat = (*xs, *(t for w in ws for t in w))
    return FusedMixerFn.apply(spec, len(xs), *flat)


def mamba_dual_mixer_fused(
    spec: ScanSpec,
    x0: torch.Tensor,
    x1: torch.Tensor,
    w0: MixerWeights,
    w1: MixerWeights,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches of a dual block, ``x0 -> w0`` and ``x1 -> w1``, each
    ``(B, L, h)``, in one call of kernel C on CUDA tensors (and one of kernel
    D in the backward)."""
    return _fused(spec, (x0, x1), (w0, w1), impl)


def mamba_mixer_fused(
    spec: ScanSpec, x: torch.Tensor, w: MixerWeights, impl: str = "auto"
) -> torch.Tensor:
    """One mixer, ``(B, L, h) -> (B, L, h)``, in one call of kernel C on CUDA
    tensors (and one of kernel D in the backward)."""
    return _fused(spec, (x,), (w,), impl)[0]
