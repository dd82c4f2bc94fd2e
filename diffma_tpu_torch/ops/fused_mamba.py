"""The Mamba-1 mixer's inner part in one call: conv, x_proj, dt_proj, scan, gate.

Counterpart of ``diffma_tpu/ops/fused_mamba.py``. The function takes streams
that are already gathered and projected, ``xz (G, L, 2d)`` with the columns
``[u | z]``, to the gated scan output ``(G, L, d)``:

    u     = silu(causal_conv_K(xz[..., :d]) + conv_b)        (zero left pad)
    [dt_r | B | C] = u . W_x^T
    delta = dt_r . W_dt^T + dt_b                              (fp32)
    y     = selective_scan(u, delta, A, B, C, D, z = xz[..., d:])

in_proj, the stream gather, the merge and out_proj stay outside, as in the
JAX package. ``models/mamba.py`` takes this route with ``scan_impl="fused"``
when the scan spec is one the whole-mixer kernel C cannot run (streams that
are neither full-length nor an exact partition of the tokens).

Weights are in torch layout: ``conv_w (d, K)``, ``conv_b (d,)``, ``xp_w
(r + 2n, d)``, ``dt_w (d, r)``, ``dt_b (d,)``, ``A (d, n)`` (negative, not its
logarithm) and ``D (d,)``.

Two implementations:

* ``mamba_inner_ref``: the plain PyTorch version (``causal_conv1d``, two
  ``F.linear``, the plain scan). The CPU path and what the kernel is held
  against.
* ``mamba_inner_fused_cuda``: the hand-written CUDA kernel H
  (``csrc/fused_mamba_fwd.cu``), which replaces the TPU kernel
  ``diffma_tpu/ops/fused_mamba.py::_fused_kernel``; its ``launches``
  attribute counts the calls (each launches four or five device kernels:
  conv, x_proj and dt_proj on the tensor cores in 3xTF32, the chunked scan,
  and the sum of x_proj's depth splits when there are any).

``MambaInnerFn`` carries gradients: forward through kernel H, backward by
recomputing the function through the composable operators
(``mamba_inner_ref`` with the scan kernels A and B) and differentiating that,
as the JAX custom VJP does. ``mamba_inner_fused`` dispatches on the tensors'
device: the kernel for CUDA tensors, the plain version under autograd for CPU
tensors; ``impl="ref"`` takes the plain version on any device. The kernel is
fp32 only: a bf16 tensor on the card raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops import cuda_build
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.selective_scan import selective_scan

__all__ = ["MambaInnerFn", "mamba_inner_fused", "mamba_inner_fused_cuda", "mamba_inner_ref"]

_KERNEL_SOURCE = "fused_mamba_fwd"
_KERNEL_D_STATE = 16
_KERNEL_CONV = 4
_KERNEL_MAX_RANK = 32
_NAMES = ("xz", "conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D")


def mamba_inner_ref(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, scan_impl: str = "ref"):
    """The function from PyTorch operators, with ``selective_scan(impl=scan_impl)``:
    the plain scan by default, the scan kernels A and B with ``"auto"`` on CUDA
    tensors."""
    d = xz.shape[-1] // 2
    r, n = dt_w.shape[1], A.shape[1]
    u, z = xz.split(d, dim=-1)
    u = causal_conv1d(u, conv_w, conv_b)
    dt_r, B_ssm, C_ssm = F.linear(u, xp_w).split([r, n, n], dim=-1)
    delta = F.linear(dt_r.float(), dt_w.float(), dt_b.float())
    return selective_scan(
        u, delta, A.float(), B_ssm.contiguous(), C_ssm.contiguous(), D.float(),
        z=z.contiguous(), impl=scan_impl,
    )


def _check_kernel_inputs(tensors) -> dict:
    """Raise on what kernel H does not take; return its dimensions."""
    xz, conv_w, _, xp_w, dt_w, _, A, _ = tensors
    if xz.dtype != torch.float32:
        raise ValueError(f"kernel H has no bf16 variant: xz must be float32, got {xz.dtype}")
    if xz.device.type != "cuda":
        raise ValueError(f"the CUDA fused Mamba inner needs CUDA tensors, got {xz.device}")
    if xz.dim() != 3 or xz.shape[-1] % 2:
        raise ValueError(f"xz must be (G, L, 2d), got {tuple(xz.shape)}")
    G, L, dd = xz.shape
    d = dd // 2
    if G < 1 or L < 1:
        raise ValueError(f"xz must hold at least one sequence of one step, got {tuple(xz.shape)}")
    n = A.shape[-1]
    r = dt_w.shape[-1]
    K = conv_w.shape[-1]
    if n != _KERNEL_D_STATE:
        raise ValueError(f"the kernel is built for d_state {_KERNEL_D_STATE}, got {n}")
    if K != _KERNEL_CONV:
        raise ValueError(f"the kernel is built for {_KERNEL_CONV} conv taps, got {K}")
    if not 1 <= r <= _KERNEL_MAX_RANK:
        raise ValueError(f"the kernel takes dt_rank up to {_KERNEL_MAX_RANK}, got {r}")
    shapes = ((G, L, dd), (d, K), (d,), (r + 2 * n, d), (d, r), (d,), (d, n), (d,))
    for name, t, shape in zip(_NAMES, tensors, shapes):
        if t.device != xz.device:
            raise ValueError(f"{name} is on {t.device}, xz on {xz.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dict(G=G, L=L, d=d, n=n, r=r, K=K)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.load(_KERNEL_SOURCE)
    fwd = lib.mamba_inner_fwd
    fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    size = lib.mamba_inner_workspace_floats
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return fwd, size


def mamba_inner_fused_cuda(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D) -> torch.Tensor:
    """Launch kernel H on the current stream; returns ``(G, L, d)``.

    Raises on inputs the kernel does not take;
    ``mamba_inner_fused_cuda.launches`` counts the calls.
    """
    tensors = (xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D)
    dims = _check_kernel_inputs(tensors)
    fwd_fn, size_fn = _kernel_fns()
    out = torch.empty((dims["G"], dims["L"], dims["d"]), dtype=torch.float32, device=xz.device)
    workspace = torch.empty(
        size_fn(dims["G"], dims["L"], dims["d"], dims["r"]),
        dtype=torch.float32, device=xz.device,
    )
    err = fwd_fn(
        *(t.data_ptr() for t in tensors), out.data_ptr(), workspace.data_ptr(),
        dims["G"], dims["L"], dims["d"], dims["n"], dims["r"], dims["K"],
        torch.cuda.current_stream(xz.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_inner_fwd launch failed: error {err}")
    mamba_inner_fused_cuda.launches += 1
    return out


mamba_inner_fused_cuda.launches = 0


class MambaInnerFn(torch.autograd.Function):
    """The function with kernel H forward. It has no backward kernel, in
    either package: the backward recomputes the function through
    ``mamba_inner_ref`` with the scan kernels (A forward, B backward) and
    differentiates that. Saves only the inputs."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.save_for_backward(*tensors)
        return mamba_inner_fused_cuda(*tensors)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = mamba_inner_ref(*leaves, scan_impl="auto")
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], g))
        return tuple(next(grads) if n else None for n in needs)


def mamba_inner_fused(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, impl: str = "auto"):
    """``xz (G, L, 2d) -> (G, L, d)``: one call of kernel H on CUDA tensors,
    the plain version on CPU tensors or with ``impl="ref"``. Either way the
    result carries its gradient."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl: {impl!r}")
    tensors = (xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D)
    if impl == "ref" or xz.device.type != "cuda":
        return mamba_inner_ref(*tensors)
    return MambaInnerFn.apply(*tensors)
