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
  ``F.linear``, the plain scan): what the kernel is held against in fp32
  and what the backward differentiates; ``mamba_inner_plain`` is the
  kernel's plain version at either dtype, the forward on CPU tensors.
* ``mamba_inner_fused_cuda``: the hand-written CUDA kernel H
  (``csrc/fused_mamba_fwd.cu``), which replaces the TPU kernel
  ``diffma_tpu/ops/fused_mamba.py::_fused_kernel``; its ``launches``
  attribute counts the calls (each launches four or five device kernels:
  conv, x_proj and dt_proj on the tensor cores in 3xTF32, or in bf16 at
  bf16, the chunked scan, and the sum of x_proj's depth splits when there
  are any), ``mamba_inner_fused_cuda.bf16.launches`` those of its bf16
  variant.

``MambaInnerFn`` carries gradients: forward through kernel H, backward by
recomputing the function through the composable operators
(``mamba_inner_ref`` with the scan kernels A and B) and differentiating that,
as the JAX custom VJP does. ``mamba_inner_fused`` takes it on any device:
its forward launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; ``impl="ref"`` takes ``mamba_inner_ref`` under autograd.

bf16. xz may be bf16 (the JAX package's bf16 model): the weights stay fp32
and the output is bf16. Then the value and the gradient are two functions,
as in JAX. The value is the TPU kernel's rounding (``mamba_inner_plain``, the
plain version of kernel H's bf16 variant): u from xz, convolved and through
SiLU in fp32; x_proj on u and ``xp_w`` rounded to bf16, dt_proj on dt_r and
``dt_w`` rounded to bf16, both with fp32 sums, B, C and dt_b fp32; the scan
fp32 on the unrounded u, the gate on z in fp32; the output rounded to bf16.
The gradient is that of ``mamba_inner_ref`` at bf16, the composable form
through which JAX's custom VJP recomputes (``_fused_ref``): the conv's output
bf16, x_proj in bf16 (B and C bf16), delta fp32, the scan in bf16.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops import cuda_build
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.cuda_build import LaunchCount, _count
from diffma_tpu_torch.ops.selective_scan import _DTYPE_CODE, selective_scan

__all__ = ["MambaInnerFn", "mamba_inner_fused", "mamba_inner_fused_cuda", "mamba_inner_plain",
           "mamba_inner_ref"]

_KERNEL_SOURCE = "fused_mamba_fwd"
_KERNEL_D_STATE = 16
_KERNEL_CONV = 4
_KERNEL_MAX_RANK = 32
_NAMES = ("xz", "conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D")


def mamba_inner_ref(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, scan_impl: str = "ref"):
    """The function from PyTorch operators, with ``selective_scan(impl=scan_impl)``:
    the plain scan by default, the scan kernels A and B with ``"auto"`` on CUDA
    tensors; in xz's dtype, ``xp_w`` cast to it (the composable form)."""
    d = xz.shape[-1] // 2
    r, n = dt_w.shape[1], A.shape[1]
    u, z = xz.split(d, dim=-1)
    u = causal_conv1d(u, conv_w, conv_b)
    dt_r, B_ssm, C_ssm = F.linear(u, xp_w.to(u.dtype)).split([r, n, n], dim=-1)
    delta = F.linear(dt_r.float(), dt_w.float(), dt_b.float())
    return selective_scan(
        u, delta, A.float(), B_ssm.contiguous(), C_ssm.contiguous(), D.float(),
        z=z.contiguous(), impl=scan_impl,
    )


def _dot(a: torch.Tensor, weight: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``a . weight^T`` on operands rounded to ``cd``, summed in fp32."""
    return F.linear(a.to(cd).float(), weight.to(cd).float())


def mamba_inner_plain(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D):
    """Kernel H's plain version at xz's dtype: ``mamba_inner_ref`` in fp32;
    at bf16 the TPU kernel's rounding (``diffma_tpu/ops/fused_mamba.py::
    _fused_kernel``, see the module's note on bf16), with the plain scan."""
    if xz.dtype == torch.float32:
        return mamba_inner_ref(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D)
    cd = xz.dtype
    d = xz.shape[-1] // 2
    r, n = dt_w.shape[1], A.shape[1]
    u, z = xz.float().split(d, dim=-1)
    u = causal_conv1d(u, conv_w, conv_b)
    dt_r, B_ssm, C_ssm = _dot(u, xp_w, cd).split([r, n, n], dim=-1)
    delta = _dot(dt_r, dt_w, cd) + dt_b.float()
    y = selective_scan(u, delta, A.float(), B_ssm.contiguous(), C_ssm.contiguous(), D.float(),
                       z=z.contiguous(), impl="ref")
    return y.to(cd)


def _check_kernel_inputs(tensors) -> dict:
    """Raise on what kernel H does not take; return its dimensions."""
    xz, conv_w, _, xp_w, dt_w, _, A, _ = tensors
    if xz.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel H takes xz in float32 or bfloat16, got {xz.dtype}")
    if xz.device.type != "cuda":
        raise ValueError(f"kernel H, the CUDA fused Mamba inner, needs CUDA tensors, got "
                         f"{xz.device}")
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
        if name != "xz" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dict(G=G, L=L, d=d, n=n, r=r, K=K, dtype=_DTYPE_CODE[xz.dtype])


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.load(_KERNEL_SOURCE)
    fwd = lib.mamba_inner_fwd
    fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    size = lib.mamba_inner_workspace_floats
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return fwd, size


def mamba_inner_fused_cuda(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D) -> torch.Tensor:
    """Launch kernel H on the current stream; returns ``(G, L, d)`` in xz's
    dtype (float32 or bfloat16; the weights float32).

    Raises on inputs the kernel does not take;
    ``mamba_inner_fused_cuda.launches`` counts the fp32 calls,
    ``mamba_inner_fused_cuda.bf16.launches`` the bf16 ones.
    """
    tensors = (xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D)
    dims = _check_kernel_inputs(tensors)
    fwd_fn, size_fn = _kernel_fns()
    out = torch.empty((dims["G"], dims["L"], dims["d"]), dtype=xz.dtype, device=xz.device)
    workspace = torch.empty(
        size_fn(dims["G"], dims["L"], dims["d"], dims["r"]),
        dtype=torch.float32, device=xz.device,
    )
    err = fwd_fn(
        *(t.data_ptr() for t in tensors), out.data_ptr(), workspace.data_ptr(),
        dims["G"], dims["L"], dims["d"], dims["n"], dims["r"], dims["K"], dims["dtype"],
        torch.cuda.current_stream(xz.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_inner_fwd launch failed: error {err}")
    _count(mamba_inner_fused_cuda, dims["dtype"])
    return out


mamba_inner_fused_cuda.launches = 0
mamba_inner_fused_cuda.bf16 = LaunchCount()


class MambaInnerFn(torch.autograd.Function):
    """The function with kernel H forward (its plain version on CPU tensors).
    It has no backward kernel, in either package: the backward recomputes
    the function through ``mamba_inner_ref`` with the scan kernels (A
    forward, B backward; the plain scan on CPU tensors) and differentiates
    that. Saves only the inputs."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.save_for_backward(*tensors)
        if tensors[0].device.type == "cuda":
            return mamba_inner_fused_cuda(*tensors)
        return mamba_inner_plain(*tensors)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = mamba_inner_ref(*leaves, scan_impl="auto")
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], g))
        return tuple(next(grads) if n else None for n in needs)


def mamba_inner_fused(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, impl: str = "auto"):
    """``xz (G, L, 2d) -> (G, L, d)``: ``MambaInnerFn``, whose forward is one
    call of kernel H on CUDA tensors and the plain version on CPU tensors, or
    ``mamba_inner_ref`` with ``impl="ref"``. Either way the result carries
    its gradient."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl: {impl!r}")
    tensors = (xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D)
    if impl == "ref":
        return mamba_inner_ref(*tensors)
    return MambaInnerFn.apply(*tensors)
