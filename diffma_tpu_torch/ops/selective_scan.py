"""Selective scan (Mamba-1 SSM recurrence), forward and backward.

Counterpart of ``diffma_tpu/ops/selective_scan.py``. The recurrence, per
(g, channel):

    dt_t  = softplus(delta_t)                        # delta includes the bias
    h_t   = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) B_t
    y_t   = <C_t, h_t> + D * u_t
    out_t = y_t * silu(z_t)                          # when z is given

Shapes: u, delta, z (G, L, d); A (d, n); B, C (G, L, n); D (d,). The state
and the arithmetic are fp32; the output has u's dtype.

Two implementations of each direction, one signature each:

* ``selective_scan_ref``: the plain PyTorch version, a loop over time. The
  CPU path and the yardstick the kernels are held against;
  ``selective_scan_bwd_ref`` is autograd over it.
* ``selective_scan_cuda``: the hand-written CUDA kernel A
  (``csrc/selective_scan_fwd.cu``), which replaces the TPU kernel
  ``diffma_tpu/ops/selective_scan.py::_fwd_kernel``;
  ``selective_scan_bwd_cuda`` is kernel B (``csrc/selective_scan_bwd.cu``),
  which replaces ``_bwd_kernel``.

``SelectiveScanFn`` joins them for autograd: forward through kernel A,
backward through kernel B. ``selective_scan(impl="auto")`` takes it for CUDA
tensors and the plain version (plain autograd) for CPU tensors.

``selective_scan_assoc`` is the JAX package's parallel form: a prefix scan
over the affine maps ``h -> a h + b`` from PyTorch operators, on any device,
with autograd's gradients (``impl="assoc"``). ``selective_state_update`` is
the single-token step of incremental decode (``models/decode.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops import cuda_build

__all__ = [
    "SelectiveScanFn",
    "selective_scan",
    "selective_scan_assoc",
    "selective_scan_bwd_cuda",
    "selective_scan_bwd_ref",
    "selective_scan_cuda",
    "selective_scan_ref",
    "selective_state_update",
]

_KERNEL_SOURCE = "selective_scan_fwd"
_BWD_SOURCE = "selective_scan_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_D_STATE = (16,)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without overflow, as jax.nn.softplus computes it:
    logaddexp(x, 0). Its gradient is sigmoid(x) everywhere, x = 0 included,
    where max(x, 0) + log1p(exp(-|x|)) would give autograd 1."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequential scan in fp32; returns u.dtype."""
    out_dtype = u.dtype
    u = u.float()
    delta = delta.float()
    A = A.float()
    B = B.float()
    C = C.float()
    dt = _softplus(delta)
    G, L, d = u.shape
    h = u.new_zeros((G, d, A.shape[1]))
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t, :, None] * A)  # (G, d, n)
        h = a * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("gdn,gn->gd", h, C[:, t]))
    y = torch.stack(ys, dim=1) + u * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(out_dtype)


def _combine(a_l, b_l, a_r, b_r):
    """The map h -> a_r (a_l h + b_l) + b_r: (a_l) then (a_r)."""
    return a_l * a_r, a_r * b_l + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 1; ``even`` has as many items as
    ``odd`` or one more."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix compositions of the maps (a_t, b_t) along dim 1,
    by ``lax.associative_scan``'s odd/even recursion: adjacent pairs are
    composed, the half-length sequence is scanned, and the even steps take
    the odd prefix before them. 2 L combines and log2 L levels whose lengths
    halve, so autograd keeps O(L) per call."""
    L = a.shape[1]
    if L < 2:
        return a, b
    a_odd, b_odd = _associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    m = (L - 1) // 2  # steps 2, 4, ... : each after the odd prefix at step 2i - 1
    a_even, b_even = _combine(a_odd[:, :m], b_odd[:, :m], a[:, 2::2], b[:, 2::2])
    return (_interleave(torch.cat([a[:, :1], a_even], dim=1), a_odd),
            _interleave(torch.cat([b[:, :1], b_even], dim=1), b_odd))


def selective_scan_assoc(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The scan as a parallel prefix scan over the affine maps h -> a h + b
    (``diffma_tpu/ops/selective_scan.py::selective_scan_assoc``), fp32;
    returns u.dtype.

    The port has no ``lax.associative_scan``; ``_associative_scan`` is its
    recursion, so the maps are composed in JAX's order. Plain PyTorch
    operators on any device, on the card too; gradients come from autograd
    through the levels. ``a`` and ``b`` are (G, L, d, n) fp32; autograd
    keeps under eight tensors of that size per call, at any L.
    """
    out_dtype = u.dtype
    u = u.float()
    dt = _softplus(delta.float())
    a = torch.exp(dt[..., None] * A.float())  # (G, L, d, n)
    b = (dt * u)[..., None] * B.float()[:, :, None, :]
    _, h = _associative_scan(a, b)
    y = torch.einsum("gldn,gln->gld", h, C.float()) + u * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(out_dtype)


def selective_state_update(
    ssm_state: torch.Tensor,  # (G, d, n) fp32 carried state
    x: torch.Tensor,  # (G, d) post-conv token
    dt: torch.Tensor,  # (G, d) raw delta, before the bias
    A: torch.Tensor,  # (d, n), negative
    B: torch.Tensor,  # (G, n)
    C: torch.Tensor,  # (G, n)
    D: torch.Tensor,  # (d,)
    z: Optional[torch.Tensor] = None,  # (G, d) gate
    dt_bias: Optional[torch.Tensor] = None,  # (d,)
    dt_softplus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence for incremental decode
    (``diffma_tpu/ops/selective_scan.py::selective_state_update``). Returns
    ``(y in x's dtype, the new fp32 state)``; the state passed in is not
    changed."""
    xf = x.float()
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = _softplus(dtf)
    dA = torch.exp(dtf[..., None] * A.float())  # (G, d, n)
    s = dA * ssm_state.float() + (dtf * xf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("gdn,gn->gd", s, C.float()) + D.float() * xf
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), s


def _check_kernel_inputs(u, delta, A, B, C, D, z):
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, got {u.device}")
    if u.dim() != 3:
        raise ValueError(f"u must be (G, L, d), got {tuple(u.shape)}")
    G, L, d = u.shape
    n = A.shape[-1]
    if n not in _KERNEL_D_STATE:
        raise ValueError(f"the kernel is built for d_state in {_KERNEL_D_STATE}, got {n}")
    if u.dtype not in _DTYPE_CODE:
        raise ValueError(f"u must be float32 or bfloat16, got {u.dtype}")
    if delta.dtype not in (u.dtype, torch.float32):
        raise ValueError(f"delta must be {u.dtype} or float32, got {delta.dtype}")
    expect = {
        "delta": (delta, (G, L, d), delta.dtype),
        "A": (A, (d, n), torch.float32),
        "B": (B, (G, L, n), u.dtype),
        "C": (C, (G, L, n), u.dtype),
        "D": (D, (d,), torch.float32),
    }
    if z is not None:
        expect["z"] = (z, (G, L, d), u.dtype)
    for name, (t, shape, dtype) in expect.items():
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = cuda_build.load(_KERNEL_SOURCE)
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def selective_scan_cuda(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (softplus fused).

    Raises on inputs the kernel does not take; ``selective_scan_cuda.launches``
    counts the launches.
    """
    _check_kernel_inputs(u, delta, A, B, C, D, z)
    G, L, d = u.shape
    out = torch.empty_like(u)
    fn = _kernel_fn()
    err = fn(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), z.data_ptr() if z is not None else None,
        out.data_ptr(), G, L, d, A.shape[1], _DTYPE_CODE[u.dtype],
        _DTYPE_CODE[delta.dtype], torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: error {err}")
    selective_scan_cuda.launches += 1
    return out


selective_scan_cuda.launches = 0


def selective_scan_bwd_ref(u, delta, A, B, C, D, z, g):
    """The scan's backward by autograd over ``selective_scan_ref``, in fp32.

    Returns ``(du, ddelta, dA, dB, dC, dD, dz)`` in fp32, as the JAX launcher
    ``_selective_scan_pallas_bwd_impl`` does: dA is (d, n), dD (d,), and dz is
    None when the scan is ungated.
    """
    leaves = [t.detach().float().requires_grad_() for t in (u, delta, A, B, C, D)]
    if z is not None:
        leaves.append(z.detach().float().requires_grad_())
    with torch.enable_grad():
        out = selective_scan_ref(*leaves[:6], leaves[6] if z is not None else None)
        grads = torch.autograd.grad(out, leaves, g.float())
    return (*grads[:6], grads[6] if z is not None else None)


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    lib = cuda_build.load(_BWD_SOURCE)
    fn = lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.selective_scan_bwd_workspace_floats
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return fn, size


def selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g):
    """Launch kernel B on the current stream; returns what
    ``selective_scan_bwd_ref`` returns, fp32 throughout.

    The kernel writes dA and dD per sequence g; they are summed over g here,
    as the JAX launcher sums them outside its kernel. Raises on inputs the
    kernel does not take; ``selective_scan_bwd_cuda.launches`` counts the
    launches.
    """
    _check_kernel_inputs(u, delta, A, B, C, D, z)
    G, L, d = u.shape
    n = A.shape[1]
    if tuple(g.shape) != (G, L, d) or g.dtype != u.dtype or g.device != u.device:
        raise ValueError(f"g must be {u.dtype} of shape {(G, L, d)} on {u.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    fn, size_fn = _bwd_kernel_fn()
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty(G, L, d, **f32), torch.empty(G, L, d, **f32)
    dz = torch.empty(G, L, d, **f32) if z is not None else None
    dB, dC = torch.empty(G, L, n, **f32), torch.empty(G, L, n, **f32)
    dA_part, dD_part = torch.empty(G, d, n, **f32), torch.empty(G, d, **f32)
    workspace = torch.empty(size_fn(G, L, d, n), **f32)
    err = fn(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), z.data_ptr() if z is not None else None, g.data_ptr(),
        du.data_ptr(), ddelta.data_ptr(), dz.data_ptr() if dz is not None else None,
        dB.data_ptr(), dC.data_ptr(), dA_part.data_ptr(), dD_part.data_ptr(),
        workspace.data_ptr(), G, L, d, n, _DTYPE_CODE[u.dtype],
        _DTYPE_CODE[delta.dtype], torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed: error {err}")
    selective_scan_bwd_cuda.launches += 1
    return du, ddelta, dA_part.sum(0), dB, dC, dD_part.sum(0), dz


selective_scan_bwd_cuda.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """The scan with kernel A forward and kernel B backward. Saves only the
    inputs, as the JAX custom VJP does; the backward recomputes the states."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z):
        ctx.save_for_backward(u, delta, A, B, C, D, z)
        return selective_scan_cuda(u, delta, A, B, C, D, z)

    @staticmethod
    def backward(ctx, g):
        u, delta, A, B, C, D, z = ctx.saved_tensors
        grads = selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g.contiguous())
        return tuple(
            None if gr is None else gr.to(x.dtype)
            for gr, x in zip(grads, (u, delta, A, B, C, D, z))
        )


def selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    z: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Selective scan with a chosen implementation.

    ``impl="auto"`` takes ``SelectiveScanFn`` (kernels A and B) for CUDA
    tensors and runs the plain version for CPU tensors; ``"kernel"`` always
    takes the kernels (and raises on CPU tensors); ``"ref"`` always runs the
    plain version; ``"assoc"`` always runs ``selective_scan_assoc``, plain
    PyTorch operators on the card too, and only when asked for. Either way
    the result carries its gradient.
    """
    if impl == "auto":
        impl = "kernel" if u.device.type == "cuda" else "ref"
    if impl == "ref":
        return selective_scan_ref(u, delta, A, B, C, D, z)
    if impl == "assoc":
        return selective_scan_assoc(u, delta, A, B, C, D, z)
    if impl == "kernel":
        return SelectiveScanFn.apply(u, delta, A, B, C, D, z)
    raise ValueError(f"unknown impl: {impl!r}")
