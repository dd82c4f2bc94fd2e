"""State-space duality (Mamba-2) scans from PyTorch operators.

Counterpart of ``diffma_tpu/ops/ssd.py``. Per head h, whose decay is one
scalar per step:

    dt_t = clip(softplus(delta_t + dt_bias))
    S_t  = exp(dt_t * A_h) * S_{t-1} + dt_t * (x_t (x) B_t)     # (P, N)
    y_t  = S_t @ C_t + D_h * x_t                                # (P,)

``ssd_ref`` runs that recurrence step by step. ``ssd_chunked`` blocks the
sequence into chunks whose inner work is dense products,

    Y_intra[t] = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
    S_chunk    = sum_s exp(cs_last - cs_s) dt_s (x_s (x) B_s)
    Y_inter[t] = C_t . (exp(cs_t) * S_entering)

with ``cs`` the inclusive cumsum of dt * A inside the chunk, and carries the
state from chunk to chunk. State, decays and sums are fp32, except ``cs``
and its differences, which are fp64 and rounded only after the exp, as in
the fused kernels: in fp32, with dt * |A| in the thousands over a sequence,
``cs_t - cs_s`` loses the digits the decay needs, and the backward's sums
over ``cs`` (rows less columns of one matrix, then a reverse cumsum) cancel
to rounding noise as large as the gradients of A and dt. With ``lowp`` the
products inside a chunk take the masked decay ``(C_t . B_s) exp(cs_t -
cs_s)`` and ``dt_s x_s`` rounded to bf16, with fp32 sums (kernels E and F at
a compute dtype of bfloat16, ``ops/fused_ssd.py``); the state path stays
fp32. These functions
are the composable Mamba-2 path (``models/mamba2.py``) and what the fused
mixer's plain version is built on (``ops/fused_ssd.py``). The single-token
``ssd_state_update`` comes with decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["RoundedProduct", "ssd_chunked", "ssd_chunked_grouped", "ssd_ref"]

_NO_LIMIT = (0.0, float("inf"))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class RoundedProduct(torch.autograd.Function):
    """``a @ b`` (batched over the leading axes, which a and b share) on
    operands rounded to bf16, summed in fp32: a product on bf16 operands with
    an fp32 accumulator. Its backward's two products round their operands
    the same way and return fp32, as the fused kernels' hand-derived
    backwards compute them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_bf16(a), _bf16(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _bf16(g)
        return (torch.matmul(g, _bf16(b).transpose(-1, -2)),
                torch.matmul(_bf16(a).transpose(-1, -2), g))


def _dt(dt, dt_bias, dt_softplus: bool, dt_limit) -> torch.Tensor:
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # gradient 1/2 at 0, as JAX's
    return dt.clamp(min=dt_limit[0], max=dt_limit[1])


def _skip(D: torch.Tensor) -> torch.Tensor:
    D = D.float()
    return D[:, None] if D.dim() == 1 else D


def ssd_ref(
    x: torch.Tensor,  # (G, L, H, P)
    dt: torch.Tensor,  # (G, L, H), raw: the bias is not added yet
    A: torch.Tensor,  # (H,), negative
    B: torch.Tensor,  # (G, L, N), one group
    C: torch.Tensor,  # (G, L, N)
    D: torch.Tensor,  # (H,) or (H, P)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    dt_softplus: bool = True,
    dt_limit: Tuple[float, float] = _NO_LIMIT,
    initial_state: Optional[torch.Tensor] = None,  # (G, H, P, N)
    return_final_state: bool = False,
):
    """The recurrence, one step after another; fp32 state."""
    out_dtype = x.dtype
    xf, Bf, Cf, Af = x.float(), B.float(), C.float(), A.float()
    dtf = _dt(dt, dt_bias, dt_softplus, dt_limit)
    G, L, H, P = x.shape
    state = (
        xf.new_zeros(G, H, P, B.shape[-1]) if initial_state is None else initial_state.float()
    )
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af)  # (G, H)
        dBx = torch.einsum("gh,gn,ghp->ghpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = dA[..., None, None] * state + dBx
        ys.append(torch.einsum("ghpn,gn->ghp", state, Cf[:, t]))
    y = (torch.stack(ys, dim=1) + _skip(D) * xf).to(out_dtype)
    return (y, state) if return_final_state else y


def _segsum_decay(cs: torch.Tensor) -> torch.Tensor:
    """exp(cs_t - cs_s) for t >= s and 0 elsewhere, from an inclusive cumsum
    (..., Q). Above the diagonal the difference is positive and may overflow,
    so it is replaced before the exp, not multiplied away after it."""
    Q = cs.shape[-1]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    diff = cs[..., :, None] - cs[..., None, :]
    return torch.exp(diff.masked_fill(~mask, float("-inf"))).float()


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
    dt_limit: Tuple[float, float] = _NO_LIMIT,
    chunk_size: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (G, H, P, N)
    return_final_state: bool = False,
    lowp: bool = False,
):
    """``ssd_ref`` with the work in dense products; shapes as there.

    L is padded to a multiple of the chunk with x = B = C = 0 and dt = -30,
    so that the padded steps decay by 1 and add nothing. ``lowp``: the
    intra-chunk product on bf16-rounded operands (``RoundedProduct``).
    """
    out_dtype = x.dtype
    G, L0, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk_size, max(16, 1 << (L0 - 1).bit_length()))
    L = -(-L0 // Q) * Q
    x0 = x
    if L != L0:
        x = F.pad(x, (0, 0, 0, 0, 0, L - L0))
        dt = F.pad(dt, (0, 0, 0, L - L0), value=-30.0)
        B = F.pad(B, (0, 0, 0, L - L0))
        C = F.pad(C, (0, 0, 0, L - L0))
    nc = L // Q

    xf = x.float().reshape(G, nc, Q, H, P)
    dtf = _dt(dt, dt_bias, dt_softplus, dt_limit).reshape(G, nc, Q, H)
    Bf = B.float().reshape(G, nc, Q, N)
    Cf = C.float().reshape(G, nc, Q, N)
    cs = torch.cumsum((dtf * A.float()).double(), dim=2)  # (G, nc, Q, H), inside each chunk

    # Inside the chunks: dense, causally masked products.
    cb = torch.einsum("gctn,gcsn->gcts", Cf, Bf)
    m = cb[:, :, None] * _segsum_decay(cs.permute(0, 1, 3, 2))  # (G, nc, H, Q, Q)
    if lowp:
        xdt = (xf * dtf[..., None]).permute(0, 1, 3, 2, 4)  # (G, nc, H, Q, P)
        y_intra = RoundedProduct.apply(m, xdt).permute(0, 1, 3, 2, 4)
    else:
        y_intra = torch.einsum("gchts,gcshp->gcthp", m, xf * dtf[..., None])

    # Each chunk's state, and the recurrence from chunk to chunk.
    cs_last = cs[:, :, -1]  # (G, nc, H)
    state_decay = torch.exp(cs_last[:, :, None] - cs).float()  # (G, nc, Q, H)
    S_chunk = torch.einsum("gcqh,gcqn,gcqhp->gchpn", state_decay * dtf, Bf, xf)
    chunk_decay = torch.exp(cs_last).float()
    state = xf.new_zeros(G, H, P, N) if initial_state is None else initial_state.float()
    entering = []
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S_chunk[:, c]
    S_in = torch.stack(entering, dim=1)  # (G, nc, H, P, N)
    y_inter = torch.einsum("gcqh,gcqn,gchpn->gcqhp", torch.exp(cs).float(), Cf, S_in)

    y = (y_intra + y_inter).reshape(G, L, H, P)[:, :L0]
    y = (y + _skip(D) * x0.float()).to(out_dtype)
    return (y, state) if return_final_state else y


def ssd_chunked_grouped(
    x: torch.Tensor,  # (G, L, H, P)
    dt: torch.Tensor,  # (G, L, H)
    A: torch.Tensor,  # (H,)
    B: torch.Tensor,  # (G, L, ngroups * N)
    C: torch.Tensor,  # (G, L, ngroups * N)
    D: torch.Tensor,  # (H,) or (H, P)
    ngroups: int = 1,
    dt_bias: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,  # (G, H, P, N)
    return_final_state: bool = False,
    **kw,
):
    """``ssd_chunked`` where head h reads B/C group ``h // (H / ngroups)``:
    the heads of a group are contiguous, and the groups' columns of B and C
    lie one after another."""
    H = x.shape[2]
    Hg, rem = divmod(H, ngroups)
    if rem:
        raise ValueError(f"nheads {H} is not divisible by ngroups {ngroups}")
    N = B.shape[-1] // ngroups
    ys, states = [], []
    for g in range(ngroups):
        heads = slice(g * Hg, (g + 1) * Hg)
        cols = slice(g * N, (g + 1) * N)
        y, state = ssd_chunked(
            x[:, :, heads], dt[:, :, heads], A[heads], B[..., cols], C[..., cols], D[heads],
            dt_bias=None if dt_bias is None else dt_bias[heads],
            initial_state=None if initial_state is None else initial_state[:, heads],
            return_final_state=True, **kw,
        )
        ys.append(y)
        states.append(state)
    y = torch.cat(ys, dim=2)
    return (y, torch.cat(states, dim=1)) if return_final_state else y
