"""Sequence parallelism for the two scans.

Counterpart of ``diffma_tpu/parallel/sequence.py``. The sequence axis is
cut into one contiguous slice per rank of the sp group:

1. each rank scans its slice from a zero entering state, and keeps its
   slice's summary: for Mamba-1 the composed affine map of the whole slice,
   for Mamba-2 its final state and its total decay per head;
2. the summaries of every rank are gathered (``collectives.all_gather``,
   G · d · n or G · H · P · N values a rank, whatever the length), and each
   rank composes those of the ranks before it, in order, into its entering
   state;
3. the entering state's contribution is added to the local outputs:
   ``h = h_local + a_cum · S_in`` for Mamba-1, ``C_t · (exp(cum_t) · S_in)``
   for Mamba-2.

These are plain PyTorch operators on any device, as in the JAX package,
where the Mamba-1 slice is ``lax.associative_scan`` (here
``ops/selective_scan.py::_associative_scan``, its recursion in its order)
and the Mamba-2 slice ``ops/ssd.py::ssd_chunked``; no Pallas kernel runs in
either. The inputs are the full replicated sequences: every one goes through
``collectives.enter`` before it is sliced, A and D (and Mamba-2's dt_bias)
too, since each rank's gradient covers only its own slice and its own share
of them; the output is the full sequence again, put together by
``_seq_unshard`` and ``psum_out``. A length not divisible by the sp group's
size raises ``ValueError``, where JAX's ``shard_map`` fails.

The mixers sharded over tp and sp at once call the per-slice bodies
(``_sel_scan_local``, ``_local_with_carry``) with ``_seq_shard`` and
``_seq_unshard`` themselves, and fold the reassembly into their out_proj sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffma_tpu_torch.ops.selective_scan import _associative_scan, _softplus
from diffma_tpu_torch.ops.ssd import _dt, ssd_chunked
from diffma_tpu_torch.parallel.collectives import all_gather, enter, psum_out

__all__ = ["selective_scan_sequence_parallel", "ssd_sequence_parallel"]

_NO_LIMIT = (0.0, float("inf"))


def _check_len(L: int, n: int) -> None:
    if L % n:
        raise ValueError(f"the sequence length {L} is not divisible by the sp axis size {n}")


def _flag(value: bool, device) -> torch.Tensor:
    """A condition for ``torch.where``. Every rank selects with it rather
    than leaving a term out, so that every rank's autograd graph holds the
    same collectives and their backwards meet in the same order."""
    return torch.tensor(value, device=device)


def _seq_shard(a: torch.Tensor, mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous slice of a replicated sequence axis."""
    n = mesh.size(axis)
    _check_len(a.shape[dim], n)
    size = a.shape[dim] // n
    return a.narrow(dim, mesh.index(axis) * size, size)


def _seq_unshard(a: torch.Tensor, full_len: int, mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's slice at its place in a zero full-length buffer. The
    ranks fill disjoint rows, so a sum over ``axis`` (folded into the
    mixers' out_proj sum) puts the sequence together."""
    before = mesh.index(axis) * a.shape[dim]
    after = full_len - before - a.shape[dim]
    zeros = lambda k: a.new_zeros(a.shape[:dim] + (k,) + a.shape[dim + 1:])  # noqa: E731
    return torch.cat([zeros(before), a, zeros(after)], dim=dim)


def _sel_scan_local(u, delta, A, B, C, D, z, delta_softplus: bool, mesh, axis: str):
    """One rank's slice of the Mamba-1 scan (``sequence.py:38-84``): the
    prefix compositions of the maps h -> a h + b over the slice, whose last
    is the slice's summary; the summaries of the ranks before this one
    composed in order into the entering state S_in; h = h_local + a_cum S_in."""
    out_dtype = u.dtype
    uf = u.float()
    dt = delta.float()
    if delta_softplus:
        dt = _softplus(dt)
    a = torch.exp(dt[..., None] * A.float())  # (G, Ls, d, n)
    b = (dt * uf)[..., None] * B.float()[:, :, None, :]
    a_cum, h_local = _associative_scan(a, b)

    idx, n = mesh.index(axis), mesh.size(axis)
    group = mesh.group(axis)
    a_all = all_gather(a_cum[:, -1], idx, n, group)  # (n, G, d, n)
    b_all = all_gather(h_local[:, -1], idx, n, group)
    # compose the gathered maps inclusively, in rank order, and take the one
    # before this rank's, as JAX's associative_scan over axis 0
    _, b_inc = _associative_scan(a_all.transpose(0, 1), b_all.transpose(0, 1))
    prev = b_inc[:, max(idx - 1, 0)]
    S_in = torch.where(_flag(idx > 0, prev.device), prev, torch.zeros_like(prev))
    h = h_local + a_cum * S_in[:, None]
    y = torch.einsum("gldn,gln->gld", h, C.float()) + uf * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(out_dtype)


def selective_scan_sequence_parallel(
    u: torch.Tensor,  # (G, L, d), L divisible by the sp size
    delta: torch.Tensor,  # (G, L, d), raw (with the dt bias)
    A: torch.Tensor,  # (d, n), negative
    B: torch.Tensor,  # (G, L, n)
    C: torch.Tensor,  # (G, L, n)
    D: torch.Tensor,  # (d,)
    mesh,
    axis: str = "sp",
    z: Optional[torch.Tensor] = None,  # (G, L, d) gate
    delta_softplus: bool = True,
) -> torch.Tensor:
    """The Mamba-1 selective scan with the sequence cut over ``mesh``'s
    ``axis``; the full-length result on every rank of it, as
    ``selective_scan_ref`` on the whole sequence gives it."""
    L = u.shape[1]
    _check_len(L, mesh.size(axis))
    group = mesh.group(axis)
    u, delta, B, C, A, D = (enter(t, group) for t in (u, delta, B, C, A, D))
    z = None if z is None else enter(z, group)
    shd = lambda t: None if t is None else _seq_shard(t, mesh, axis)  # noqa: E731
    y = _sel_scan_local(shd(u), shd(delta), A, shd(B), shd(C), D, shd(z), delta_softplus,
                        mesh, axis)
    return psum_out(_seq_unshard(y, L, mesh, axis), group)


def _local_with_carry(x, dt, A, B, C, D, dt_bias, dt_softplus: bool, dt_limit, chunk_size: int,
                      mesh, axis: str):
    """One rank's slice of the SSD scan (``sequence.py:137-198``): the
    chunked scan from a zero state with its final state, the slice's decay
    per head, the final states of the ranks before this one folded in order
    into S_in, and y += C_t · (exp(cum_t) · S_in).

    The final state is the state after the slice's last real step
    (``ops/ssd.py::ssd_chunked``). JAX's ``ssd_chunked`` also decays it by
    the steps that pad the last chunk where ``dt_limit[0] > 0``; that fault
    is not copied."""
    y_local, S_out = ssd_chunked(x, dt, A, B, C, D, dt_bias=dt_bias, dt_softplus=dt_softplus,
                                 dt_limit=dt_limit, chunk_size=chunk_size,
                                 return_final_state=True)
    dtf = _dt(dt, dt_bias, dt_softplus, dt_limit)
    cum = torch.cumsum(dtf * A.float(), dim=1)  # (G, Ls, H), inclusive

    idx, n = mesh.index(axis), mesh.size(axis)
    group = mesh.group(axis)
    S_all = all_gather(S_out, idx, n, group)  # (n, G, H, P, N)
    dec_all = all_gather(torch.exp(cum[:, -1]), idx, n, group)  # (n, G, H)
    S_in = torch.zeros_like(S_out)
    for k in range(n):  # the slices before this one fold in, in order
        S_in = torch.where(_flag(k < idx, S_in.device),
                           dec_all[k][..., None, None] * S_in + S_all[k], S_in)
    corr = torch.einsum("glh,gln,ghpn->glhp", torch.exp(cum), C.float(), S_in)
    return (y_local.float() + corr).to(x.dtype)


def ssd_sequence_parallel(
    x: torch.Tensor,  # (G, L, H, P), L divisible by the sp size
    dt: torch.Tensor,  # (G, L, H)
    A: torch.Tensor,  # (H,)
    B: torch.Tensor,  # (G, L, N)
    C: torch.Tensor,  # (G, L, N)
    D: torch.Tensor,  # (H,) or (H, P)
    mesh,
    axis: str = "sp",
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
    dt_limit: Tuple[float, float] = _NO_LIMIT,
    chunk_size: int = 256,
) -> torch.Tensor:
    """The SSD scan with the sequence cut over ``mesh``'s ``axis``; the
    full-length result on every rank of it, as ``ssd_ref`` on the whole
    sequence gives it."""
    L = x.shape[1]
    _check_len(L, mesh.size(axis))
    group = mesh.group(axis)
    x, dt, B, C, A, D = (enter(t, group) for t in (x, dt, B, C, A, D))
    dt_bias = None if dt_bias is None else enter(dt_bias, group)
    shd = lambda t: _seq_shard(t, mesh, axis)  # noqa: E731
    y = _local_with_carry(shd(x), shd(dt), A, shd(B), shd(C), D, dt_bias, dt_softplus, dt_limit,
                          chunk_size, mesh, axis)
    return psum_out(_seq_unshard(y, L, mesh, axis), group)
