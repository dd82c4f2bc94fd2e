"""The collectives of the sharded mixers, each with the backward it needs.

``jax.shard_map`` transposes its own collectives: a replicated input
(``in_specs=P()``) gets the sum of its shards' gradients, and a ``psum``
whose result is replicated passes its gradient through once. PyTorch's
autograd knows none of that, so each op here is an ``autograd.Function``
that states its backward. ``torch.distributed.nn.functional.all_reduce``
sums in its backward: right for ``psum_mid``, wrong for ``psum_out``, which
it would multiply by the group's size.

Every op is built on ``all_reduce`` (a sum), which gloo runs on CUDA tensors
(through pinned host memory) and NCCL runs everywhere. ``group=None`` is a
group of one: every op is then the identity, forward and backward.

The rule they follow: code is either replicated over a group (every rank
computes the same values) or per shard. A replicated tensor that enters a
sharded body goes through ``enter``; a sum over shards that replicated code
reads goes through ``psum_out``; a sum over shards that per-shard code reads
goes through ``psum_mid``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "enter", "psum_mid", "psum_out"]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _PsumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumMid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor entering a sharded body. Forward: the identity.
    Backward: the sum of the gradient over ``group``. Each shard uses its
    own part of ``x`` (a weight's slice, a sequence's slice), so its
    gradient covers that part; the sum makes it whole for the replicated
    code before, as ``shard_map``'s transpose of ``in_specs=P()`` does."""
    return x if group is None else _Enter.apply(x, group)


def psum_out(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` that replicated code reads (a mixer's out_proj,
    a sequence reassembled). Forward: the sum. Backward: the identity: every
    rank holds the same gradient of the replicated result, which is the
    gradient of each term."""
    return x if group is None else _PsumOut.apply(x, group)


def psum_mid(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` that per-shard code reads (Mamba-1's x_proj
    partials, Mamba-2's sum of squares for the gated norm, gathered
    summaries). Forward: the sum. Backward: the sum of the gradient over
    ``group``: every shard's use of the sum contributes to each term's."""
    return x if group is None else _PsumMid.apply(x, group)


def all_gather(x: torch.Tensor, index: int, size: int, group) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x`` at its slot, this rank's at
    ``index``. Forward: a zero buffer with ``x`` at this rank's slot, summed
    over ``group`` by ``psum_mid``. Backward: this rank's slot of the sum of
    every rank's gradient of the buffer, a reduce-scatter: a later shard's
    use of this rank's summary sends its gradient here."""
    slots = [x if k == index else torch.zeros_like(x) for k in range(size)]
    return psum_mid(torch.stack(slots), group)
