"""Static 2-D scan-order generators and the uniform ScanSpec abstraction.

A copy of ``diffma_tpu/ops/scan_orders.py``, which is numpy only; the port
keeps its own so that it never imports the JAX package. The reference
(``tools.py``) builds token permutations for four families of 2-D scan
orders: 16 spiral walks, 8 zigzag rasters, the 4-direction VMamba set and
EfficientVMamba's atrous partition. Each mixer consumes one ``ScanSpec``:

    scan   :  xs[s]   = x[fwd[s]]                      (gather per stream)
    merge  :  out[t]  = sum_j { ys.flat[j] : fwd.flat[j] == t }   (scatter-add)

The merge is precomputed into a dense ``(L, k)`` gather table (``k`` =
contributions per output token: S for full permutations, 1 for the atrous
partition).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "spiral_orders",
    "zig_order",
    "vmamba_orders",
    "atrous_streams",
    "invert_permutation",
    "ScanSpec",
    "build_scan_spec",
]


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """Return q with q[perm[i]] = i (the reference's ``original_order_indexes``,
    tools.py:40-42)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[-1], dtype=perm.dtype)
    return inv


# ---------------------------------------------------------------------------
# Spiral family (tools.py:2-43)
# ---------------------------------------------------------------------------

# The eight direction cycles of the reference walker (tools.py:4-11), given as
# (dx, dy) steps on the (row, col) grid.
_SPIRAL_DIRECTION_SETS = (
    ((0, 1), (1, 0), (0, -1), (-1, 0)),
    ((1, 0), (0, -1), (-1, 0), (0, 1)),
    ((0, -1), (-1, 0), (0, 1), (1, 0)),
    ((-1, 0), (0, 1), (1, 0), (0, -1)),
    ((0, 1), (-1, 0), (0, -1), (1, 0)),
    ((0, -1), (1, 0), (0, 1), (-1, 0)),
    ((1, 0), (0, 1), (-1, 0), (0, -1)),
    ((-1, 0), (0, -1), (1, 0), (0, 1)),
)


def _spiral_walk(n: int, directions) -> np.ndarray:
    """Visit-step matrix of one spiral walk: cell (x, y) holds the 0-based step
    at which the walker assigned it a value (tools.py:13-29).

    The walker starts at the grid centre (n//2, n//2), moves ``steps`` cells in
    the current direction, turns, repeats twice per leg length, then grows the
    leg.  Cells outside the grid are skipped but still consume a value, which
    is exactly the reference behaviour (``if 0 <= x < n and 0 <= y < n``).
    """
    grid = np.zeros((n, n), dtype=np.int64)
    x = y = n // 2
    d = 0
    steps = 1
    value = 1
    while value <= n * n:
        for _ in range(2):
            for _ in range(steps):
                if 0 <= x < n and 0 <= y < n:
                    grid[x, y] = value
                    value += 1
                x += directions[d][0]
                y += directions[d][1]
            d = (d + 1) % 4
        steps += 1
    return grid - 1  # 0-based


@functools.lru_cache(maxsize=None)
def spiral_orders(n: int) -> tuple[np.ndarray, np.ndarray]:
    """All 16 spiral index lists and their inverses, in reference layout.

    Returns ``(orders, inverses)`` of shape (16, n*n): entries 2k are the
    8 spiral walks, entries 2k+1 their value-reversed twins
    (``n*n - value``, tools.py:30-37).
    """
    orders = []
    for dirs in _SPIRAL_DIRECTION_SETS:
        flat = _spiral_walk(n, dirs).reshape(-1)
        orders.append(flat)
        orders.append(n * n - 1 - flat)
    orders = np.stack(orders).astype(np.int32)
    inverses = np.stack([invert_permutation(o) for o in orders])
    return orders, inverses


# ---------------------------------------------------------------------------
# Zigzag family (tools.py:46-128)
# ---------------------------------------------------------------------------


def _zig1(n: int) -> np.ndarray:
    """Row-major boustrophedon: even rows left->right, odd rows right->left."""
    m = np.arange(n * n, dtype=np.int64).reshape(n, n)
    m[1::2] = m[1::2, ::-1]
    return m


def _zig_matrix(n: int, which: int) -> np.ndarray:
    """The eight zigzag visit-step matrices, 0-based (tools.py:46-102)."""
    z1 = _zig1(n)
    if which == 1:
        return z1
    if which == 2:  # column-major boustrophedon
        return z1.T
    if which == 3:  # zig1 with each row reversed
        return z1[:, ::-1]
    if which == 4:  # zig2 with rows reversed (reference reverses each row of
        # the zig2 matrix: ``[col[::-1] for col in matrix]`` iterates rows)
        return z1.T[:, ::-1]
    if which == 5:  # zig1 with row order reversed
        return z1[::-1]
    if which == 6:
        return z1.T[::-1]
    if which == 7:  # zig5 with each row reversed
        return z1[::-1, ::-1]
    if which == 8:
        return z1.T[::-1, ::-1]
    raise ValueError(which)


@functools.lru_cache(maxsize=None)
def zig_order(n: int, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-layer zigzag order: layer index ``i`` picks variant ``i % 8`` with
    the reference's 1..8,0 mapping (tools.py:104-128)."""
    which = i % 8 if i % 8 != 0 else 8
    order = _zig_matrix(n, which).reshape(-1).astype(np.int32)
    return order, invert_permutation(order)


@functools.lru_cache(maxsize=None)
def vmamba_orders(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The VMamba 4-direction set {zig1, zig2, zig7, zig8} (tools.py:130-151)."""
    orders = np.stack(
        [_zig_matrix(n, w).reshape(-1) for w in (1, 2, 7, 8)]
    ).astype(np.int32)
    inverses = np.stack([invert_permutation(o) for o in orders])
    return orders, inverses


# ---------------------------------------------------------------------------
# EfficientVMamba atrous decomposition (block/mamba.py:170-224)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def atrous_streams(n: int) -> np.ndarray:
    """Gather indices of the four quarter-length atrous streams, shape
    (4, (n//2)**2).

    Reproduces CrossScan_EfficientVMamba.forward (block/mamba.py:176-183):

        s0 = x[::2,  ::2]          (row-major)
        s1 = x.T[::2, 1::2]        (transposed grid)
        s2 = x[::2, 1::2]
        s3 = x.T[1::2, 1::2]

    The four streams partition the grid, so the merge
    (CrossMerge_EfficientVMamba.forward, block/mamba.py:200-211) is the exact
    inverse scatter; token j of stream s returns to grid position
    ``streams[s, j]``.
    """
    if n % 2 != 0:
        # The reference is equally broken on odd grids: its strided slices in
        # CrossScan_EfficientVMamba (block/mamba.py:176-183) produce streams
        # of mismatched length and the merge shape-errors.  Registry entries
        # like EMamba-*/4 at 224^2 (grid 7) therefore cannot run upstream
        # either; fail with a clear message instead of an assert.
        raise ValueError(
            f"EfficientVMamba's atrous decomposition requires an even token "
            f"grid; got {n}x{n}. (Parity note: the reference crashes on odd "
            f"grids too -- block/mamba.py:176-183 shape-mismatches -- so e.g. "
            f"EMamba-*/4 at image_size 224 is unusable in both frameworks.)"
        )
    r = np.arange(n * n, dtype=np.int32).reshape(n, n)
    return np.stack(
        [
            r[::2, ::2].reshape(-1),
            r.T[::2, 1::2].reshape(-1),
            r[::2, 1::2].reshape(-1),
            r.T[1::2, 1::2].reshape(-1),
        ]
    )


# ---------------------------------------------------------------------------
# Uniform ScanSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ScanSpec:
    """Static description of one mixer's multi-stream scan.

    ``eq=False`` keeps identity hashing so a spec can be a *static* argument
    under jit/remat; ``build_scan_spec`` is lru_cached, so equal specs are
    the same object and identity equality is exact.

    Attributes:
      fwd: (S, Ls) int32 gather indices; stream s is ``x[fwd[s]]``.
      merge: (L, k) int32 indices into the flattened (S*Ls,) stream outputs;
        the merged sequence is ``sum_k ys.flat[merge[:, k]]``.
      scale: scalar applied after merging (0.5 for the ViM bidirectional
        average, block/mamba.py:367; 1.0 otherwise).
      mamba1_vim_quirk: replicate the reference Mamba1 'vim' merge bug
        (block/mamba.py:362-367): the reverse stream's output -- a (B, L, D)
        tensor -- is "un-flipped" with ``torch.flip(out2, [2])``, i.e. along
        the *feature* axis instead of the sequence axis, and stays in
        reversed token order.  The Mamba2 'vim' path flips dim 1 correctly
        (block/mamba2.py:502,522), so only the Mamba1 mixer honours this.
    """

    fwd: np.ndarray
    merge: np.ndarray
    scale: float
    mamba1_vim_quirk: bool = False

    @property
    def n_streams(self) -> int:
        return self.fwd.shape[0]

    @property
    def stream_len(self) -> int:
        return self.fwd.shape[1]

    @property
    def seq_len(self) -> int:
        return self.merge.shape[0]


def _build_merge_table(fwd: np.ndarray, seq_len: int) -> np.ndarray:
    """Dense (L, k) table of flattened stream positions contributing to each
    output token (k is constant: S for stacks of full permutations, 1 for a
    partition)."""
    flat = fwd.reshape(-1)
    buckets: list[list[int]] = [[] for _ in range(seq_len)]
    for j, t in enumerate(flat):
        buckets[int(t)].append(j)
    k = len(buckets[0])
    assert all(len(b) == k for b in buckets), "merge table must be rectangular"
    return np.asarray(buckets, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def build_scan_spec(block_type: str, grid_n: int, layer_idx: int = 0) -> ScanSpec:
    """ScanSpec for one layer of one backbone family.

    Stream composition per family (matching Mamba.forward's dispatch,
    block/mamba.py:343-401):

    * ``spiral``: [identity, spiral_k, reversed spiral_k] where the layer uses
      order pair ((2*i) % 16, (2*i) % 16 + 1) -- the model passes
      ``matrix_list[(2*i) % len]`` and its ``+1`` twin (model.py:147-150).
    * ``zig``: single stream, variant ``i % 8`` (model.py:161-162).
    * ``vim``: [identity, reversed identity], merge averaged
      (block/mamba.py:362-367).
    * ``vmamba``: the 4 zigzag directions (model.py:182-184).
    * ``efficientVMamba``/``eff``: 4 quarter-length atrous streams
      (block/mamba.py:385-401).
    """
    L = grid_n * grid_n
    ident = np.arange(L, dtype=np.int32)
    if block_type == "spiral":
        orders, _ = spiral_orders(grid_n)
        k = (2 * layer_idx) % orders.shape[0]
        fwd = np.stack([ident, orders[k], orders[k + 1]])
        scale = 1.0
    elif block_type == "zig":
        order, _ = zig_order(grid_n, layer_idx)
        fwd = order[None]
        scale = 1.0
    elif block_type == "vim":
        fwd = np.stack([ident, ident[::-1]])
        scale = 0.5
        return ScanSpec(
            fwd=fwd, merge=_build_merge_table(fwd, L), scale=scale,
            mamba1_vim_quirk=True,
        )
    elif block_type == "vmamba":
        orders, _ = vmamba_orders(grid_n)
        fwd = orders
        scale = 1.0
    elif block_type in ("efficientVMamba", "eff"):
        fwd = atrous_streams(grid_n)
        scale = 1.0
    else:
        raise ValueError(f"unknown scan family: {block_type!r}")
    return ScanSpec(fwd=fwd, merge=_build_merge_table(fwd, L), scale=scale)
