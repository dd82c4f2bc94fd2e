"""The Spiral family's scan orders: gather and merge tables of each layer.

Frozen copy of the spiral part of ``diffma_tpu_torch/ops/scan_orders.py`` at
commit 8e06284 (``_SPIRAL_DIRECTION_SETS``, ``_spiral_walk``,
``spiral_orders``, the spiral branch of ``build_scan_spec`` and
``_build_merge_table``), which follows upstream DiffMa's ``tools.py:2-43``
and ``model.py:147-150``. A layer scans three streams of all L tokens:
token order, spiral walk k = (2i) % 16 and its value-reversed twin k + 1;
the merge adds each token's three stream outputs back in token order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spiral_spec"]

# the eight direction cycles of upstream's walker, as (row, col) steps
_DIRECTIONS = (
    ((0, 1), (1, 0), (0, -1), (-1, 0)),
    ((1, 0), (0, -1), (-1, 0), (0, 1)),
    ((0, -1), (-1, 0), (0, 1), (1, 0)),
    ((-1, 0), (0, 1), (1, 0), (0, -1)),
    ((0, 1), (-1, 0), (0, -1), (1, 0)),
    ((0, -1), (1, 0), (0, 1), (-1, 0)),
    ((1, 0), (0, 1), (-1, 0), (0, -1)),
    ((-1, 0), (0, -1), (1, 0), (0, 1)),
)


def _walk(n: int, directions) -> np.ndarray:
    """Cell (x, y) holds the 0-based step at which the walker, starting at
    the centre, reaches it; cells off the grid are skipped but consume a
    value, as upstream's walker does."""
    grid = np.zeros((n, n), dtype=np.int64)
    x = y = n // 2
    d, steps, value = 0, 1, 1
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
    return grid - 1


def _orders(n: int) -> np.ndarray:
    """The 16 spiral orders: walk k at 2k, its value-reversed twin at 2k + 1."""
    out = []
    for dirs in _DIRECTIONS:
        flat = _walk(n, dirs).reshape(-1)
        out += [flat, n * n - 1 - flat]
    return np.stack(out)


def spiral_spec(grid_n: int, layer: int):
    """(fwd (3, L), merge (L, 3)) int64 tables of Spiral layer ``layer``:
    stream s is ``x[fwd[s]]``; token t's output is the sum of the flat
    stream outputs at ``merge[t]``."""
    L = grid_n * grid_n
    orders = _orders(grid_n)
    k = (2 * layer) % orders.shape[0]
    fwd = np.stack([np.arange(L), orders[k], orders[k + 1]]).astype(np.int64)
    buckets = [[] for _ in range(L)]
    for j, t in enumerate(fwd.reshape(-1)):
        buckets[int(t)].append(j)
    return fwd, np.asarray(buckets, dtype=np.int64)
