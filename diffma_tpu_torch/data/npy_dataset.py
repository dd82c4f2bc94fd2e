"""Synthetic (CT, mask, MRI) triplets.

Counterpart of ``diffma_tpu/data/npy_dataset.py::SyntheticTriplets``: the
same seeded numpy draws, so both packages see the same images. The ``.npy``
folder dataset comes with the conditioning stack.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["SyntheticTriplets"]

Triplet = Tuple[np.ndarray, np.ndarray, np.ndarray]


class SyntheticTriplets:
    """Deterministic random triplets shaped like the real dataset."""

    def __init__(self, n: int = 64, size: int = 224, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Triplet:
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.size
        ct = rng.normal(size=(1, s, s)).astype(np.float32) * 0.5
        mask = (rng.random((1, s, s)) > 0.5).astype(np.float32)
        mri = np.tanh(ct + 0.1 * rng.normal(size=(1, s, s))).astype(np.float32)
        return ct, mask, mri

    def batches(self, batch_size: int):
        """Stacked (ct, mask, mri) batches in order; the last may be short."""
        for start in range(0, self.n, batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, self.n))]
            yield tuple(np.stack(parts) for parts in zip(*items))
