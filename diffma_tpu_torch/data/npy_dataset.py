"""Synthetic (CT, mask, MRI) triplets and the batch loader.

Counterpart of ``diffma_tpu/data/npy_dataset.py``: ``SyntheticTriplets``
makes the same seeded numpy draws, so both packages see the same images, and
``make_loader`` batches a dataset in the same shuffled order. The ``.npy``
folder dataset comes with the conditioning stack.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np

__all__ = ["SyntheticTriplets", "make_loader"]

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


def make_loader(
    dataset,
    batch_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    prefetch: int = 2,
) -> Iterator[Triplet]:
    """Yield batches of stacked (ct, mask, mri) arrays, in one process.

    The index order is shuffled with (seed, epoch), as the JAX package's
    loader shuffles it for training, and a short last batch is dropped. A
    background thread builds up to ``prefetch`` batches ahead; it stops when
    the iterator is closed or exhausted. An exception that the dataset raises
    in that thread is raised by the iterator, after the batches before it.
    """
    order = np.random.default_rng((seed, epoch)).permutation(len(dataset))
    n_batches = len(order) // batch_size
    done = object()
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in range(n_batches):
                items = [dataset[int(i)] for i in order[b * batch_size : (b + 1) * batch_size]]
                if not put(tuple(np.stack([it[k] for it in items]) for k in range(3))):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            put(e)
            return
        put(done)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
