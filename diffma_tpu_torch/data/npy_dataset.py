"""CT/mask/MRI ``.npy`` triplets, synthetic triplets and the batch loader.

Counterpart of ``diffma_tpu/data/npy_dataset.py``:

* ``NpyDataset``: three folders keyed by shared file names
  (``sorted(os.listdir(ct_folder))``), the mask remapped to ``(mask + 1) / 2``
  after the transform;
* ``transform_train`` / ``transform_test``: the CT resized bilinearly, the
  mask and the MRI with nearest, each to (1, H, W) float32. The JAX package
  resizes with PIL on mode "F" images; the GPU machine has no PIL, so
  ``_resize`` computes PIL's results in numpy: its bilinear filter is a
  triangle whose support widens by the scale factor when it shrinks (so a
  plain bilinear interpolation is wrong for 256 -> 224), applied along the
  rows and then the columns with a float32 image between; its nearest takes
  the source pixel under each destination pixel's centre, the centres summed
  step by step in double as PIL sums them;
* ``SyntheticTriplets``: the same seeded numpy draws as the JAX package's;
* ``make_loader``: the same batch order as the JAX package's loader.

``write_triplet_folders`` writes seeded SynthRAD-like folders for runs that
have no dataset.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["NpyDataset", "SyntheticTriplets", "make_loader", "transform_test",
           "transform_train", "write_triplet_folders"]

Triplet = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _triangle_weights(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) weights of PIL's bilinear filter along one axis."""
    scale = in_len / out_len
    support = max(scale, 1.0)  # the filter widens by the scale when it shrinks
    center = (np.arange(out_len) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_len)
    i = np.arange(in_len)[None]
    w = np.clip(1.0 - np.abs((i - center[:, None] + 0.5) / support), 0.0, None)
    w[(i < xmin[:, None]) | (i >= xmax[:, None])] = 0.0
    total = w.sum(axis=1, keepdims=True)
    return np.where(total != 0, w / np.where(total != 0, total, 1.0), w)


def _nearest_index(in_len: int, out_len: int) -> np.ndarray:
    step = in_len / out_len
    centres = np.cumsum(np.r_[0.5 * step, np.full(out_len - 1, step)])  # sequential sums
    return np.minimum(centres.astype(np.int64), in_len - 1)


def _resize(arr: np.ndarray, size: Tuple[int, int], nearest: bool) -> np.ndarray:
    """PIL's ``Image.fromarray(arr, "F").resize((w, h), NEAREST or BILINEAR)``."""
    a = np.asarray(arr, np.float32)
    h, w = a.shape
    if (h, w) == tuple(size):
        return a.copy()
    if nearest:
        return a[_nearest_index(h, size[0])][:, _nearest_index(w, size[1])]
    rows = (a.astype(np.float64) @ _triangle_weights(w, size[1]).T).astype(np.float32)
    return (_triangle_weights(h, size[0]) @ rows.astype(np.float64)).astype(np.float32)


def transform_train(image, mask, mri, size=(224, 224)) -> Triplet:
    """CT bilinear, mask and MRI nearest, each to (1, H, W) float32."""
    return (
        _resize(image, size, nearest=False)[None],
        _resize(mask, size, nearest=True)[None],
        _resize(mri, size, nearest=True)[None],
    )


def transform_test(image, mask, mri, size=(224, 224)) -> Triplet:
    return transform_train(image, mask, mri, size)


class NpyDataset:
    """(CT, mask, MRI) ``.npy`` triplets keyed by the CT folder's file names."""

    def __init__(self, image_folder: str, mask_folder: str, mri_folder: str,
                 transform: Optional[Callable] = None):
        self.image_folder = image_folder
        self.mask_folder = mask_folder
        self.mri_folder = mri_folder
        self.transform = transform
        self.images = sorted(os.listdir(image_folder))

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Triplet:
        name = self.images[index]
        image = np.load(os.path.join(self.image_folder, name))
        mask = np.load(os.path.join(self.mask_folder, name))
        mri = np.load(os.path.join(self.mri_folder, name))
        if self.transform is not None:
            image, mask, mri = self.transform(image, mask, mri)
        mask = (mask + 1) / 2
        return image, mask, mri


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


def write_triplet_folders(root: str, n: int, split: str = "train", size: int = 256,
                          seed: int = 0, mri_outside: int = 0) -> Dict[str, str]:
    """Write ``n`` seeded slices to ``<root>/B_<split>`` (CT in [-1, 1]),
    ``C_<split>`` (mask in {-1, 1}) and ``A_<split>`` (MRI), as float32
    ``size`` x ``size`` arrays named ``slice_NNNN.npy``; the MRI of the first
    ``mri_outside`` slices reaches 1.5, outside [-1, 1]. Returns the folders
    under the config's keys (``ct_image_folder_<split>`` ...)."""
    rng = np.random.default_rng(seed)
    key = "val" if split == "test" else split
    folders = {f"ct_image_folder_{key}": os.path.join(root, f"B_{split}"),
               f"mask_image_folder_{key}": os.path.join(root, f"C_{split}"),
               f"mir_image_folder_{key}": os.path.join(root, f"A_{split}")}
    for folder in folders.values():
        os.makedirs(folder, exist_ok=True)
    yy, xx = np.mgrid[-1:1:size * 1j, -1:1:size * 1j]
    for i in range(n):
        r = np.hypot(yy - rng.uniform(-0.2, 0.2), xx - rng.uniform(-0.2, 0.2))
        body = r < rng.uniform(0.6, 0.9)
        ct = np.clip(np.where(body, 0.6 - r, -1.0) + 0.05 * rng.standard_normal((size, size)),
                     -1, 1)
        mri = np.tanh(np.where(body, 1.2 * np.cos(3 * r), -0.9)
                      + 0.05 * rng.standard_normal((size, size)))
        if i < mri_outside:
            mri = mri * 1.5
        name = f"slice_{i:04d}.npy"
        for folder, arr in zip(folders.values(), (ct, np.where(body, 1.0, -1.0), mri)):
            np.save(os.path.join(folder, name), arr.astype(np.float32))
    return folders


def make_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    drop_last: bool = True,
    prefetch: int = 2,
) -> Iterator[Triplet]:
    """Yield batches of stacked (ct, mask, mri) arrays.

    The order is the JAX package's: the indices shuffled with (seed, epoch)
    when ``shuffle``, then every ``process_count``-th from ``process_index``;
    ``drop_last`` drops a short last batch. A background thread builds up to
    ``prefetch`` batches ahead; it stops when the iterator is closed or
    exhausted. An exception that the dataset raises in that thread is raised
    by the iterator, after the batches before it.
    """
    order = np.arange(len(dataset))
    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(order)
    shard = order[process_index::process_count]
    n_batches = len(shard) // batch_size if drop_last else -(-len(shard) // batch_size)
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
                items = [dataset[int(i)] for i in shard[b * batch_size : (b + 1) * batch_size]]
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
