"""One-shot train/test split of the three parallel dataset folders.

Counterpart of ``diffma_tpu/data/split.py`` (reference: split.py:5-48). The
CT folder's file names are shuffled with ``random.Random(seed)`` and the
files of each name move together, so the three folders stay aligned and a
seed moves the same files as the JAX package's.
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Optional

__all__ = ["split_dataset"]


def split_dataset(
    a_dir: str, b_dir: str, c_dir: str,
    a_train: str, a_test: str, b_train: str, b_test: str,
    c_train: str, c_test: str,
    train_ratio: float = 0.8,
    seed: Optional[int] = None,
) -> None:
    """Move the first ``train_ratio`` of the shuffled names into the train
    folders and the rest into the test folders."""
    for d in (a_dir, b_dir, c_dir):
        if not os.path.isdir(d):
            raise FileNotFoundError(f"directory {d} does not exist")
    for d in (a_train, a_test, b_train, b_test, c_train, c_test):
        os.makedirs(d, exist_ok=True)

    files = [f for f in os.listdir(a_dir) if os.path.isfile(os.path.join(a_dir, f))]
    random.Random(seed).shuffle(files)
    split_idx = int(len(files) * train_ratio)
    for names, dests in ((files[:split_idx], (a_train, b_train, c_train)),
                         (files[split_idx:], (a_test, b_test, c_test))):
        for f in names:
            for src, dst in zip((a_dir, b_dir, c_dir), dests):
                shutil.move(os.path.join(src, f), os.path.join(dst, f))
