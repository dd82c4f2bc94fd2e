"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Building takes
seconds, so it happens at first use in each process; the library's file name
carries a hash of its source, so an edited source is rebuilt and an unchanged
one is reused. Libraries go into ``diffma_tpu_torch/_build/``, which git
ignores.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

__all__ = ["BUILD_DIR", "CSRC_DIR", "BuildResult", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildResult(NamedTuple):
    """Where a library was built, how long it took and what nvcc printed."""

    path: str
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of the same source exists."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if os.path.exists(path):
        return BuildResult(path, 0.0, "cached")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildResult(path, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(build(name).path)
