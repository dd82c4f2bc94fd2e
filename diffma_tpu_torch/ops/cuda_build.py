"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Building takes
seconds, so it happens at first use in each process; the library's file name
carries a hash of its source and of every header in ``csrc/`` (C, D, E, F,
G and H include ``gemm_tc.cuh``, the 3xTF32 tensor-core GEMM; A and H
``scan_fwd.cuh``, the chunked forward scan; E, F and P ``ssd_core.cuh``, the
chunked SSD; the GEMM and the SSD ``bf16_round.cuh``), so an
edited source or header is rebuilt and an unchanged one is
reused. Libraries go into
``diffma_tpu_torch/_build/``, which git ignores.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

__all__ = ["BUILD_DIR", "CSRC_DIR", "SOURCES", "BuildResult", "build", "build_all", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: Every kernel source of the port: kernels A, C, B, D, E, G, F, H and P (the
#: split SSD probe's core).
SOURCES = ("selective_scan_fwd", "fused_mixer_fwd", "selective_scan_bwd", "fused_mixer_bwd",
           "fused_ssd_fwd", "spiral_epilogue", "fused_ssd_bwd", "fused_mamba_fwd",
           "ssd_core_fwd")

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
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


def build_all(names=SOURCES) -> dict:
    """Build several sources at once, one nvcc process each; name -> BuildResult."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: future.result() for name, future in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(build(name).path)
