"""ctypes binding of the native C++ triplet loader.

Counterpart of ``diffma_tpu/data/native.py``: ``.npy`` decode and PIL-like
resizes (CT bilinear, mask and MRI nearest) in a C++ thread pool, off the
interpreter lock, from the repository's ``native/npy_loader.cpp``. The port
builds its own library from that source with ``g++`` and the flags of
``native/Makefile``, into ``diffma_tpu_torch/_build/`` (``native/`` is left
as it is). The file name carries a hash of the source, the flags, the
compiler's version and the host CPU that ``-march=native`` targets; a
library is compiled into a temporary file and published with one
``os.replace``, so processes that build at once each see a whole library
or none.

The resizes are not PIL's in every case: at some size pairs the nearest
index lands on the other side of PIL's, and the bilinear CT agrees to about
2e-4 (``tests/test_native_loader.py``). The trainer takes this loader for
its train split, as the JAX trainer does (``train/train.py::make_dataset``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

import numpy as np

__all__ = ["NativeTripletLoader", "build", "load_native_lib"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "npy_loader.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")  # native/Makefile
LD_FLAGS = ("-shared", "-lpthread")

_FLOATS = ctypes.POINTER(ctypes.c_float)


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader needs a C++ compiler")
    return cxx


def _native_target(cxx: str) -> str:
    """The CPU that ``-march=native`` compiles for, as the compiler names it."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    for line in out.stdout.splitlines():
        if line.strip().startswith("-march="):
            return line.split()[-1]
    return "unknown"


def _cxx_version(cxx: str) -> str:
    out = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def build() -> str:
    """Compile ``native/npy_loader.cpp`` unless a library of the same source,
    flags, compiler version and target exists; returns its path."""
    cxx = _cxx()
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join((cxx, _cxx_version(cxx), *CXX_FLAGS, *LD_FLAGS,
                            _native_target(cxx))).encode())
    path = os.path.join(BUILD_DIR, f"libdiffma_loader-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load_native_lib() -> ctypes.CDLL:
    """Build (if needed) and load the loader's library, with the argument
    types of its two C entry points; cached per process. Raises
    ``RuntimeError`` or ``OSError`` when it cannot be built or loaded."""
    lib = ctypes.CDLL(build())
    lib.diffma_load_batch.restype = ctypes.c_int
    lib.diffma_load_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _FLOATS, _FLOATS, _FLOATS,
    ]
    lib.diffma_load_triplet.restype = ctypes.c_int
    lib.diffma_load_triplet.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        _FLOATS, _FLOATS, _FLOATS,
    ]
    return lib


class NativeTripletLoader:
    """Batches over the three parallel ``.npy`` folders from the C++ pool:
    (B, 1, S, S) float32 per stream, the mask remapped to (m + 1) / 2, as
    the Python path gives them. ``threads`` 0 takes one thread per core."""

    def __init__(self, image_folder: str, mask_folder: str, mri_folder: str,
                 size: int = 224, threads: int = 0):
        self.lib = load_native_lib()
        self.folders = (image_folder, mask_folder, mri_folder)
        self.images = sorted(os.listdir(image_folder))
        self.size = int(size)
        self.threads = int(threads)

    def __len__(self) -> int:
        return len(self.images)

    def load_batch(self, indices) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        names = [self.images[int(i)] for i in indices]
        B, S = len(names), self.size
        bufs = [np.empty((B, S, S), np.float32) for _ in range(3)]
        paths = ["\n".join(os.path.join(folder, n) for n in names).encode()
                 for folder in self.folders]
        fails = self.lib.diffma_load_batch(
            *paths, B, S, self.threads, *(b.ctypes.data_as(_FLOATS) for b in bufs))
        if fails:
            raise IOError(f"native loader failed on {fails}/{B} files")
        ct, mask, mri = (b[:, None] for b in bufs)
        return ct, mask, mri
