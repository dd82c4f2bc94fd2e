#!/usr/bin/env python3
"""Does torch.profiler keep recording the port's kernels as a long process ages?

Runs ``chip_smoke.py``'s ``main`` with a probe after every phase: 10
profiled calls of kernel H's bf16 variant at (8, 49) (5 device kernels a
call) and of a 1024 x 1024 matmul (1 kernel a call), with
``utils/profiling.py::profile_calls``, each printed as

    PROFPROBE after <phase>: H bf16 busy <ms> (<kernels>/call), matmul busy ...

with the number of profiler sessions the process has opened so far. A
profiler that records every kernel reads 5.0 and 1.0 kernels a call after
every phase. Run from the root of a checkout, on an NVIDIA GPU with nvcc
(as long as ``chip_smoke.py`` itself, plus about half a second a phase):

    python tools/port_profiler_probe.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

sessions = [0]
_enter = torch.profiler.profile.__enter__


def _counting(self):
    sessions[0] += 1
    return _enter(self)


torch.profiler.profile.__enter__ = _counting


def probe(tag: str) -> None:
    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.utils.profiling import profile_calls

    args = cs.inner_bf16_args(8, 49)
    x = torch.randn(1024, 1024, device="cuda")
    with torch.no_grad():
        a = profile_calls(lambda: mamba_inner_fused_cuda(*args), calls=10, top=1000)
        b = profile_calls(lambda: x @ x, calls=10, top=100)
    print(f"PROFPROBE after {tag}: H bf16 busy {sum(a['top_kernels_ms_per_call'].values()):.4f} ms "
          f"({a['kernels_per_call']} kernels/call), matmul busy "
          f"{sum(b['top_kernels_ms_per_call'].values()):.4f} ms ({b['kernels_per_call']} "
          f"kernels/call); profiler sessions so far {sessions[0]}", flush=True)


def wrap(name: str, fn):
    def inner(*a, **k):
        out = fn(*a, **k)
        if name != "phase_build":
            probe(name)
        return out
    return inner


if __name__ == "__main__":
    for name in list(vars(cs)):
        if name.startswith("phase_") and callable(getattr(cs, name)):
            setattr(cs, name, wrap(name, getattr(cs, name)))
    sys.exit(cs.main())
