"""CUDA graphs: the port's counterpart of ``jax.jit`` over a whole program.

The JAX package runs a sampling chain and a training step each as one
device program. Here a ``Graph`` records the launches of one call of a
function on the card (``torch.cuda.CUDAGraph``) and replays them with one
host call. The function reads its inputs from static buffers that the
caller fills before each replay, and its outputs are static too: a replay
overwrites them, so a caller that keeps one clones it.

* ``warm_up`` runs the function eagerly on the graph's own stream. What a
  first call does once (a kernel library loaded, a ``cudaFuncSetAttribute``
  set, an index table copied to the card, the optimizer's state made) then
  happens outside the capture, which would refuse a copy from the host.
* ``capture`` records one call on that stream. Nothing runs. Its
  allocations come from the memory pool that the ``Graph`` was given, one
  pool per entry point, shared by its graphs: graphs that share a pool are
  replayed in the order they were captured, never interleaved.
* ``replay`` launches the recorded program on the current stream.

Each kernel wrapper counts its launches in its ``launches`` attribute. The
capture sets the counts back to what they were before it, since nothing
ran, and keeps what it added to each as the graph's ``launches``; every
replay adds that again, so the counts are those of the eager calls that the
replays stand for.

A ``Graph`` raises on a device that is not CUDA, and a capture that fails
raises: nothing here falls back to eager calls.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

__all__ = ["Graph", "kernel_counters"]


def kernel_counters() -> dict:
    """Each kernel's wrapper by kernel name; its ``launches`` counts its launches
    (the bf16 variants of kernels C, D, E, F and G: a count that their wrapper
    keeps)."""
    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.fused_mixer import mixer_fused_bwd_cuda, mixer_fused_cuda
    from diffma_tpu_torch.ops.fused_ssd import (
        spiral_epilogue_cuda,
        ssd_core_cuda,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_cuda, selective_scan_cuda

    return {"selective_scan_fwd": selective_scan_cuda, "mixer_fused_fwd": mixer_fused_cuda,
            "selective_scan_bwd": selective_scan_bwd_cuda, "mixer_fused_bwd": mixer_fused_bwd_cuda,
            "ssd_mixer_fwd": ssd_mixer_fused_cuda, "spiral_epilogue": spiral_epilogue_cuda,
            "ssd_mixer_bwd": ssd_mixer_fused_bwd_cuda, "mamba_inner_fwd": mamba_inner_fused_cuda,
            "ssd_core_fwd": ssd_core_cuda, "mixer_fused_fwd_bf16": mixer_fused_cuda.bf16,
            "mixer_fused_bwd_bf16": mixer_fused_bwd_cuda.bf16,
            "ssd_mixer_fwd_bf16": ssd_mixer_fused_cuda.bf16,
            "ssd_mixer_bwd_bf16": ssd_mixer_fused_bwd_cuda.bf16,
            "spiral_epilogue_bf16": spiral_epilogue_cuda.bf16}


class Graph:
    """One function's call captured on ``device`` and replayed; ``pool`` is
    the memory pool of the entry point's graphs (a new one by default)."""

    def __init__(self, device, pool=None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        #: Host seconds the capture took, and the bytes the device's caching
        #: allocator reserved during it (the pool's growth).
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def _on_stream(self, fn: Callable, *args, **kw):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*args, **kw)
        current.wait_stream(self.stream)
        return out

    def warm_up(self, fn: Callable, *args, **kw):
        """``fn(*args, **kw)`` run eagerly on the graph's stream; its result."""
        return self._on_stream(fn, *args, **kw)

    def capture(self, fn: Callable, *args, **kw):
        """Record ``fn(*args, **kw)``; returns its (static) result. Runs nothing."""
        if self.graph is not None:
            raise RuntimeError("this graph has been captured already")
        counters = kernel_counters()
        before = {name: c.launches for name, c in counters.items()}
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first, so that the growth is the pool's
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = fn(*args, **kw)
        finally:
            added = {name: c.launches - before[name] for name, c in counters.items()}
            for name, c in counters.items():
                c.launches = before[name]
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = {name: n for name, n in added.items() if n}
        self.graph = graph
        return out

    def replay(self) -> None:
        """Launch the captured program on the current stream; count its kernels."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        self.graph.replay()
        counters = kernel_counters()
        for name, n in self.launches.items():
            counters[name].launches += n
