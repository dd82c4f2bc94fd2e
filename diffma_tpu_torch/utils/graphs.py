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
replays stand for. The capture resolves the wrappers once; a replay adds to
them and looks nothing up.

Each ``Graph`` has a name (``train_step``, ``chain_step``). Its capture
keeps the CUDA graph beside its instantiation (``keep_graph``) and counts
its nodes by type (``nodes``; ``kernels`` the kernel nodes, every one of
which runs once a replay: cuBLAS's and ATen's as well as the wrappers'),
through the CUDA runtime that torch loaded (``cudaGraphGetNodes``,
``cudaGraphNodeGetType``, by ``ctypes``). The tracer (``utils/trace.py``)
keeps those counts by the graph's name, and records each capture and replay
as a span, ``graph.capture`` and ``graph.replay`` (the host's launch of the
captured program), tagged with the graph's name.

A ``Graph`` raises on a device that is not CUDA, and a capture that fails
raises: nothing here falls back to eager calls.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Callable, Dict, Optional

import torch

from diffma_tpu_torch.utils import trace

__all__ = ["Graph", "graph_nodes", "kernel_counters"]


def kernel_counters() -> dict:
    """Each kernel's wrapper by kernel name; its ``launches`` counts its launches
    (the bf16 variants of kernels C, D, E, F, G, H and P: a count that their
    wrapper keeps; ``masked_adamw``: the training step's optimizer update)."""
    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.fused_mixer import mixer_fused_bwd_cuda, mixer_fused_cuda
    from diffma_tpu_torch.ops.masked_adamw import masked_adamw_cuda
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
            "spiral_epilogue_bf16": spiral_epilogue_cuda.bf16,
            "mamba_inner_fwd_bf16": mamba_inner_fused_cuda.bf16,
            "ssd_core_fwd_bf16": ssd_core_cuda.bf16, "masked_adamw": masked_adamw_cuda}


#: cudaGraphNodeType: the kinds counted apart; the rest are ``other``.
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_graph_api = None


def _runtime():
    """(get_nodes, node_type) of the CUDA runtime that torch loaded."""
    global _graph_api
    if _graph_api is None:
        major = (torch.version.cuda or "12").split(".")[0]
        lib = ctypes.CDLL(f"libcudart.so.{major}", mode=os.RTLD_NOLOAD)
        get, kind = lib.cudaGraphGetNodes, lib.cudaGraphNodeGetType
        ptr = ctypes.c_void_p
        get.argtypes = [ptr, ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_size_t)]
        kind.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
        get.restype = kind.restype = ctypes.c_int
        _graph_api = (get, kind)
    return _graph_api


def graph_nodes(raw: int) -> Dict[str, int]:
    """The nodes of the CUDA graph at ``raw`` (a ``cudaGraph_t``) by kind:
    ``kernel``, ``memcpy``, ``memset`` and ``other``."""
    get, kind = _runtime()
    counts = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    n = ctypes.c_size_t(0)
    if get(ctypes.c_void_p(raw), None, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and get(ctypes.c_void_p(raw), nodes, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    for node in nodes[: n.value]:
        t = ctypes.c_int(-1)
        if kind(node, ctypes.byref(t)):
            raise RuntimeError("cudaGraphNodeGetType failed")
        counts[_NODE_KINDS.get(t.value, "other")] += 1
    return counts


class Graph:
    """One function's call captured on ``device`` and replayed; ``pool`` is
    the memory pool of the entry point's graphs (a new one by default);
    ``name`` names it to the tracer."""

    def __init__(self, device, pool=None, name: str = "graph"):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.device = device
        self.name = name
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        #: Host seconds the capture took, and the bytes the device's caching
        #: allocator reserved during it (the pool's growth).
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        #: The captured graph's nodes by kind (``graph_nodes``).
        self.nodes: Dict[str, int] = {}
        self._counted = []  # (wrapper, launches a replay)

    @property
    def kernels(self) -> Optional[int]:
        """The captured graph's kernel nodes, each of which a replay runs once."""
        return self.nodes.get("kernel")

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
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first, so that the growth is the pool's
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with trace.span("graph.capture", graph=self.name):
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    out = fn(*args, **kw)
            finally:
                added = {name: c.launches - before[name] for name, c in counters.items()}
                for name, c in counters.items():
                    c.launches = before[name]
            graph.instantiate()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = {name: n for name, n in added.items() if n}
        self._counted = [(counters[name], n) for name, n in self.launches.items()]
        self.nodes = graph_nodes(graph.raw_cuda_graph())
        trace.tracer.graph_nodes[self.name] = dict(self.nodes)
        self.graph = graph
        return out

    def replay(self) -> None:
        """Launch the captured program on the current stream; count its kernels."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        with trace.span("graph.replay", alloc=True, graph=self.name):
            self.graph.replay()
        for wrapper, n in self._counted:
            wrapper.launches += n
