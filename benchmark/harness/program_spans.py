"""The program's own spans and counters, read against the device trace of a
traced window.

The port records spans and counters at its boundaries
(``diffma_tpu_torch/utils/trace.py``): while ``torch.profiler`` records, each
span leaves a record with its start and end in ns on the clock of
``time.time_ns()``, which is the clock of the profiler's own events. Here the
records that fall inside ``DeviceTrace``'s window are set beside the trace's
kernels (``DeviceTrace``'s filter: device events with a duration whose name
is none of the harness's labels) and its CUDA runtime and driver calls
(``cuda*``, ``cu*``): a kernel carries the correlation id of the call that
launched it (a ``cudaLaunchKernel``, or the ``cudaGraphLaunch`` of a graph's
replay), and the call lies inside the span that made it. All the arithmetic of
the per-layer metrics that read the program's spans is here; the program
only records.

A checkout whose port has no tracer, a run off the card, and a window with
no records read ``None``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Window", "counter_sum", "extent_idle_share", "extents", "graph_idle_share",
           "graph_kernels", "idle_inside", "merged", "tracer", "window"]

Interval = Tuple[int, int]


def tracer():
    """The port's tracer, or None where the port has none."""
    try:
        from diffma_tpu_torch.utils import trace
    except ImportError:
        return None
    return getattr(trace, "tracer", None)


@dataclasses.dataclass
class Window:
    """A traced window: its records, its kernels as (start, end, correlation
    id) in ns, its CUDA calls likewise, and its host seconds."""

    records: list
    kernels: List[Tuple[int, int, int]]
    launches: List[Tuple[int, int, int]]
    seconds: float

    def spans(self, name: str, **tags) -> list:
        return [r for r in self.records
                if r.name == name and all(r.tags.get(k) == v for k, v in tags.items())]


def window(ctx) -> Optional[Window]:
    """The traced window of ``ctx``, or None (off the card, no trace, no
    tracer, or no record begun inside it)."""
    trace = ctx.get("trace")
    tr = tracer()
    if not ctx.get("card") or trace is None or tr is None:
        return None
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    results = trace.prof.profiler.kineto_results
    start = results.trace_start_ns()
    kernels, launches, end = [], [], start
    for e in results.events():
        s, t = e.start_ns(), e.end_ns()
        end = max(end, t)
        if e.device_type() == cuda:
            if e.name() not in trace.labels and t > s:
                kernels.append((s, t, e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches.append((s, t, e.correlation_id()))
    records = [r for r in tr.records if start <= r.start_ns <= end]
    if not records:
        return None
    return Window(records, kernels, launches, trace.window_s)


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_inside(intervals: Sequence[Interval], busy: Sequence[Interval]) -> int:
    """The ns of ``intervals``' union that ``busy``'s union leaves uncovered."""
    busy = merged(busy)
    idle, j = 0, 0
    for s, e in merged(intervals):
        covered = 0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle


def extents(spans, launches, kernels) -> List[Optional[Interval]]:
    """For each span, the device extent of the work it launched: from the
    first to the last kernel that carries the correlation id of a CUDA call
    inside the span; None for a span that launched no kernel."""
    by_corr: Dict[int, List[int]] = {}
    for s, e, corr in kernels:
        ext = by_corr.setdefault(corr, [s, e])
        ext[0], ext[1] = min(ext[0], s), max(ext[1], e)
    calls = sorted(launches)
    starts = [s for s, _, _ in calls]
    out: List[Optional[Interval]] = []
    for r in spans:
        i, j = bisect.bisect_left(starts, r.start_ns), bisect.bisect_right(starts, r.end_ns)
        ends = [by_corr[c] for _, e, c in calls[i:j] if e <= r.end_ns and c in by_corr]
        out.append((min(s for s, _ in ends), max(e for _, e in ends)) if ends else None)
    return out


def graph_idle_share(ctx, graph: str) -> Optional[float]:
    """The card's idle time inside the device extents of the ``graph``
    replays of the window, in % of the window's host seconds."""
    w = window(ctx)
    if w is None:
        return None
    exts = [x for x in extents(w.spans("graph.replay", graph=graph), w.launches, w.kernels)
            if x is not None]
    if not exts:
        return None
    idle = idle_inside(exts, [(s, e) for s, e, _ in w.kernels])
    return 100.0 * idle / 1e9 / w.seconds


def extent_idle_share(ctx, name: str) -> Optional[float]:
    """The share of the device extents of the ``name`` spans (what each
    launched, ``extents``) in which no kernel ran, in %: 100 where none of
    them launched a kernel."""
    w = window(ctx)
    if w is None:
        return None
    spans = w.spans(name)
    if not spans:
        return None
    exts = merged([x for x in extents(spans, w.launches, w.kernels) if x is not None])
    total = sum(e - s for s, e in exts)
    if total <= 0:
        return 100.0
    return 100.0 * idle_inside(exts, [(s, e) for s, e, _ in w.kernels]) / total


def counter_sum(ctx, names: Sequence[str], counter: str) -> Optional[int]:
    """The sum of ``counter``'s deltas on the window's spans named in
    ``names``; None where no such span holds it."""
    w = window(ctx)
    if w is None:
        return None
    values = [r.counters[counter] for r in w.records
              if r.name in names and counter in r.counters]
    return sum(values) if values else None


def graph_kernels(ctx, graph: str) -> Optional[int]:
    """The kernel nodes of the program's captured ``graph``."""
    tr = tracer()
    if not ctx.get("card") or tr is None:
        return None
    nodes = getattr(tr, "graph_nodes", {}).get(graph)
    return None if nodes is None else nodes.get("kernel")
