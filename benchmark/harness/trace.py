"""Host spans and the device trace of a short window.

``Spans`` labels what the host does (a batch draw, a graph replay, a loss
read, a chain, a decode, a host copy) as ``torch.profiler`` ranges, so that
the device trace can say what the host was doing while the card sat idle;
with ``events`` it also times named spans with CUDA events (read after the
window). ``DeviceTrace`` runs ``torch.profiler`` over a window and reduces
it: the seconds in which any kernel ran (the union of kernel intervals, the
arithmetic of ``diffma_tpu_torch/utils/profiling.py::_union_us`` at commit
8e06284), the window's host seconds, the kernels that took most time, and
the idle gaps by the host span that covers most of each. A trace that
records no device time for work that launches kernels raises: the profiler
has lost its records, and 0 is never reported.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

__all__ = ["DeviceTrace", "Spans", "cuda_ms"]


class Spans:
    """Named host spans: profiler ranges with ``labelled``; the ``timed``
    names also timed by CUDA events. Without either a span costs nothing."""

    def __init__(self, device, timed=(), labelled: bool = False):
        cuda = torch.device(device).type == "cuda"
        self.timed = set(timed) if cuda else set()
        self.labelled = labelled
        self.events: Dict[str, List] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ranged = (torch.profiler.record_function(name) if self.labelled
                  else contextlib.nullcontext())
        with ranged:
            if name not in self.timed:
                yield
                return
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.events[name].append((start, end))

    def ms(self, name: str) -> List[float]:
        """Each timed span's device ms; waits for the last one."""
        pairs = self.events.get(name, [])
        if pairs:
            pairs[-1][1].synchronize()
        return [s.elapsed_time(e) for s, e in pairs]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """``with DeviceTrace(device, labels) as tr: ...`` profiles the block;
    then ``tr.busy_s``, ``tr.window_s``, ``tr.idle_share``, ``tr.top_ops`` and
    ``tr.idle_gaps`` (by the ``labels`` of host spans)."""

    def __init__(self, device, labels=()):
        self.device = torch.device(device)
        self.labels = set(labels)
        self.busy_s = self.window_s = self.idle_share = None
        self.top_ops: List = []
        self.idle_gaps: List = []

    def __enter__(self):
        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self) -> None:
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        # the profiler mirrors each host range on the device's timeline (a
        # user annotation over the work it launched): not device work
        kernels = [e for e in events if e.device_type == cuda and e.name not in self.labels
                   and e.time_range.end > e.time_range.start]
        busy = _merged((e.time_range.start, e.time_range.end) for e in kernels)
        busy_us = sum(e - s for s, e in busy)
        if busy_us <= 0:
            raise RuntimeError("the device trace holds no kernel time for work that launches "
                               "kernels: the profiler lost its records")
        self.busy_s = busy_us / 1e6
        self.idle_share = max(0.0, 1.0 - self.busy_s / self.window_s)
        per_name = defaultdict(float)
        for e in kernels:
            per_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        self.top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        spans = [e for e in events if e.device_type != cuda and e.name in self.labels]
        starts = np.array([e.time_range.start for e in spans] + [0.0])
        ends = np.array([e.time_range.end for e in spans] + [0.0])
        names = [e.name for e in spans] + ["other host work"]
        idle = defaultdict(float)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            overlap = np.minimum(ends, b) - np.maximum(starts, a)
            overlap[-1] = 0.0  # no span covers the gap
            idle[names[int(np.argmax(overlap))]] += (b - a) / 1e6
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]


def cuda_ms(fn, reps: int, windows: int = 5) -> float:
    """Device ms of one call of ``fn``: the median over ``windows`` windows of
    the mean over back-to-back calls, CUDA events around each window. A copy
    of ``chip_smoke.py::cuda_ms`` at commit 8e06284."""
    fn()
    torch.cuda.synchronize()
    per_window = max(1, reps // windows)
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)
