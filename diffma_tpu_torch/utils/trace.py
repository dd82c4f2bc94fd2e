"""The port's tracer: named spans and counters at the program's boundaries.

``span(name)`` is a context manager around one piece of work: a graph's
replay, the sampler's chain, the VAE's decode, one stage of the trainer's
loop. Every span adds to its name's totals (a count and host ns, and with
``device=True`` device ms between CUDA events on the current stream), which
the trainer's and the sampler's log lines read with ``take``. While a
``torch.profiler`` records (the benchmark's traced window, the trainer's
``profile_dir`` window), each span also leaves a
``Record`` in a bounded buffer: its name, its start and end in ns on the
clock of ``time.time_ns()`` (the clock of the profiler's events, offset by
the trace's ``trace_start_ns``), its parent span, the group it belongs to (one
training step, one sampling request: ``group()``), its tags, and its
counters: a span opened with ``alloc=True`` takes the delta of the caching
allocator's ``cudaMalloc`` and ``cudaFree`` calls over it. Without a
profiler a span costs one check and two clock reads. ``records_on``
overrides the profiler: True records without one, False records nothing
under one (the tracing's cost, the tests).

``graph_nodes`` holds each captured graph's nodes by type, by graph name
(``utils/graphs.py``); a graph's replays and captures are its
``graph.replay`` and ``graph.capture`` spans. Nothing here emits a
``record_function`` range: the profiler would mirror it on the device's
timeline, where it reads as device work.

The tracer serves one thread: the spans of a process nest as its calls do.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time
from typing import Deque, Dict, List, Optional

import torch

__all__ = ["Record", "Total", "Tracer", "group", "span", "take", "tracer"]

#: Records kept while recording: the oldest go first.
CAPACITY = 65536

_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Record:
    """One span, as recorded: ``parent`` and ``rid`` are record ids (0: no
    parent), ``group`` the id of the step or request it served."""

    name: str
    start_ns: int
    end_ns: int
    rid: int
    parent: int
    group: int
    tags: Dict[str, object]
    counters: Dict[str, int]


@dataclasses.dataclass
class Total:
    """A name's spans since the last ``take``: their count, host ms and, for
    ``device`` spans on the card, device ms (None elsewhere)."""

    count: int = 0
    host_ms: float = 0.0
    device_ms: Optional[float] = None


def _allocator_calls() -> int:
    if not torch.cuda.is_initialized():
        return 0
    stats = torch.cuda.memory_stats()
    return int(stats.get("num_device_alloc", 0)) + int(stats.get("num_device_free", 0))


class _Totals:
    __slots__ = ("count", "host_ns", "device_ms", "pairs")

    def __init__(self):
        self.count, self.host_ns, self.device_ms, self.pairs = 0, 0, 0.0, []

    def fold(self, wait: bool) -> None:
        """Adds the device ms of the pairs that the card has finished; with
        ``wait``, of every pair, waiting for each."""
        pending = []
        for a, b in self.pairs:
            if wait:
                b.synchronize()
            elif not b.query():
                pending.append((a, b))
                continue
            self.device_ms += a.elapsed_time(b)
        self.pairs = pending


class _Span:
    __slots__ = ("tracer", "name", "device", "alloc", "tags", "t0", "record", "events",
                 "allocs")

    def __init__(self, tracer, name, device, alloc, tags):
        self.tracer, self.name, self.device, self.alloc, self.tags = (
            tracer, name, device, alloc, tags)

    def __enter__(self):
        tr = self.tracer
        self.record = None
        on = tr.records_on
        if on or (on is None and _profiling()):
            tr._open(self)
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        tr = self.tracer
        if self.events is not None:
            self.events[1].record()
        tot = tr._totals.get(self.name)
        if tot is None:
            tot = tr._totals[self.name] = _Totals()
        tot.count += 1
        tot.host_ns += t1 - self.t0
        if self.events is not None:
            tot.pairs.append(self.events)
            if len(tot.pairs) > 256:  # read by no log: keep the events few
                tot.fold(wait=False)
        if self.record is not None:
            tr._close(self, t1)
        return False


class Tracer:
    """Spans, their totals and records, and the captured graphs' nodes;
    ``tracer`` is the process's one instance."""

    def __init__(self, capacity: int = CAPACITY):
        self.records: Deque[Record] = collections.deque(maxlen=capacity)
        #: Each captured graph's nodes by type (``kernel``, ``memset``,
        #: ``memcpy``, ``other``), by graph name.
        self.graph_nodes: Dict[str, Dict[str, int]] = {}
        #: None: records while a profiler records; True or False: always, never.
        self.records_on: Optional[bool] = None
        self._totals: Dict[str, _Totals] = {}
        self._stack: List[_Span] = []
        self._ids = itertools.count(1)
        self._group = 0

    def span(self, name: str, device: bool = False, alloc: bool = False, **tags) -> _Span:
        """A span named ``name``; ``device``: also timed by CUDA events;
        ``alloc``: its record takes the allocator calls made over it; ``tags``
        go into its record."""
        return _Span(self, name, device, alloc, tags)

    def group(self) -> int:
        """Starts the next group (a step, a request): the spans opened from
        now on share its id, which this returns."""
        self._group += 1
        return self._group

    def take(self, name: str) -> Total:
        """``name``'s totals since the last ``take``, which it resets; waits
        for the device where they hold device time."""
        tot = self._totals.pop(name, None)
        if tot is None:
            return Total()
        device = None
        if tot.pairs or tot.device_ms:
            tot.fold(wait=True)
            device = tot.device_ms
        return Total(tot.count, tot.host_ns / 1e6, device)

    def _open(self, sp: _Span) -> None:
        parent = self._stack[-1].record if self._stack else None
        sp.record = Record(sp.name, 0, 0, next(self._ids), parent.rid if parent else 0,
                           self._group, sp.tags, {})
        sp.allocs = _allocator_calls() if sp.alloc else 0
        self._stack.append(sp)

    def _close(self, sp: _Span, t1: int) -> None:
        rec = sp.record
        rec.start_ns, rec.end_ns = sp.t0, t1
        if sp.alloc:
            rec.counters["allocator_calls"] = _allocator_calls() - sp.allocs
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        self.records.append(rec)

    def add_to_chrome_trace(self, path: str, since_ns: int = 0) -> None:
        """Appends the records begun from ``since_ns`` on to the Chrome trace
        at ``path`` that ``torch.profiler`` exported, on its clock (``ts`` in
        µs after the trace's ``baseTimeNanoseconds``), as one host track."""
        with open(path) as f:
            trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        trace["traceEvents"].extend(
            {"ph": "X", "cat": "program", "name": r.name, "pid": "program spans",
             "tid": "spans", "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": {"id": r.rid, "parent": r.parent, "group": r.group, **r.tags, **r.counters}}
            for r in self.records if r.start_ns >= since_ns)
        with open(path, "w") as f:
            json.dump(trace, f)


tracer = Tracer()
span = tracer.span
group = tracer.group
take = tracer.take
