"""The readers of the program's spans and counters
(``harness/program_spans.py`` and the six metrics that use it), on hand-made
traces with planted gaps, and on the card a traced window read with the
program's records on and off."""

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import program_spans  # noqa: E402
from benchmark.harness.cell import load_reader  # noqa: E402
from diffma_tpu_torch.utils.trace import Record, Tracer  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
START = 10**12
READERS = ["graph_idle_share.train", "graph_idle_share.sample", "graph_kernels.train",
           "graph_kernels.sample", "decode_idle_share", "allocator_calls.sample"]


class Event:
    def __init__(self, name, device, start, end, corr):
        self._v = (name, device, START + start, START + end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _ctx(events, window_s, labels=()):
    results = types.SimpleNamespace(trace_start_ns=lambda: START, events=lambda: events)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))
    trace = types.SimpleNamespace(prof=prof, labels=set(labels), window_s=window_s)
    return {"card": True, "trace": trace}


def _record(name, start, end, rid, **tags):
    counters = tags.pop("counters", {})
    return Record(name, START + start, START + end, rid, 0, 1, tags, counters)


@pytest.fixture
def tracer(monkeypatch):
    tr = Tracer()
    monkeypatch.setattr(program_spans, "tracer", lambda: tr)
    return tr


def _replays():
    """Two replays of ``train_step``, host spans [0, 100] and [500, 600]
    (ns after the trace's start), each with its launch inside; the first's
    kernels at [50, 150] and [170, 250] (a 20 ns gap inside its extent), the
    second's at [650, 700] and [700, 800]; the card idle from 250 to 650
    between them, and a labelled host range mirrored on the device."""
    events = [
        Event("cudaGraphLaunch", CPU, 10, 90, 7),
        Event("k1", CUDA, 50, 150, 7), Event("k2", CUDA, 170, 250, 7),
        Event("cudaGraphLaunch", CPU, 510, 590, 9),
        Event("k1", CUDA, 650, 700, 9), Event("k2", CUDA, 700, 800, 9),
        Event("graph replay", CUDA, 0, 1000, 0),  # the harness's label, mirrored
        Event("[memory]", CUDA, 300, 300, 0),
    ]
    records = [_record("graph.replay", 0, 100, 1, graph="train_step"),
               _record("graph.replay", 500, 600, 2, graph="train_step"),
               _record("graph.replay", 520, 580, 3, graph="chain_step")]
    return events, records


def test_a_gap_inside_a_replay_counts_and_one_between_replays_does_not(tracer):
    events, records = _replays()
    tracer.records.extend(records)
    ctx = _ctx(events, window_s=1e-6, labels=("graph replay",))
    # extents [50, 250] and [650, 800]: 20 ns idle inside, of a 1000 ns window
    assert program_spans.graph_idle_share(ctx, "train_step") == pytest.approx(2.0)
    assert load_reader("graph_idle_share.train").read(ctx) == pytest.approx(2.0)
    # no launch lies inside the chain's span: no extent, nothing to read
    assert load_reader("graph_idle_share.sample").read(ctx) is None
    assert program_spans.idle_inside([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_a_mirrored_label_is_not_a_kernel(tracer):
    events, records = _replays()
    tracer.records.extend(records)
    # without the label the mirrored range covers the gap
    assert program_spans.graph_idle_share(_ctx(events, 1e-6), "train_step") == 0.0


def test_decode_idle_share_reads_the_decode_s_device_extent(tracer):
    """The decode's host span is [100, 300]; it launches kernels that run at
    [300, 400] and [500, 600], while the chain's last kernel, launched before
    it, still runs at [100, 250]: the extent [300, 600] is a third idle."""
    events = [Event("cudaLaunchKernel", CPU, 20, 30, 1), Event("chain", CUDA, 100, 250, 1),
              Event("cudaLaunchKernel", CPU, 120, 130, 2), Event("conv", CUDA, 300, 400, 2),
              Event("cuLaunchKernel", CPU, 200, 210, 3), Event("conv", CUDA, 500, 600, 3),
              Event("cudaDeviceSynchronize", CPU, 0, 1000, 4)]  # the window's last wait
    tracer.records.append(_record("vae.decode", 100, 300, 1))
    ctx = _ctx(events, 1e-6)
    assert load_reader("decode_idle_share").read(ctx) == pytest.approx(100.0 / 3)
    tracer.records.clear()
    tracer.records.append(_record("vae.decode", 700, 800, 2))  # launched no kernel
    assert load_reader("decode_idle_share").read(ctx) == pytest.approx(100.0)


def test_extents_take_the_calls_inside_each_span():
    kernels = [(50, 60, 1), (70, 90, 2), (95, 99, 3)]
    calls = [(0, 5, 1), (10, 20, 2), (30, 40, 3)]
    spans = [_record("s", -START, 25 - START, 1), _record("s", 28 - START, 35 - START, 2)]
    # the second span ends before its call returns: that call is not its
    assert program_spans.extents(spans, calls, kernels) == [(50, 90), None]


def test_allocator_calls_and_graph_kernels(tracer):
    events = [Event("k", CUDA, 0, 900, 1)]
    tracer.records.extend([
        _record("diffusion.chain", 0, 400, 1, counters={"allocator_calls": 2}),
        _record("vae.decode", 400, 900, 2, counters={"allocator_calls": 3}),
        _record("graph.replay", 10, 20, 3, graph="chain_step", counters={"allocator_calls": 5}),
        _record("vae.decode", 2 * 10**9, 2 * 10**9 + 1, 4, counters={"allocator_calls": 7}),
    ])  # the last begins after the window: not read
    ctx = _ctx(events, 1e-6)
    assert load_reader("allocator_calls.sample").read(ctx) == 5
    tracer.graph_nodes["chain_step"] = {"kernel": 412, "memcpy": 3, "memset": 1, "other": 0}
    assert load_reader("graph_kernels.sample").read(ctx) == 412
    assert load_reader("graph_kernels.train").read(ctx) is None


def test_no_records_in_the_window_reads_nothing(tracer):
    ctx = _ctx([Event("k", CUDA, 0, 10, 1)], 1e-6)
    for name in ("graph_idle_share.train", "decode_idle_share", "allocator_calls.sample"):
        assert load_reader(name).read(ctx) is None


@pytest.mark.parametrize("metric", READERS)
def test_readers_return_none_off_the_card(metric, tracer):
    events, records = _replays()
    tracer.records.extend(records)
    tracer.graph_nodes["train_step"] = {"kernel": 1}
    ctx = dict(_ctx(events, 1e-6), card=False)
    assert load_reader(metric).read(ctx) is None
    assert load_reader(metric).read({"card": False, "trace": None}) is None


def test_readers_return_none_where_the_port_has_no_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    events, _ = _replays()
    for metric in READERS:
        assert load_reader(metric).read(_ctx(events, 1e-6)) is None


@pytest.mark.cuda
def test_device_trace_reads_the_same_with_the_records_on_and_off():
    """``DeviceTrace``'s busy seconds and top operations over the same graph
    replays, with the program's records off and on, in turns: the profiler
    is told nothing of them, so nothing of them is mirrored on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.harness.trace import DeviceTrace
    from diffma_tpu_torch.utils import trace
    from diffma_tpu_torch.utils.graphs import Graph

    x = torch.randn(2048, 2048, device="cuda")
    out = torch.empty_like(x)
    g = Graph("cuda", name="probe")
    g.warm_up(lambda: out.copy_(torch.relu(x @ x)))
    g.capture(lambda: out.copy_(torch.relu(x @ x)))
    readings = {False: [], True: []}
    for on in (False, True, True, False):
        for _ in range(50):  # the card at its clocks before each window
            g.replay()
        trace.tracer.records_on = on
        n = len(trace.tracer.records)
        try:
            with DeviceTrace("cuda") as tr:
                for _ in range(200):
                    g.replay()
        finally:
            trace.tracer.records_on = None
        assert len(trace.tracer.records) - n == (200 if on else 0)
        readings[on].append((tr.busy_s, sorted(name for name, _ in tr.top_ops)))
    names = {tuple(n) for r in readings.values() for _, n in r}
    assert len(names) == 1, readings
    off, on = ([b for b, _ in readings[k]] for k in (False, True))
    assert abs(sum(on) - sum(off)) <= 0.05 * sum(off), readings
