"""The port's tracer (``utils/trace.py``) and the spans at its boundaries.

On the CPU: a span keeps its name's totals always and a record only while
``torch.profiler`` records (or while ``records_on``); records nest with their
parents and share their group's id; a span's interval, on the clock of
``time.time_ns()``, holds the profiler's events launched inside it;
``Graph.replay`` adds its launches to wrappers it resolved at capture; the
sampler's request is one group of nested spans. On the card (marked
``cuda``, run with ``python -m pytest --noconftest -m cuda
tests/test_torch_trace.py``): a span around a kernel and a synchronize
holds the kernel's device interval, and a captured graph's kernel, memcpy
and memset nodes equal the device events a replay runs in the trace (each
graph in a fresh process).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from diffma_tpu_torch.utils import graphs, trace
from diffma_tpu_torch.utils.trace import Tracer


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_without_a_profiler_a_span_keeps_totals_and_no_record():
    tr = Tracer()
    for _ in range(3):
        with tr.span("a"):
            time.sleep(0.001)
    with tr.span("b", device=True):
        pass
    assert not tr.records
    a = tr.take("a")
    assert a.count == 3 and a.host_ms >= 3.0 and a.device_ms is None
    assert tr.take("a").count == 0  # taken: reset
    assert tr.take("b").count == 1


def test_under_a_profiler_spans_nest_with_their_parents_and_groups():
    tr = Tracer()
    with _profile():
        first = tr.group()
        with tr.span("step", kind="outer"):
            with tr.span("inner", alloc=True):
                pass
            with tr.span("inner"):
                pass
        second = tr.group()
        with tr.span("step"):
            pass
    with tr.span("after"):  # the profiler has stopped
        pass
    assert [r.name for r in tr.records] == ["inner", "inner", "step", "step"]  # as they end
    by_name = sorted(tr.records, key=lambda r: r.start_ns)
    outer, in1, in2, step2 = by_name
    assert (outer.name, in1.name, in2.name, step2.name) == ("step", "inner", "inner", "step")
    assert outer.parent == 0 and in1.parent == outer.rid and in2.parent == outer.rid
    assert step2.parent == 0 and len({r.rid for r in by_name}) == 4
    assert (outer.group, in1.group, in2.group, step2.group) == (first, first, first, second)
    assert outer.tags == {"kind": "outer"}
    assert in1.counters == {"allocator_calls": 0}  # no card
    assert in2.counters == {} and outer.counters == {}
    assert outer.start_ns <= in1.start_ns <= in1.end_ns <= in2.start_ns <= outer.end_ns
    assert all(r.name != "after" for r in tr.records)


def test_records_on_without_a_profiler_and_the_allocator_counter():
    tr = Tracer()
    tr.records_on = True
    with tr.span("decode", alloc=True):
        pass
    (rec,) = tr.records
    assert rec.counters == {"allocator_calls": 0}


def test_records_off_under_a_profiler_records_nothing():
    tr = Tracer()
    tr.records_on = False
    with _profile():
        with tr.span("s"):
            pass
    assert not tr.records and tr.take("s").count == 1


def test_records_are_bounded():
    tr = Tracer(capacity=4)
    tr.records_on = True
    for _ in range(10):
        with tr.span("s"):
            pass
    assert len(tr.records) == 4 and tr.take("s").count == 10


def test_a_span_holds_the_profiler_events_launched_inside_it():
    """The records' clock is the profiler's: its events offset by the
    trace's start."""
    tr = Tracer()
    x = torch.randn(64, 64)
    with _profile() as prof:
        for _ in range(3):
            with tr.span("mm"):
                x @ x
    start = prof.profiler.kineto_results.trace_start_ns()
    mms = sorted((int(start + e.time_range.start * 1e3), int(start + e.time_range.end * 1e3))
                 for e in prof.events() if e.name == "aten::mm")
    spans = sorted((r.start_ns, r.end_ns) for r in tr.records)
    assert len(mms) == len(spans) == 3
    for (s, e), (a, b) in zip(spans, mms):
        # the profiler's µs rounding: 1 µs either side
        assert s - 1000 <= a and b <= e + 1000, ((s, e), (a, b))


def test_step_profiler_trace_gets_the_records_on_its_clock(tmp_path):
    from diffma_tpu_torch.utils.profiling import StepProfiler

    prof = StepProfiler(str(tmp_path), start_step=1, num_steps=2)
    x = torch.randn(32, 32)
    for step in range(1, 4):
        trace.group()
        with trace.span("train.step"):
            x @ x
        prof.step(step)
    prof.close()
    (name,) = [p.name for p in tmp_path.iterdir()]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert ours and all(e["name"] == "train.step" for e in ours)
    for e in mm:  # each product lies inside one of the program's spans
        assert any(o["ts"] - 1 <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1
                   for o in ours)


class _Wrapper:
    launches = 0


def test_replay_adds_launches_to_the_wrappers_it_resolved_at_capture(monkeypatch):
    def no_lookup():
        raise AssertionError("a replay looks the wrappers up")

    class Captured:
        replays = 0

        def replay(self):
            Captured.replays += 1

    monkeypatch.setattr(graphs, "kernel_counters", no_lookup)
    g = graphs.Graph.__new__(graphs.Graph)
    wrapper = _Wrapper()
    g.graph, g.name = Captured(), "toy"
    g._counted = [(wrapper, 3)]
    trace.tracer.records_on = True
    n0 = len(trace.tracer.records)
    try:
        for _ in range(2):
            g.replay()
    finally:
        trace.tracer.records_on = None
    assert Captured.replays == 2 and wrapper.launches == 6
    recs = list(trace.tracer.records)[n0:]
    assert [(r.name, r.tags) for r in recs] == [("graph.replay", {"graph": "toy"})] * 2


class _Event:
    """A CUDA event's stand-in: done or not, 2 ms after its pair's first."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        return 2.0


def test_device_totals_fold_finished_pairs_without_waiting():
    tr = Tracer()
    tr.records_on = False
    with tr.span("s"):
        pass
    tot = tr._totals["s"]
    done, running = _Event(True), _Event(False)
    tot.pairs = [(_Event(True), done), (_Event(True), running)]
    tot.fold(wait=False)
    assert tot.device_ms == 2.0 and tot.pairs == [tot.pairs[0]] and not running.waited
    assert tr.take("s").device_ms == 4.0 and running.waited


def test_a_named_graph_still_needs_the_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.Graph("cpu", name="train_step")


def test_sampler_request_is_one_group_of_nested_spans(tmp_path, caplog):
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.utils.config import Config

    cfg = Config(model="DiffMa-S/2", image_size=32, hidden_size=32, sample_num_steps=3,
                 sample_global_batch_size=1, synthetic_data=True, synthetic_dataset_size=1,
                 save_dir=str(tmp_path), seed=0)
    model = sample.load_model(cfg, "cpu")
    trace.tracer.records_on = True
    n0 = len(trace.tracer.records)
    try:
        with caplog.at_level("INFO"):
            results = sample.sample_batches(model, cfg, "cpu")
    finally:
        trace.tracer.records_on = None
    assert len(results) == 1 and np.isfinite(results[0]["images"]).all()
    recs = list(trace.tracer.records)[n0:]
    (req,) = [r for r in recs if r.name == "sample.request"]
    names = {r.name: r for r in recs if r.parent == req.rid}
    assert set(names) == {"sample.encode", "diffusion.chain", "vae.decode", "sample.report"}
    assert all(r.group == req.group for r in recs)
    assert names["vae.decode"].counters["allocator_calls"] == 0  # no card
    assert all(f"{part} " in caplog.text for part in ("encode", "chain", "decode", "report"))
    assert 0 < results[0]["seconds"]


@pytest.mark.cuda
def test_a_span_around_a_kernel_holds_its_device_interval():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tr = Tracer()
    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with tr.span("mm"):
            x @ x
            torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    kernels = [e for e in results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.end_ns() > e.start_ns()]
    (rec,) = tr.records
    assert kernels
    for k in kernels:  # a few µs of slack for the two clocks' conversion
        assert rec.start_ns - 5000 <= k.start_ns() and k.end_ns() <= rec.end_ns + 5000


def _per_replay(fn_replay, replays=3):
    """The device events of each of ``replays`` calls of ``fn_replay`` (one
    graph launch each) in a profiler trace, by the correlation id of the
    call's ``cudaGraphLaunch``: their names, a list per replay."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            fn_replay()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launches = [e.correlation_id() for e in events if e.name().startswith("cudaGraphLaunch")]
    assert len(launches) == replays
    cuda = torch.autograd.DeviceType.CUDA
    return [[e.name() for e in events if e.device_type() == cuda and e.correlation_id() == c]
            for c in launches]


def graph_events(which: str) -> dict:
    """On the card, at the published widths (hidden 512, 196 tokens) and two
    blocks: the train step's or the chain step's graph, captured, its nodes
    and the device events of each of 3 replays by kind. Run in a fresh
    process: the profiler loses kernel records in one that has profiled."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.diffusion.gaussian import ChainGraph
    from diffma_tpu_torch.models.diffma import DiffMa
    from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train import fp32_output, loss_draws, make_loss_fn, synthetic_batch

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DiffMa(input_size=28, patch_size=2, hidden_size=512, depth=2,
                   scan_impl="fused").init_weights(torch.Generator().manual_seed(0)).cuda()
    if which == "train_step":
        diffusion = create_diffusion("", device="cuda")
        opt = adamw(model.parameters(), 1e-4)
        state = TrainState(model, opt)
        step = GraphedTrainStep(make_train_step(make_loss_fn(model, diffusion), opt), "cuda")
        for _ in range(3):
            b = synthetic_batch(gen, 2, 28, 196)
            b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
            step(state, b, gen)
        g = step.graph
        replays = _per_replay(g.replay)
    else:
        model.eval()
        chain = ChainGraph("cuda")
        z = torch.randn(1, 4, 28, 28, device="cuda", generator=gen)
        kw = {k: v for k, v in synthetic_batch(gen, 1, 28, 196).items() if k in ("y", "y2", "w")}
        with torch.no_grad():
            create_diffusion("4", device="cuda").p_sample_loop(
                fp32_output(model), z.shape, gen, noise=z, model_kwargs=kw, graph=chain)
            g = chain.graph
            replays = _per_replay(g.replay)
    seen = [{"memset": sum(n.startswith("Memset") for n in names), "events": len(names)}
            for names in replays]
    return {"nodes": g.nodes, "kernels": g.kernels, "tracer": trace.tracer.graph_nodes[which],
            "replays": seen}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["train_step", "chain_step"])
def test_graph_kernels_equal_the_kernels_a_replay_runs(which):
    """Each replay runs each of the graph's kernel, memcpy and memset nodes
    once; the trace names each memset node's event ``Memset``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; sys.path.insert(0, {here!r}); import test_torch_trace as t; "
            f"print(json.dumps(t.graph_events({which!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(here),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    nodes = got["nodes"]
    assert got["tracer"] == nodes and got["kernels"] == nodes["kernel"] and nodes["other"] == 0
    for seen in got["replays"]:
        assert seen["events"] == nodes["kernel"] + nodes["memcpy"] + nodes["memset"], got
        assert seen["memset"] == nodes["memset"], got
