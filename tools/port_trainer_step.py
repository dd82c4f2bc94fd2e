#!/usr/bin/env python3
"""Where the PyTorch port's trainer CLI spends its step, on the host's clock.

    python tools/port_trainer_step.py [--config configs/brain.yaml] [--steps 40] [--real-data]
        [--autocast] [--use-mamba2]

Runs ``diffma_tpu_torch.train.train.main`` on the config (synthetic batches,
``--steps`` steps, a log every 10) three times in this process: as the CLI
runs it (the step a CUDA graph on the card), with the data loader replaced
by an iterator that hands the loop its first batch again and again (on
synthetic batches the trainer draws its batches on the card and never reads
the loader's arrays), and as the CLI runs it with the step eager
(``GraphedTrainStep`` replaced by the step it wraps). ``--real-data``
first writes 64 SynthRAD-like ``.npy`` triplets of 256 x 256 to a temporary
directory and trains on them, every batch encoded by the conditioning stack
(random frozen weights). In each run it times, per step and in this process
only, the spans that the loop is made of:

* ``loader``: the loop's wait for the loader's next batch (the batches are
  built by a background thread, whose own time shows only as this wait and
  as the time it takes from the loop's thread);
* ``batch``: ``synthetic_batch``, the batch drawn on the card;
* ``encode``: ``Conditioning.__call__``, the real batch encoded, queued
  (``encode_device_ms`` is the same span's device time, from the trainer's
  ``SpanTimer``, over the same steps);
* ``draws``: ``loss_draws``, the loss's t and noise drawn on the card;
* ``graph``: ``GraphedTrainStep.__call__``, the batch copied into the
  graph's buffers and the step replayed, queued (the spans below run inside
  it only at its warm-up and capture, in the first window);
* ``forward``: the loss, queued;
* ``backward``: ``loss.backward()``, queued;
* ``optimizer``: ``AdamW.step``, queued; ``ema``: ``update_ema``, queued;
* ``sync``: ``Tensor.cpu``, the log's read of the losses: the host's wait
  for the device (the step itself never waits);
* ``rest``: the remainder of the wall time (logging, the loop itself).

Each is reported in ms per step over the steps after the first log window
(the warm-up), beside the trainer's own steps/s for every window. It also
times the loader alone (ms per batch, host clock). ``--profiler-sessions N``
first opens and closes N ``torch.profiler`` sessions around a small product,
as a process that has profiled before (``chip_smoke.py``'s trainer phases
run after its profiled phases) would. It needs an NVIDIA GPU with nvcc;
``--device cpu`` runs it on the CPU at the config's size. ``--autocast``
trains the bf16 model, as the trainer's ``--autocast``; ``--use-mamba2`` the
Mamba-2 model (with ``--autocast`` kernels E's and F's bf16 variants).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPANS = ("loader", "batch", "encode", "draws", "graph", "forward", "backward", "optimizer", "ema",
         "sync")


def timed_run(cfg, device: str, with_loader: bool, graphed: bool = True) -> dict:
    import torch

    from diffma_tpu_torch.train import state as state_mod
    from diffma_tpu_torch.train import train as train_mod

    events = []  # (span, start, seconds outside the spans inside it)
    reports = []  # (time, steps, seconds) of each Throughput window
    encode_reads = []  # (time, device ms per step) of each SpanTimer read
    inner = []  # seconds of the spans inside each open span

    def timed_call(span, fn, *args, **kw):
        inner.append(0.0)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            dt = time.perf_counter() - t0
            events.append((span, t0, dt - inner.pop()))
            if inner:
                inner[-1] += dt

    def wrap(span, fn):
        return lambda *args, **kw: timed_call(span, fn, *args, **kw)

    def timed_loader(*args, **kw):
        it = orig["make_loader"](*args, **kw)
        if not with_loader:
            it = iter([next(it)] * (len(args[0]) // args[1]))
        done = object()
        while (item := timed_call("loader", next, it, done)) is not done:
            yield item

    class Throughput(train_mod.Throughput):
        def report(self):
            steps, dt = self._steps, time.perf_counter() - self._t0
            reports.append((time.perf_counter(), steps, dt))
            return super().report()

    def make_loss_fn(*args, **kw):
        return wrap("forward", orig["make_loss_fn"](*args, **kw))

    def read_encode(timer):
        ms = orig["read"](timer)
        encode_reads.append((time.perf_counter(), ms))
        return ms

    orig = {"make_loader": train_mod.make_loader, "make_loss_fn": train_mod.make_loss_fn,
            "read": train_mod.SpanTimer.read}
    patches = [
        (train_mod, "make_loader", timed_loader),
        (train_mod, "make_loss_fn", make_loss_fn),
        (train_mod, "synthetic_batch", wrap("batch", train_mod.synthetic_batch)),
        (train_mod.Conditioning, "__call__", wrap("encode", train_mod.Conditioning.__call__)),
        (train_mod.SpanTimer, "read", read_encode),
        (train_mod, "Throughput", Throughput),
        (train_mod, "loss_draws", wrap("draws", train_mod.loss_draws)),
        (train_mod.GraphedTrainStep, "__call__",
         wrap("graph", train_mod.GraphedTrainStep.__call__)),
        (state_mod, "update_ema", wrap("ema", state_mod.update_ema)),
        (torch.Tensor, "backward", wrap("backward", torch.Tensor.backward)),
        (torch.Tensor, "cpu", wrap("sync", torch.Tensor.cpu)),
        (torch.optim.AdamW, "step", wrap("optimizer", torch.optim.AdamW.step)),
    ]
    if not graphed:
        patches.append((train_mod, "GraphedTrainStep", lambda step, device: step))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        train_mod.main(cfg, device=device)
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
    if len(reports) < 2:
        raise SystemExit("run more steps than two log windows")
    start = reports[0][0]  # the first window is the warm-up
    steps = sum(n for _, n, _ in reports[1:])
    wall = sum(dt for _, _, dt in reports[1:])
    spans = defaultdict(float)
    for span, t0, dt in events:
        if start <= t0 <= reports[-1][0]:
            spans[span] += dt
    out = {"steps": steps, "ms_per_step": wall * 1e3 / steps,
           "steps_per_sec_by_window": [n / dt for _, n, dt in reports]}
    out.update({span: spans[span] * 1e3 / steps for span in SPANS})
    out["rest"] = out["ms_per_step"] - sum(out[span] for span in SPANS)
    reads = [ms for t, ms in encode_reads if start < t]
    out["encode_device_ms"] = sum(reads) / len(reads) if reads else None
    return out


def profile_sessions(n: int, device: str) -> None:
    import torch

    x = torch.randn(256, 256, device=device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(n):
        with torch.profiler.profile(activities=activities):
            (x @ x).sum().item()


def loader_alone(cfg, batches: int = 16) -> float:
    """Host ms per batch of the trainer's loader over its dataset."""
    from diffma_tpu_torch.data.npy_dataset import make_loader
    from diffma_tpu_torch.train.train import make_dataset

    dataset = make_dataset(cfg, "train", synthetic_size=64)
    batch_size, n, t0 = int(cfg.global_batch_size), 0, time.perf_counter()
    for epoch in range(batches):
        for _ in make_loader(dataset, batch_size, seed=0, epoch=epoch):
            n += 1
            if n == batches:
                return (time.perf_counter() - t0) * 1e3 / n
    return (time.perf_counter() - t0) * 1e3 / max(n, 1)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/brain.yaml")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model", default=None, help="override the config's model")
    parser.add_argument("--hidden-size", dest="hidden_size", type=int, default=None)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--real-data", dest="real_data", action="store_true",
                        help="train on .npy folders that it writes, every batch encoded")
    parser.add_argument("--profiler-sessions", dest="profiler_sessions", type=int, default=0,
                        help="torch.profiler sessions to run before the trainer")
    parser.add_argument("--autocast", action="store_true", help="the model in bfloat16")
    parser.add_argument("--use-mamba2", dest="use_mamba2", action="store_true",
                        help="the Mamba-2 mixers")
    parser.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = parser.parse_args(argv)

    from diffma_tpu_torch.data.npy_dataset import write_triplet_folders
    from diffma_tpu_torch.utils.config import load_config, merge

    report = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        folders = (write_triplet_folders(os.path.join(tmp, "data"), 64, mri_outside=8)
                   if args.real_data else {})
        cfg = merge(load_config(args.config), {
            "synthetic_data": not args.real_data, "max_steps": args.steps, "log_every": 10,
            "results_dir": os.path.join(tmp, "results"), "model": args.model,
            "hidden_size": args.hidden_size, "global_batch_size": args.batch, "ct_ckpt": "",
            "autocast": args.autocast or None, "use_mamba2": args.use_mamba2 or None,
            **folders})
        if args.device == "cuda":
            import subprocess

            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            report["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        report.update({"config": args.config, "model": str(cfg.model),
                       "batch": int(cfg.global_batch_size), "device": args.device,
                       "real_data": args.real_data, "autocast": args.autocast,
                       "use_mamba2": args.use_mamba2,
                       "profiler_sessions": args.profiler_sessions})
        profile_sessions(args.profiler_sessions, args.device)
        report["cli"] = timed_run(cfg, args.device, with_loader=True)
        report["no_loader"] = timed_run(cfg, args.device, with_loader=False)
        report["eager"] = timed_run(cfg, args.device, with_loader=True, graphed=False)
        report["loader_alone_ms_per_batch"] = loader_alone(cfg)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
