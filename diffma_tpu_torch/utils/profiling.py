"""Where a denoiser call and a training step spend their time.

Counterpart of ``diffma_tpu/utils/profiling.py`` (which drives
``jax.profiler``). ``Throughput`` reports training steps/s and images/s
between log points, ``SpanTimer`` the time of one span of the step (the
trainer's conditioning encode); ``StepProfiler`` records a
``torch.profiler`` trace over a window of training steps (the trainer's
``profile_dir``, ``profile_start_step`` and ``profile_steps`` keys) and
writes it as a Chrome trace. ``profile_denoiser`` runs a few DiffMa forwards, and
``profile_train_step`` a few of the trainer's steps, eager and as the CUDA
graph the trainer replays, under ``torch.profiler``; each reports the
host-clock time per call, the device's busy time (the union of kernel
intervals), its idle share, the kernels launched per call, and the kernels
that take the most device time.

    python -m diffma_tpu_torch.utils.profiling --batch 1 --scan-impl fused
    python -m diffma_tpu_torch.utils.profiling --train --model DiffMa-L/2 --batch 8 [--real-data]

profile, on the card with random weights and conditioning, 5 denoiser
forwards of DiffMa-B/2 at 224² (the sampler's model) after one warm-up, or 5
training steps (hybrid loss, backward, the predicated AdamW and EMA) after 3
warm-up steps, eager and graphed. ``--scan-impl`` picks the mixers' path: ``fused``
(kernels C and D, the default on the card) or ``pallas`` (the composable
path with kernels A and B). ``--use-mamba2`` takes the Mamba-2 mixers
(``fused`` is then kernel E, and kernel F in a training step), and with it
the denoiser profile takes ``--fuse-block`` (kernels E and G). ``--autocast``
builds the model in bfloat16, as the trainer's and the sampler's
``--autocast`` do (kernels C's and D's bf16 variants, with ``--use-mamba2``
E's and F's, and with ``--fuse-block`` E's and G's).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.mamba import SCAN_IMPLS
from diffma_tpu_torch.utils.device import resolve_device

__all__ = ["SpanTimer", "StepProfiler", "Throughput", "profile_calls", "profile_denoiser",
           "profile_train_step"]


class StepProfiler:
    """A ``torch.profiler`` trace over steps [start, start + steps), written
    to ``<profile_dir>/trace_<first>-<last>.json``; off without a directory."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.dir = profile_dir
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.enabled = bool(profile_dir)
        self._prof = None
        self._first = None

    def step(self, step: int) -> None:
        """Call once per training step, after it, with the step's number."""
        if not self.enabled:
            return
        if self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._first = step + 1
        elif self._prof is not None and step >= self._first + self.num_steps - 1:
            self.close()
            self.enabled = False  # one window per run

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        last = self._first + self.num_steps - 1
        self._prof.export_chrome_trace(os.path.join(self.dir, f"trace_{self._first}-{last}.json"))
        self._prof = None


class Throughput:
    """Steps/s and images/s on the host clock between ``report`` calls; the
    caller has waited for the device before it reports."""

    def __init__(self, global_batch: int):
        self.global_batch = int(global_batch)
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self) -> None:
        self._steps += 1

    def report(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        steps_s = self._steps / dt
        self._t0 = time.perf_counter()
        self._steps = 0
        return {"steps_per_sec": steps_s, "images_per_sec": steps_s * self.global_batch}


class SpanTimer:
    """The time of one span of each step, in ms per step over the spans since
    the last ``read``: device time between CUDA events on the card (read
    after the device has passed them), host time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._spans = []

    @contextlib.contextmanager
    def span(self):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._spans.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append(time.perf_counter() - t0)

    def read(self) -> float:
        spans, self._spans = self._spans, []
        if not spans:
            return 0.0
        if self.cuda:
            spans[-1][1].synchronize()
            return sum(start.elapsed_time(end) for start, end in spans) / len(spans)
        return sum(spans) * 1e3 / len(spans)


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _profile(fn, calls: int, top: int) -> dict:
    """Profile ``calls`` calls of ``fn``, which has been warmed up."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name = defaultdict(float)
    for e in kernels:
        per_name[e.name] += e.time_range.end - e.time_range.start
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "ms_per_call": wall_us / calls / 1e3,
        "device_busy_ms_per_call": busy_us / calls / 1e3 if kernels else None,
        "device_idle_share": 1.0 - busy_us / wall_us if kernels else None,
        "kernels_per_call": len(kernels) / calls,
        "top_kernels_ms_per_call": {name: us / calls / 1e3 for name, us in ranked},
    }


def profile_calls(fn, calls: int = 5, top: int = 8) -> dict:
    """Profile ``calls`` calls of ``fn`` after one warm-up call: wall and device
    busy ms per call, the idle share, the device kernels per call and the
    ``top`` kernels' ms per call by name."""
    fn()
    return _profile(fn, calls, top)


def profile_denoiser(model, inputs, calls: int = 5, top: int = 8) -> dict:
    """Profile ``calls`` forwards of ``model(*inputs)`` after one warm-up."""
    with torch.no_grad():
        model(*inputs)
        return _profile(lambda: model(*inputs), calls, top)


def profile_train_step(name: str, batch: int, scan_impl: str, calls: int = 5,
                       warmup: int = 3, top: int = 10, use_mamba2: bool = False,
                       real_data: bool = False, dtype: torch.dtype = torch.float32) -> dict:
    """Profile ``calls`` of the trainer's steps on ``name`` at 224² and batch
    ``batch`` (lr 1e-4, synthetic batches drawn on the card, the loss's t and
    noise drawn after them), after ``warmup`` steps, eager (``eager``) and as
    the trainer's CUDA graph (``graphed``), each on its own copy of the
    model from one seed; then time both on the host clock in alternating
    blocks of 2 * ``calls`` steps (eager, graphed, graphed, eager). With
    ``real_data`` each step's batch is one fixed pair of random (batch, 1,
    224, 224) CT and MRI arrays encoded by the trainer's ``Conditioning``
    (random frozen weights), as a real-data step encodes its loader's
    arrays. ``dtype`` is the model's compute dtype."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train import Conditioning, loss_draws, make_loss_fn, synthetic_batch
    from diffma_tpu_torch.utils.config import Config

    latent = 28
    model = build_model(name, input_size=latent, scan_impl=scan_impl, use_mamba2=use_mamba2,
                        dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(0)).cuda().train()
    diffusion = create_diffusion("", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = (latent // model.patch_size) ** 2
    if real_data:
        cond = Conditioning(Config(image_size=8 * latent, model=name), logging.getLogger(__name__),
                            "cuda")
        rng = np.random.default_rng(0)
        ct, mri = (rng.uniform(-1, 1, (batch, 1, 8 * latent, 8 * latent)).astype(np.float32)
                   for _ in range(2))

    def draw_batch():
        if real_data:
            return cond.encode_triplets(ct, mri, gen)
        return synthetic_batch(gen, batch, latent, tokens)

    def trainer(model, graphed: bool):
        optimizer = adamw(model.parameters(), 1e-4)
        state = TrainState(model, optimizer)
        step = make_train_step(make_loss_fn(model, diffusion), optimizer)
        if graphed:
            step = GraphedTrainStep(step, "cuda")

        def one_step():
            b = draw_batch()
            b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
            step(state, b, gen)

        return one_step, step

    fns = {}
    fns["eager"], _ = trainer(model, False)
    fns["graphed"], graphed = trainer(copy.deepcopy(model), True)
    report = {}
    for mode, fn in fns.items():
        for _ in range(warmup):
            fn()
        report[mode] = _profile(fn, calls, top)
    report["capture_seconds"] = graphed.graph.capture_seconds
    report["pool_bytes"] = graphed.graph.pool_bytes
    ms = {mode: [] for mode in fns}
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2 * calls):
            fns[mode]()
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / (2 * calls))
    report["ms_per_step_eager"] = ms["eager"]
    report["ms_per_step_graphed"] = ms["graphed"]
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--scan-impl", dest="scan_impl", default="fused", choices=sorted(SCAN_IMPLS))
    parser.add_argument("--train", action="store_true", help="profile training steps")
    parser.add_argument("--model", default="DiffMa-B/2", help="registry name, e.g. ViM-B/2")
    parser.add_argument("--use-mamba2", dest="use_mamba2", action="store_true",
                        help="Mamba-2 mixers")
    parser.add_argument("--fuse-block", dest="fuse_block", action="store_true",
                        help="whole-block kernels, with --use-mamba2 and --scan-impl fused")
    parser.add_argument("--real-data", dest="real_data", action="store_true",
                        help="with --train: each batch encoded by the conditioning stack")
    parser.add_argument("--autocast", action="store_true", help="the model in bfloat16")
    args = parser.parse_args(argv)
    dtype = torch.bfloat16 if args.autocast else torch.float32
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        report = {"train_step": args.model, "batch": args.batch, "scan_impl": args.scan_impl,
                  "use_mamba2": args.use_mamba2, "real_data": args.real_data,
                  "autocast": args.autocast, "device": torch.cuda.get_device_name(0),
                  **profile_train_step(args.model, args.batch, args.scan_impl,
                                       use_mamba2=args.use_mamba2, real_data=args.real_data,
                                       dtype=dtype)}
        print(json.dumps(report, indent=1))
        return report

    name, latent = args.model, 28
    gen = torch.Generator().manual_seed(0)
    model = build_model(name, input_size=latent, scan_impl=args.scan_impl,
                        use_mamba2=args.use_mamba2, fuse_block=args.fuse_block, dtype=dtype)
    model = model.init_weights(gen).to(device).eval()
    tokens = (latent // model.patch_size) ** 2
    n = args.batch
    inputs = (
        torch.randn(n, 4, latent, latent, generator=gen).to(device),
        torch.full((n,), 500, device=device),
        torch.randn(n, 512, generator=gen).to(device),
        torch.randn(n, tokens, 512, generator=gen).to(device),
        torch.sigmoid(torch.randn(n, tokens, 1, generator=gen)).to(device),
    )
    report = {"model": name, "batch": n, "scan_impl": args.scan_impl,
              "use_mamba2": args.use_mamba2, "fuse_block": args.fuse_block,
              "autocast": args.autocast,
              "device": torch.cuda.get_device_name(0),
              **profile_denoiser(model, inputs)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
