"""Where a denoiser call and a training step spend their time.

Counterpart of ``diffma_tpu/utils/profiling.py`` (which drives
``jax.profiler``). ``Throughput`` reports training steps/s and images/s
between log points; ``StepProfiler`` records a ``torch.profiler`` trace over
a window of training steps (the trainer's ``profile_dir``,
``profile_start_step`` and ``profile_steps`` keys) and writes it as a Chrome
trace. ``profile_denoiser`` runs a few DiffMa forwards, and
``profile_train_step`` a few of the trainer's steps, under ``torch.profiler``;
each reports the host-clock time per call, the device's busy time (the union
of kernel intervals), its idle share, the kernels launched per call, and the
kernels that take the most device time.

    python -m diffma_tpu_torch.utils.profiling --batch 1 --scan-impl fused
    python -m diffma_tpu_torch.utils.profiling --train --model DiffMa-L/2 --batch 8

profile, on the card with random weights and conditioning, 5 denoiser
forwards of DiffMa-B/2 at 224² (the sampler's model) after one warm-up, or 5
training steps (hybrid loss, backward, AdamW, EMA, the per-step loss check)
after 3 warm-up steps. ``--scan-impl`` picks the mixers' path: ``fused``
(kernels C and D, the default on the card) or ``pallas`` (the composable
path with kernels A and B). ``--use-mamba2`` takes the Mamba-2 mixers
(``fused`` is then kernel E, and kernel F in a training step), and with it
the denoiser profile takes ``--fuse-block`` (kernels E and G).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.mamba import SCAN_IMPLS
from diffma_tpu_torch.utils.device import resolve_device

__all__ = ["StepProfiler", "Throughput", "profile_calls", "profile_denoiser",
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
                       warmup: int = 3, top: int = 10, use_mamba2: bool = False) -> dict:
    """Profile ``calls`` of the trainer's steps on ``name`` at 224² and batch
    ``batch`` (lr 1e-4, synthetic batches drawn on the card), after
    ``warmup`` steps; then time the step with and without its host-side loss
    check (the NaN skip's wait for the device)."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.train.state import TrainState, make_train_step, update_ema
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    latent = 28
    model = build_model(name, input_size=latent, scan_impl=scan_impl, use_mamba2=use_mamba2)
    model = model.init_weights(torch.Generator().manual_seed(0)).cuda().train()
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.0)
    state = TrainState(model, optimizer)
    loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
    step = make_train_step(loss_fn, optimizer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = (latent // model.patch_size) ** 2

    def one_step():
        step(state, synthetic_batch(gen, batch, latent, tokens), gen)

    def unchecked_step():  # the same work without the host's loss check
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(synthetic_batch(gen, batch, latent, tokens), gen)
        loss.backward()
        optimizer.step()
        update_ema(state.ema, state.model)

    for _ in range(warmup):
        one_step()
    report = _profile(one_step, calls, top)
    # The check's cost: host-clock ms per step with and without it, in
    # alternating blocks of 2 * calls steps (with, without, without, with).
    ms = {True: [], False: []}
    for checked in (True, False, False, True):
        fn = one_step if checked else unchecked_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2 * calls):
            fn()
        torch.cuda.synchronize()
        ms[checked].append((time.perf_counter() - t0) * 1e3 / (2 * calls))
    report["ms_per_step_with_loss_check"] = ms[True]
    report["ms_per_step_without_loss_check"] = ms[False]
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
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        report = {"train_step": args.model, "batch": args.batch, "scan_impl": args.scan_impl,
                  "use_mamba2": args.use_mamba2, "device": torch.cuda.get_device_name(0),
                  **profile_train_step(args.model, args.batch, args.scan_impl,
                                       use_mamba2=args.use_mamba2)}
        print(json.dumps(report, indent=1))
        return report

    name, latent = args.model, 28
    gen = torch.Generator().manual_seed(0)
    model = build_model(name, input_size=latent, scan_impl=args.scan_impl,
                        use_mamba2=args.use_mamba2, fuse_block=args.fuse_block)
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
              "device": torch.cuda.get_device_name(0),
              **profile_denoiser(model, inputs)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
