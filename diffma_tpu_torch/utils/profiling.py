"""Where a denoiser call spends its time on the card.

Counterpart of ``diffma_tpu/utils/profiling.py`` (which drives
``jax.profiler``). ``profile_denoiser`` runs a few DiffMa forwards under
``torch.profiler`` and reports the host-clock time per call, the device's
busy time (the union of kernel intervals), its idle share, the kernels
launched per call, and the kernels that take the most device time.

    python -m diffma_tpu_torch.utils.profiling --batch 1 --scan-impl fused

profiles DiffMa-B/2 at 224² (the sampler's model) on the card, with random
weights and conditioning, 5 calls after one warm-up. ``--scan-impl`` picks the
mixers' path: ``fused`` (kernel C, the sampler's default on the card) or
``pallas`` (the composable path with kernel A).
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.mamba import SCAN_IMPLS
from diffma_tpu_torch.utils.device import resolve_device

__all__ = ["profile_denoiser"]


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


def profile_denoiser(model, inputs, calls: int = 5, top: int = 8) -> dict:
    """Profile ``calls`` forwards of ``model(*inputs)`` after one warm-up."""
    with torch.no_grad():
        model(*inputs)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                model(*inputs)
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--scan-impl", dest="scan_impl", default="fused", choices=sorted(SCAN_IMPLS))
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, latent = "DiffMa-B/2", 28
    gen = torch.Generator().manual_seed(0)
    model = build_model(name, input_size=latent, scan_impl=args.scan_impl)
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
              "device": torch.cuda.get_device_name(0),
              **profile_denoiser(model, inputs)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
