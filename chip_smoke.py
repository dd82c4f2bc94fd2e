#!/usr/bin/env python3
"""Run the PyTorch port of DiffMa on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
needs neither JAX nor the JAX package, PyYAML or PIL. Phases:

1. build: compile every CUDA kernel of the sampling path from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the DiffMa-B/2 sampler gives it, with times and bounds;
3. forward: one full-width DiffMa-B/2 forward through the kernel and through
   the plain scan, with the same random weights;
4. sampler: ``diffma_tpu_torch.train.sample.main`` on ``configs/brain.yaml``
   with DiffMa-B/2, DDPM-250, 2 batches of 1 image, synthetic conditioning;
   the kernels' launch counts over this run must match the path.

The second line from the end is a JSON object with one entry per kernel, the
last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before those lines are printed.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# The kernel's stated tolerances against its plain version.
TOL_FP32 = 1e-4  # rtol = atol; fp32 sums in another order than the plain loop
TOL_BF16 = 2e-2  # rtol = atol, compared in fp32; the output is rounded to bf16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, each launch timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scan_inputs(G, L, d, n, dtype, delta_dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda")

    return dict(
        u=r(G, L, d).to(dtype),
        delta=(0.5 * r(G, L, d) - 1.0).to(delta_dtype),
        A=-torch.exp(0.5 * r(d, n)),
        B=r(G, L, n).to(dtype),
        C=r(G, L, n).to(dtype),
        D=r(d),
        z=r(G, L, d).to(dtype),
    )


def scan_bound_ms(x) -> tuple[float, str]:
    """Least time for one scan on an H100: bytes (each input read once, the
    output written once) over the HBM rate, or operations over the fp32 rate
    (per state and step: exp, dt*A, 2 for the state update, 2 for C.h)."""
    G, L, d = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x.values() if t is not None)
    nbytes += x["u"].numel() * x["u"].element_size()  # out
    ops = G * L * d * (6 * n + 8)  # + softplus, D skip, gate per channel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from diffma_tpu_torch.ops import cuda_build

    print("== phase 1: build", flush=True)
    res = cuda_build.build("selective_scan_fwd")
    print(f"built {os.path.relpath(res.path, ROOT)} in {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    cuda_build.load("selective_scan_fwd")


def phase_kernels(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_cuda, selective_scan_ref

    print("== phase 2: kernel against its plain version on the card", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, G, L, dtype, delta dtype, gated, tolerance
        ("fp32 gated (path)", 3, 196, f32, f32, True, TOL_FP32),
        ("fp32 ungated", 3, 196, f32, f32, False, TOL_FP32),
        ("fp32 gated, prime L=197", 3, 197, f32, f32, True, TOL_FP32),
        ("bf16 gated, fp32 delta", 3, 196, bf16, f32, True, TOL_BF16),
        ("bf16 gated, bf16 delta", 3, 196, bf16, bf16, True, TOL_BF16),
        ("bf16 ungated, prime L=13", 3, 13, bf16, bf16, False, TOL_BF16),
    ]
    path_err = None
    for i, (name, G, L, dtype, ddtype, gated, tol) in enumerate(cases):
        x = scan_inputs(G, L, 1024, 16, dtype, ddtype, seed=i)
        if not gated:
            x["z"] = None
        got = selective_scan_cuda(**x)
        want = selective_scan_ref(**x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        print(f"  {name}: G={G} L={L} d=1024 n=16  max|err| {err:.3e}  "
              f"(rtol=atol={tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with its plain version: {name}")
        if path_err is None:
            path_err = err

    x = scan_inputs(3, 196, 1024, 16, f32, f32, seed=0)
    ms = cuda_ms(lambda: selective_scan_cuda(**x), reps=50)
    plain_ms = cuda_ms(lambda: selective_scan_ref(**x), reps=5)
    bound_ms, bound_by = scan_bound_ms(x)
    print(f"  [{card}] selective_scan_fwd fp32 G=3 L=196 d=1024 n=16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the selective scan")
    return {
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "diffma_tpu/ops/selective_scan.py:229",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_forward(card: str) -> None:
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    print("== phase 3: full-width DiffMa-B/2 forward, kernel against plain scan", flush=True)
    model = build_model("DiffMa-B/2", input_size=28)
    gen = torch.Generator().manual_seed(0)
    model.init_weights(gen)
    with torch.no_grad():
        for p in model.parameters():  # every parameter random, adaLN included
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = model.cuda().eval()
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()

    def run(impl):
        for blk in model.blocks:
            blk.mamba1.scan_impl = blk.mamba2.scan_impl = impl
        with torch.no_grad():
            return model(x, t, y, y2, w)

    want = run("ref")
    got = run("kernel")
    ms = cuda_ms(lambda: run("kernel"), reps=10)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # fp32 through 8 blocks, 16 scans
    print(f"  out {tuple(got.shape)}  max|ref| {scale:.3f}  max|kernel - plain| {err:.3e}  "
          f"(tol {tol:.1e})")
    print(f"  [{card}] one denoiser forward at batch 1 (kernel path): {ms:.3f} ms")
    if tuple(got.shape) != (1, 8, 28, 28) or not torch.isfinite(got).all() or err > tol:
        fail("DiffMa-B/2 forward through the kernel disagrees with the plain scan")


def phase_sampler(card: str) -> int:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_cuda
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.utils.config import load_config, merge

    print("== phase 4: DDPM-250 sampler, DiffMa-B/2, 2 batches of 1", flush=True)
    cfg = merge(load_config(os.path.join(ROOT, "configs", "brain.yaml")), {
        "model": "DiffMa-B/2",
        "synthetic_data": True,
        "sample_global_batch_size": 1,
        "sample_num_steps": 250,
        "sample_num_batches": 2,
        "save_dir": os.path.join(ROOT, "result_sample", "chip_smoke"),
    })
    selective_scan_cuda.launches = 0
    results = sample.main(cfg, device="cuda")
    launches = selective_scan_cuda.launches
    expected = 2 * 8 * 250 * 2  # mixers x blocks x steps x batches
    for i, r in enumerate(results, start=1):
        img = r["images"]
        print(f"  batch {i}: images {img.shape}, {r['seconds']:.3f} s, "
              f"PSNR {r['quality']['psnr_db']:.2f} dB (random weights)")
        if img.shape != (1, 3, 224, 224) or not math.isfinite(float(abs(img).max())):
            fail(f"batch {i}: expected finite (1, 3, 224, 224) images, got {img.shape}")
    if len(results) != 2:
        fail(f"expected 2 batches, got {len(results)}")
    seconds = [r["seconds"] for r in results]
    print(f"  [{card}] seconds per batch {seconds[0]:.3f} (first), {seconds[1]:.3f} (second); "
          f"images/s {2 / sum(seconds):.4f} over both, {1 / seconds[1]:.4f} steady")
    print(f"  selective_scan_fwd launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"the sampler launched the selective-scan kernel {launches} times, not {expected}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "diffma_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {card}", flush=True)

    t0 = time.perf_counter()
    phase_build()
    kernel = phase_kernels(card)
    phase_forward(card)
    kernel["launches"] = phase_sampler(card)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
