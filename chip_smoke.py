#!/usr/bin/env python3
"""Run the PyTorch port of DiffMa on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
needs neither JAX nor the JAX package, PyYAML or PIL. Phases:

1. build: compile every CUDA kernel of the sampling and training paths from
   ``csrc/``, one nvcc process per source, all at once;
2. kernels: kernel A (the selective scan) and kernel C (the fused Mamba-1
   mixer) each against its plain PyTorch version on the card, at the shapes
   the DiffMa-B/2 sampler gives them (2a, 2b), and their backward kernels B
   and D against theirs at the training shapes, batch 8 (2c, 2d), with times
   and bounds; kernel E (the fused Mamba-2 mixer: single, dual and prologue
   modes, 196 and 25 tokens, a finite dt_limit, a wide decay span) and
   kernel G (the Spiral block's tail) against theirs, and the Mamba-2 block
   on its three routes (2e, 2f); kernel F (the fused Mamba-2 mixer's
   backward) against its plain version at the training shapes, batch 8:
   single and dual, 196 and 25 tokens, a dt_limit that clips some steps, a
   wide decay span, twice in a row; and kernel E's residual mode against its
   plain mode, bit for bit (2g); kernel H (the Mamba-1 mixer's inner part)
   against its plain version, values and gradients, at the shapes of the
   DiffMa-B/2 streams at batch 1 and 8, ragged lengths and dt_bias near -2
   and +2 (2h); kernel C's one-mixer form on the vim quirk, on
   EfficientVMamba's partition, on one stream (zig) and four (vmamba) (2i);
   kernel E on the partition (2j);
3. forward: one full-width DiffMa-B/2 forward through the plain scan,
   through kernel A (``scan_impl="pallas"``) and through kernel C
   (``scan_impl="fused"``), with the same random weights; 3b: one
   full-width DiffMa-B/2 training step (loss and every parameter's gradient)
   through the plain path, through kernels A + B and through kernels C + D;
   3c: the Mamba-2 DiffMa-B/2 forward on its three routes (composable, dual
   kernel E, ``fuse_block``: kernel E in prologue mode + kernel G), with
   the device kernels per forward and the idle share of each; 3d: one
   full-width Mamba-2 DiffMa-B/2 training step on the same three routes
   (torch autograd; kernels E + F; ``fuse_block``: kernels E + G forward,
   the recomputing backward through E + F); 3e: ``Mamba`` on a hand-made
   scan spec that kernel C cannot run (the four atrous streams and their
   reverses), which takes kernel H: against the plain route at batch 1 and
   8, then 2000 forwards at batch 1 (a DDPM-250 chain's worth for 8 blocks),
   2000 kernel H calls and no kernel C call; 3f: one full-width forward of
   ZigMa-, ViM-, VMamba-, EMamba- and DiT-B/2, on Mamba-1 and (not DiT) on
   Mamba-2, fused route against the plain one, 8 kernel C or E calls each
   (none for DiT), with the device kernels per forward and the idle share;
4. composable sampler: ``diffma_tpu_torch.train.sample.main`` on
   ``configs/brain.yaml`` with DiffMa-B/2, ``scan_impl="pallas"``, DDPM-250,
   1 batch of 1 image, synthetic conditioning;
5. fused sampler: the same with ``scan_impl`` left to its default, 2 batches;
6. checkpoint: a reference-format checkpoint of seeded DiffMa-L/2 weights,
   sampled by the sampler's CLI on ``configs/brain.yaml`` as it is, 1 batch;
7. trainer: the trainer's CLI on ``configs/brain.yaml`` as it is (DiffMa-L/2,
   batch 8, synthetic batches), 20 steps on the default (fused) path, with a
   checkpoint at step 20 that the sampler's loader reads back;
8. composable trainer: DiffMa-B/2, batch 8, 5 steps through kernels A + B;
9. learning: DiffMa-B/2 on the fused path trained 100 steps on one fixed
   batch; the loss's MSE term at a fixed (t, noise) must fall at least 2x;
10. Mamba-2 sampler: the sampler's CLI on ``configs/brain.yaml`` with
    ``--model DiffMa-B/2 --use-mamba2`` and a reference-format checkpoint of
    seeded weights, DDPM-250, 2 batches of 1 on the default (fused) route:
    2000 kernel E calls per image;
11. block-fused Mamba-2 sampler: the same checkpoint loaded into a model
    built with ``fuse_block=True`` and handed to the sampler's loop, same
    seed, 1 batch: 2000 kernel E and 2000 kernel G calls, and an image that
    agrees with phase 10's first;
12. Mamba-2 trainer: the trainer's CLI on ``configs/brain.yaml
    --use-mamba2`` (DiffMa-L/2, batch 8, synthetic batches), 20 steps on the
    default (fused) path: 320 kernel E and 320 kernel F calls; its
    checkpoint at step 20 sampled back by the sampler's CLI with
    ``--use-mamba2`` (DDPM-250, 1 image, 4000 kernel E calls);
13. Mamba-2 learning: DiffMa-B/2 with ``use_mamba2`` on the fused path
    trained 100 steps on one fixed batch; the MSE term must fall at least 2x;
14. family samplers: the sampler's CLI on ``configs/brain.yaml`` with
    ``--model`` and a reference-format checkpoint of seeded weights, DDPM-250,
    1 image each: ViM-B/2 and EMamba-B/2 (2000 kernel C calls each),
    VMamba-BL/2 (depth 13: 3250), EMamba-B/2 and ZigMa-B/2 with
    ``--use-mamba2`` (2000 kernel E calls each), DiT-SB/2 (no kernel call);
15. family trainers: VMamba-B/2, batch 8, 5 steps on the fused path (40
    kernel C and 40 kernel D calls); ViM-B/2 with ``scan_impl: auto``, 5
    steps (40 kernel A and 40 kernel B calls); and ViM-B/2 on the fused path,
    which must raise and name kernel D's missing branch.

Each sampler and trainer phase sets the kernels' counts to 0 just before it
and checks them just after: every kernel of the path ran, as often as the
path says.

The third line from the end is a JSON object with one entry per kernel, the
second the card's name and power limit, the last ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before those lines are printed.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
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
# Gradients, per tensor: max |err| <= TOL_GRAD * max(1, max |ref|), the JAX
# package's gradient bar (tests/test_selective_scan.py). A whole model's
# gradients through 8 blocks: TOL_MODEL, the forward phase's bar.
TOL_GRAD = 2e-4
TOL_MODEL = 1e-3
# Two routes of one model through a whole DDPM-250 chain and the VAE decoder,
# same seed and weights: max |diff| <= TOL_IMAGE * max(1, max |image|). Each
# forward agrees to fp32 rounding (TOL_MODEL holds it); 250 steps feed the
# differences back in.
TOL_IMAGE = 1e-3


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


def cuda_ms(fn, reps: int, windows: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``windows``
    windows of the mean over back-to-back calls, with CUDA events around each
    window, so that the host's time between calls is hidden where the device
    is the slower."""
    import torch

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
    for name, res in cuda_build.build_all().items():
        print(f"built {os.path.relpath(res.path, ROOT)} in {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
        cuda_build.load(name)


def phase_kernels(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_cuda, selective_scan_ref

    print("== phase 2a: kernel A against its plain version on the card", flush=True)
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


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.fused_mixer import mixer_fused_bwd_cuda, mixer_fused_cuda
    from diffma_tpu_torch.ops.fused_ssd import (
        spiral_epilogue_cuda,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_cuda, selective_scan_cuda

    return {"selective_scan_fwd": selective_scan_cuda, "mixer_fused_fwd": mixer_fused_cuda,
            "selective_scan_bwd": selective_scan_bwd_cuda, "mixer_fused_bwd": mixer_fused_bwd_cuda,
            "ssd_mixer_fwd": ssd_mixer_fused_cuda, "spiral_epilogue": spiral_epilogue_cuda,
            "ssd_mixer_bwd": ssd_mixer_fused_bwd_cuda, "mamba_inner_fwd": mamba_inner_fused_cuda}


def reset_counts() -> None:
    for counter in kernel_counters().values():
        counter.launches = 0


def check_counts(what: str, expect: dict) -> dict:
    counts = {name: counter.launches for name, counter in kernel_counters().items()}
    print("  launches: " + ", ".join(f"{k} {v} (expected {expect[k]})" for k, v in counts.items()))
    for name, n in counts.items():
        if n != expect[name]:
            fail(f"{what} ran {name} {n} times, not {expect[name]}")
    return counts


def grad_errors(got, want, tol: float):
    """(name, max |err|, bar) of each pair of gradients, the bar being
    tol * max(1, max |ref|); fails on a shape, a non-finite value or an error
    over its bar."""
    if set(got) != set(want):
        fail(f"gradients of {sorted(set(got) ^ set(want))} are missing on one side")
    rows = []
    for name, b in want.items():
        a = got[name]
        bar = tol * max(1.0, b.abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        if a.shape != b.shape or not bool(a.isfinite().all()) or err > bar:
            fail(f"gradient {name}: max |err| {err:.3e} over its bar {bar:.3e}, or bad values")
        rows.append((name, err, bar))
    return rows


def scan_bwd_bound_ms(x, g) -> tuple[float, str]:
    """Least time for one scan backward on an H100: its inputs (kernel A's and
    g) read once and its outputs (du, ddelta, dz, dB, dC, dA, dD) written
    once over the HBM rate, or its operations over the fp32 rate: the forward
    once (6n + 8 per channel and step, as kernel A's bound) and the adjoint
    (17 per state and step: the adjoint state, its decay, dA, ddelta, du, dB,
    dC; 12 per channel and step for the gate, the softplus and the D skip)."""
    G, L, d = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x.values() if t is not None)
    nbytes += g.numel() * g.element_size()
    nbytes += 4 * (G * L * d * (3 if x["z"] is not None else 2) + 2 * G * L * n + d * n + d)
    ops = G * L * d * ((6 * n + 8) + (17 * n + 12))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_scan_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_cuda, selective_scan_bwd_ref

    print("== phase 2c: kernel B (scan backward) against its plain version on the card",
          flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz")
    cases = [
        # name, G, L, dtype, delta dtype, gated: G = 24 is batch 8 x 3 streams
        ("fp32 gated (path)", 24, 196, f32, f32, True),
        ("fp32 ungated", 24, 196, f32, f32, False),
        ("fp32 gated, prime L=197", 24, 197, f32, f32, True),
        ("bf16 gated, fp32 delta", 24, 196, bf16, f32, True),
    ]
    path_err = None
    for i, (name, G, L, dtype, ddtype, gated) in enumerate(cases):
        x = scan_inputs(G, L, 1024, 16, dtype, ddtype, seed=10 + i)
        if not gated:
            x["z"] = None
        g = torch.randn(G, L, 1024, generator=torch.Generator(device="cuda").manual_seed(i),
                        device="cuda").to(dtype)
        got = dict(zip(names, selective_scan_bwd_cuda(**x, g=g)))
        want = dict(zip(names, selective_scan_bwd_ref(**x, g=g)))
        torch.cuda.synchronize()
        if not gated:
            if got.pop("dz") is not None or want.pop("dz") is not None:
                fail("an ungated scan's backward gave a dz")
        rows = grad_errors(got, want, TOL_GRAD)
        err = max(e for _, e, _ in rows)
        print(f"  {name}: G={G} L={L} d=1024 n=16  max|err| per gradient "
              + ", ".join(f"{n} {e:.2e}/{b:.1e}" for n, e, b in rows))
        if path_err is None:
            path_err = err

    x = scan_inputs(24, 196, 1024, 16, f32, f32, seed=10)
    g = torch.randn(24, 196, 1024, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    ms = cuda_ms(lambda: selective_scan_bwd_cuda(**x, g=g), reps=20)
    plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(**x, g=g), reps=5)
    bound_ms, bound_by = scan_bwd_bound_ms(x, g)
    print(f"  [{card}] selective_scan_bwd fp32 G=24 L=196 d=1024 n=16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the scan's backward")
    return {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "diffma_tpu/ops/selective_scan.py:323",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def random_(module, seed: int, scale: float = 0.1):
    """Every parameter moved by seeded noise, A_log, D and the biases too: std
    ``scale`` for vectors, ``scale / sqrt(fan-in)`` for the others, so that
    activations stay of order 1."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = scale if p.dim() == 1 else scale / math.sqrt(p.shape[-1])
            p.add_(std * torch.randn(p.shape, generator=gen))
    return module


def mixer_bound_ms(M, B, L, h, d, n, r, S, K, Ls=None, quirk=False) -> tuple[float, str]:
    """Least time for one fused-mixer call of M branches on an H100: the
    weights, x, out and index tables moved once over the HBM rate, or the
    operations (in_proj, conv, x_proj, dt_proj, scan, out_proj) over fp32.
    ``Ls`` is the steps per stream (L unless the streams partition the
    tokens); the vim quirk runs out_proj once per stream."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    ops = M * (
        2 * tokens * h * 2 * d  # in_proj
        + rows * d * 2 * K  # conv
        + 2 * rows * d * (r + 2 * n)  # x_proj
        + 2 * rows * r * d  # dt_proj
        + rows * d * (6 * n + 8)  # scan, D skip, gate
        + 2 * tokens * d * h * (S if quirk else 1)  # out_proj
    )
    weights = 2 * d * h + d * K + d + (r + 2 * n) * d + d * r + d + d * n + d + h * d
    nbytes = M * 4 * (weights + 2 * tokens * h) + 2 * S * Ls * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_fused_mixer(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import (
        mamba_dual_mixer_fused,
        mamba_mixer_fused,
        mixer_ref,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2b: kernel C (fused mixer) against its plain version on the card",
          flush=True)
    h = 512  # DiffMa's width: d_inner 1024, d_state 16, dt_rank 32
    path_err = None
    for grid_n, layer in ((14, 0), (14, 3), (5, 0)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        m0, m1 = (random_(Mamba(h, spec), 10 * layer + i).cuda() for i in range(2))
        gen = torch.Generator().manual_seed(layer)
        x0, x1 = (torch.randn(1, L, h, generator=gen).cuda() for _ in range(2))
        with torch.no_grad():
            cases = {
                "dual": (mamba_dual_mixer_fused(spec, x0, x1, m0.weights(), m1.weights()),
                         (mixer_ref(spec, x0, m0.weights()), mixer_ref(spec, x1, m1.weights()))),
                "single": ((mamba_mixer_fused(spec, x1, m1.weights()),),
                           (mixer_ref(spec, x1, m1.weights()),)),
            }
        torch.cuda.synchronize()
        for entry, (got, want) in cases.items():
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            tol = TOL_FP32 * max(1.0, max(w.abs().max().item() for w in want))
            print(f"  {entry}, spiral layer {layer}: B=1 L={L} h={h} d=1024 n=16 r=32  "
                  f"max|err| {err:.3e}  (tol {tol:.1e})")
            if not all(g.shape == w.shape and torch.isfinite(g).all() for g, w in zip(got, want)):
                fail(f"fused mixer gave a wrong shape or a non-finite value: {entry}, L={L}")
            if err > tol:
                fail(f"fused mixer disagrees with its plain version: {entry}, layer {layer}, L={L}")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    m0, m1 = (random_(Mamba(h, spec), 100 + i).cuda().eval() for i in range(2))
    gen = torch.Generator().manual_seed(100)
    x0, x1 = (torch.randn(1, 196, h, generator=gen).cuda() for _ in range(2))
    w0, w1 = m0.weights(), m1.weights()
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba_dual_mixer_fused(spec, x0, x1, w0, w1), reps=50)
        plain_ms = cuda_ms(lambda: (mixer_ref(spec, x0, w0), mixer_ref(spec, x1, w1)), reps=5)
        m0.scan_impl = m1.scan_impl = "pallas"
        pair_ms = cuda_ms(lambda: (m0(x0), m1(x1)), reps=50)
    bound_ms, bound_by = mixer_bound_ms(M=2, B=1, L=196, h=h, d=1024, n=16, r=32, S=3, K=4)
    print(f"  [{card}] mixer_fused_fwd fp32, both branches, B=1 L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the whole mixer")
    print(f"  [{card}] yardstick: the composable pair (two Mamba.forward through kernel A, "
          f"same weights) {pair_ms:.4f} ms")
    return {
        "name": "mixer_fused_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mixer_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_mixer.py:104",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def mixer_bwd_bound_ms(M, B, L, h, d, n, r, S, K) -> tuple[float, str]:
    """Least time for one fused-mixer backward of M branches on an H100: the
    weights, x and g read once, gx and the weight gradients written once,
    over the HBM rate; or the operations over the fp32 rate: the forward as
    far as the backward needs it, once (in_proj, conv, x_proj, dt_proj, the
    scan; not out_proj), and the backward, two products per projection (the
    input's and the weight's gradient), the conv's two adjoints, and the
    scan's adjoint (17 per state and step, 12 per channel and step)."""
    tokens, rows = B * L, B * S * L
    r2n = r + 2 * n
    fwd_ops = M * (
        2 * tokens * h * 2 * d + rows * d * 2 * K + 2 * rows * d * r2n + 2 * rows * r * d
        + rows * d * (6 * n + 8)
    )
    bwd_ops = M * (
        2 * 2 * tokens * d * h  # g W_out, dW_out
        + rows * d * (17 * n + 12)  # the scan's adjoint
        + 2 * 2 * rows * r * d  # d dt_r, dW_dt
        + 2 * 2 * rows * r2n * d  # dpre's product, dW_x
        + 2 * 2 * rows * d * K  # the conv's input and weight adjoints
        + 2 * 2 * tokens * 2 * d * h  # gx, dW_in
    )
    weights = 2 * d * h + d * K + d + r2n * d + d * r + d + d * n + d + h * d
    nbytes = M * 4 * (2 * weights + 3 * tokens * h) + 2 * S * L * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, (fwd_ops + bwd_ops) / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_mixer_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import MixerWeights, mixer_bwd_ref, mixer_fused_bwd_cuda
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2d: kernel D (fused mixer backward) against its plain version on the card",
          flush=True)
    h, batch = 512, 8

    def grads_of(gx, gw, m):
        return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(MixerWeights._fields, gw)}}

    path_err = None
    for grid_n, layer in ((14, 0), (14, 3), (5, 0)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        mixers = [random_(Mamba(h, spec), 20 * layer + i).cuda() for i in range(2)]
        ws = [m.weights() for m in mixers]
        gen = torch.Generator().manual_seed(50 + layer)
        xs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        gs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        want = {}
        for m in range(2):
            want.update(grads_of(*mixer_bwd_ref(spec, xs[m], gs[m], ws[m]), m))
        for entry, M in (("dual", 2), ("single", 1)):
            gxs, gws = mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M])
            torch.cuda.synchronize()
            got = {}
            for m in range(M):
                got.update(grads_of(gxs[m], gws[m], m))
            rows = grad_errors(got, {k: want[k] for k in got}, TOL_GRAD)
            err = max(e for _, e, _ in rows)
            worst = max(rows, key=lambda row: row[1] / row[2])
            print(f"  {entry}, spiral layer {layer}: B={batch} L={L} h={h} d=1024 n=16 r=32  "
                  f"max|err| {err:.3e} over {len(rows)} gradients; nearest its bar: "
                  f"{worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e})")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    mixers = [random_(Mamba(h, spec), 200 + i).cuda() for i in range(2)]
    ws = [m.weights() for m in mixers]
    gen = torch.Generator().manual_seed(200)
    xs = [torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(2)]
    gs = [torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(2)]
    ms = cuda_ms(lambda: mixer_fused_bwd_cuda(spec, xs, gs, ws), reps=10)
    plain_ms = cuda_ms(lambda: [mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(xs, gs, ws)],
                       reps=5)
    for m in mixers:
        m.scan_impl = "pallas"
    leaves = [x.clone().requires_grad_() for x in xs]
    outs = [m(x) for m, x in zip(mixers, leaves)]
    inputs = leaves + [p for m in mixers for p in m.parameters()]
    pair_ms = cuda_ms(lambda: torch.autograd.grad(outs, inputs, gs, retain_graph=True), reps=10)
    bound_ms, bound_by = mixer_bwd_bound_ms(M=2, B=batch, L=196, h=h, d=1024, n=16, r=32, S=3,
                                            K=4)
    print(f"  [{card}] mixer_fused_bwd fp32, both branches, B={batch} L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the whole mixer's backward")
    print(f"  [{card}] yardstick: the composable pair's backward (autograd through kernels "
          f"A and B, same weights) {pair_ms:.4f} ms")
    return {
        "name": "mixer_fused_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mixer_bwd.cu",
        "replaces": "diffma_tpu/ops/fused_mixer.py:565",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def close_to_ref(what: str, got, want, tol: float = TOL_FP32) -> float:
    """max |got - want|, held to ``tol * max(1, max |want|)``; fails on a
    shape, a non-finite value or an error over the bar."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: wrong shape {tuple(got.shape)} or a non-finite value")
    err = (got - want).abs().max().item()
    bar = tol * max(1.0, want.abs().max().item())
    if err > bar:
        fail(f"{what}: max |err| {err:.3e} over its bar {bar:.1e}")
    return err


def ssd_mixer_bound_ms(M, B, L, h, d, n, H, S, K, prologue=False, Ls=None) -> tuple[float, str]:
    """Least time for one fused-SSD-mixer call of M branches on an H100: the
    weights, x, out and the index table moved once over the HBM rate, or the
    operations over fp32: in_proj, the conv, per stream C . B^T on the causal
    pairs (once, it is the same for every head) and per head and causal pair
    the decay (exp, two products) and the 2 * headdim of the product with
    dt * x, then gate, norm and merge (about 8 per channel and stream row),
    out_proj, and in prologue mode LayerNorm and modulation (about 10 per
    input element). ``Ls`` is the steps per stream (L unless the streams
    partition the tokens)."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    pairs = B * S * Ls * (Ls + 1) // 2
    ops = M * (
        2 * tokens * h * dproj  # in_proj
        + rows * conv_dim * 2 * K  # conv
        + pairs * 2 * n  # C . B^T
        + pairs * H * (3 + 2 * hd)  # decay and the product with dt * x
        + rows * d * 8  # D skip, gate, norm, merge
        + 2 * tokens * d * h  # out_proj
    ) + (10 * tokens * h if prologue else 0)
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    x_bytes = (tokens * h + tokens + 2 * h + 2 * B * h) if prologue else M * tokens * h
    nbytes = 4 * (M * weights + x_bytes + M * tokens * h) + S * L * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def epilogue_bound_ms(B, L, h) -> tuple[float, str]:
    """Least time for one call of the Spiral block's tail on an H100: o0, o1,
    x and the weights read and out written once over the HBM rate, or the
    operations over fp32: the 2h -> h product, about 8 per concat element for
    the LayerNorm, and about 12 per output element for the SiLU, the h -> 1
    product, the mix and the residual."""
    rows = B * L
    ops = 2 * rows * 2 * h * h + rows * 2 * h * 8 + rows * h * 12
    nbytes = 4 * (4 * rows * h + B * h + 2 * h * h + 4 * h + h + h + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def mamba2_mixers(spec, seed: int, wide: bool = False):
    """Two Mamba-2 mixers at DiffMa's width on the card, every parameter off
    its init. ``wide``: decay rates from 1 to 16 and dt above 1, so that each
    head's span of dt * A over the sequence is in the hundreds or thousands,
    far beyond what exp can hold."""
    import torch

    from diffma_tpu_torch.models.mamba2 import Mamba2

    mixers = [random_(Mamba2(512, spec), seed + i) for i in range(2)]
    if wide:
        with torch.no_grad():
            for m in mixers:
                m.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, m.A_log.numel())))
                m.dt_bias.fill_(1.0)
    return [m.cuda().eval() for m in mixers]


def block_inputs(L: int, seed: int, batch: int, h: int = 512):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, L, h, generator=gen).cuda()
    c = torch.randn(batch, 2 * h, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(batch, L, 1, generator=gen)).cuda()
    return x, c, w


def phase_fused_ssd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.layers import modulate
    from diffma_tpu_torch.ops.fused_ssd import (
        Prologue,
        mamba2_dual_mixer_fused,
        mamba2_mixer_fused,
        ssd_mixer_fused_cuda,
        ssd_mixer_ref,
    )
    from diffma_tpu_torch.ops.norm import layer_norm
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2e: kernel E (fused Mamba-2 mixer) against its plain version on the card",
          flush=True)
    h = 512  # DiffMa's width: d_inner 1024, d_state 16, 16 heads of 64
    no_limit = (0.0, float("inf"))
    path_err = None
    cases = [
        # grid, layer, batch, dt_limit, wide span
        (14, 0, 1, no_limit, False), (14, 3, 8, no_limit, False), (5, 0, 2, no_limit, False),
        (14, 1, 1, (0.01, 0.05), False), (14, 2, 1, no_limit, True),
    ]
    for grid_n, layer, batch, dt_limit, wide in cases:
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        m0, m1 = mamba2_mixers(spec, 10 * layer, wide)
        w0, w1 = m0.weights(), m1.weights()
        x0, c, wmask = block_inputs(L, layer, batch)
        x1 = x0 * wmask
        gen = torch.Generator(device="cuda").manual_seed(layer)
        ln_w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        ln_b = 0.1 * torch.randn(h, generator=gen, device="cuda")
        shift, scale = (0.3 * c).chunk(2, dim=-1)  # rows a stride apart, as adaLN's chunks
        with torch.no_grad():
            want = [ssd_mixer_ref(spec, x, w, dt_limit) for x, w in ((x0, w0), (x1, w1))]
            xm = modulate(layer_norm(x0, ln_w, ln_b, eps=1e-5), shift, scale)
            want_pro = [ssd_mixer_ref(spec, xm, w0, dt_limit),
                        ssd_mixer_ref(spec, xm * wmask, w1, dt_limit)]
            got = {
                "dual": (mamba2_dual_mixer_fused(spec, x0, x1, w0, w1, dt_limit), want),
                "single": ((mamba2_mixer_fused(spec, x1, w1, dt_limit),), want[1:]),
                "prologue": (ssd_mixer_fused_cuda(
                    spec, (x0,), (w0, w1), dt_limit,
                    prologue=Prologue(wmask, ln_w, ln_b, shift, scale)), want_pro),
            }
        torch.cuda.synchronize()
        span = max((torch.nn.functional.softplus(
            torch.nn.functional.linear(x0, w.in_w)[..., -16:] + w.dt_bias).sum(1)
            * torch.exp(w.A_log)).max().item() for w in (w0, w1))
        tag = (f"spiral layer {layer}: B={batch} L={L} h={h} d=1024 H=16 n=16 "
               f"dt_limit={dt_limit} max span of dt*|A| {span:.0f}")
        for mode, (outs, refs) in got.items():
            err = max(close_to_ref(f"fused SSD mixer, {mode}, {tag}", o, r)
                      for o, r in zip(outs, refs))
            bar = TOL_FP32 * max(1.0, max(r.abs().max().item() for r in refs))
            print(f"  {mode}, {tag}  max|err| {err:.3e}  (tol {bar:.1e})")
            if path_err is None:
                path_err = err
        if wide and span < 200:
            fail(f"the wide-span case has a span of only {span:.0f}")

    spec = build_scan_spec("spiral", 14, 0)
    m0, m1 = mamba2_mixers(spec, 100)
    w0, w1 = m0.weights(), m1.weights()
    x0, c, wmask = block_inputs(196, 100, 1)
    x1 = x0 * wmask
    pro = Prologue(wmask, torch.ones_like(c[0, :h]), torch.zeros_like(c[0, :h]),
                   *(0.3 * c).chunk(2, dim=-1))
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba2_dual_mixer_fused(spec, x0, x1, w0, w1), reps=50)
        pro_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, (x0,), (w0, w1), prologue=pro),
                         reps=50)
        plain_ms = cuda_ms(lambda: (ssd_mixer_ref(spec, x0, w0), ssd_mixer_ref(spec, x1, w1)),
                           reps=10)
        pair_ms = cuda_ms(lambda: (m0(x0), m1(x1)), reps=10)  # scan_impl "auto"
    bound_ms, bound_by = ssd_mixer_bound_ms(M=2, B=1, L=196, h=h, d=1024, n=16, H=16, S=3, K=4)
    pro_bound_ms, _ = ssd_mixer_bound_ms(M=2, B=1, L=196, h=h, d=1024, n=16, H=16, S=3, K=4,
                                         prologue=True)
    print(f"  [{card}] ssd_mixer_fwd fp32, both branches, B=1 L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}); prologue mode {pro_ms:.4f} ms, bound {pro_bound_ms * 1e3:.2f} us")
    print("  library_ms: none; no single PyTorch call computes the whole mixer")
    print(f"  [{card}] yardstick: the composable pair (two Mamba2.forward with "
          f"scan_impl='auto': torch operators and cuBLAS, the plain version's own path, "
          f"same weights) {pair_ms:.4f} ms")
    return {
        "name": "ssd_mixer_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_ssd_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:174",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_spiral_epilogue(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.blocks import SpiralMambaBlock
    from diffma_tpu_torch.ops.fused_ssd import spiral_epilogue_cuda, spiral_epilogue_ref
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2f: kernel G (the Spiral block's tail) against its plain version, and the "
          "Mamba-2 block on its three routes", flush=True)
    h = 512
    path_err = None
    for grid_n, layer, batch in ((14, 0, 1), (14, 3, 8), (5, 1, 2)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        block = random_(SpiralMambaBlock(h, spec, use_mamba2=True), 30 + layer).cuda().eval()
        x, c, w = block_inputs(L, 30 + layer, batch)
        o0, o1 = (block_inputs(L, seed + layer, batch)[0] for seed in (40, 50))
        an, fc1, _, fc2 = block.attention_network
        with torch.no_grad():
            gate = block.adaLN_modulation(c).chunk(3, dim=-1)[2]
            tail = (o0, o1, x, gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight,
                    fc2.bias)
            err = close_to_ref(f"spiral epilogue, B={batch} L={L}", spiral_epilogue_cuda(*tail),
                               spiral_epilogue_ref(*tail))
            routes = {}
            for route, impl, fuse in (("two composable mixers", "auto", False),
                                      ("dual kernel E", "fused", False),
                                      ("fuse_block: E prologue + G", "fused", True)):
                block.scan_impl = block.mamba1.scan_impl = block.mamba2.scan_impl = impl
                block.fuse_block = fuse
                reset_counts()
                routes[route] = block(x, c, w)
                counts = {k: v.launches for k, v in kernel_counters().items() if v.launches}
                expect = {"auto": {}, "fused": {"ssd_mixer_fwd": 1}}[impl] | (
                    {"spiral_epilogue": 1} if fuse else {})
                if counts != expect:
                    fail(f"the block's route '{route}' launched {counts}, not {expect}")
        torch.cuda.synchronize()
        want = routes.pop("two composable mixers")
        errs = {r: close_to_ref(f"Mamba-2 block, {r}, B={batch} L={L}", got, want)
                for r, got in routes.items()}
        print(f"  spiral layer {layer}: B={batch} L={L} h={h}  kernel G max|err| {err:.3e}; "
              f"block against its composable route: "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
              + f"  (tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
        if path_err is None:
            path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    block = random_(SpiralMambaBlock(h, spec, use_mamba2=True), 300).cuda().eval()
    x, c, _ = block_inputs(196, 300, 1)
    o0, o1 = (block_inputs(196, seed, 1)[0] for seed in (301, 302))
    an, fc1, _, fc2 = block.attention_network
    with torch.no_grad():
        gate = block.adaLN_modulation(c).chunk(3, dim=-1)[2]
        tail = (o0, o1, x, gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight,
                fc2.bias)
        ms = cuda_ms(lambda: spiral_epilogue_cuda(*tail), reps=50)
        plain_ms = cuda_ms(lambda: spiral_epilogue_ref(*tail), reps=50)
    bound_ms, bound_by = epilogue_bound_ms(B=1, L=196, h=h)
    print(f"  [{card}] spiral_epilogue fp32, B=1 L=196 h=512: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the block's tail; the plain "
          "version is the unfused tail in torch operators (cuBLAS), the yardstick")
    return {
        "name": "spiral_epilogue",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/spiral_epilogue.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:1131",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def ssd_mixer_bwd_bound_ms(M, B, L, h, d, n, H, S, K) -> tuple[float, str]:
    """Least time for one fused-SSD-mixer backward of M branches on an H100:
    x, g, the residual zx and the weights read once, gx and the weight
    gradients written once, over the HBM rate; or the operations over the
    fp32 rate: four GEMMs over the token rows (g W_out, gW_out, gx, gW_in),
    the conv recomputed and its two adjoints, per stream C . B^T on the
    causal pairs (once, it is the same for every head), g_C and g_B, and per
    head and causal pair the decay (exp, three products) and the 2 * headdim
    of each of y_pre, M^T g_y and g_y xdt^T; about 30 per channel and stream
    row for the gate, the norm, the D skip and their adjoints."""
    tokens, rows = B * L, B * S * L
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    pairs = B * S * L * (L + 1) // 2
    ops = M * (
        2 * 2 * tokens * d * h  # g W_out, gW_out
        + 2 * 2 * tokens * dproj * h  # gx, gW_in
        + 3 * rows * conv_dim * 2 * K  # the conv again and its two adjoints
        + 3 * pairs * 2 * n  # C . B^T, g_C, g_B
        + pairs * H * (4 + 3 * 2 * hd)  # decay; y_pre, M^T g_y, g_y xdt^T
        + rows * d * 30  # gate, norm, D skip, their adjoints
    )
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    nbytes = M * 4 * (2 * weights + 3 * tokens * h + tokens * dproj) + 2 * S * L * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_ssd_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2g: kernel F (fused Mamba-2 mixer backward) against its plain version on "
          "the card, and kernel E's residual mode against its plain mode", flush=True)
    h, batch = 512, 8
    no_limit = (0.0, float("inf"))

    def grads_of(gx, gw, m):
        return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(Mamba2Weights._fields, gw)}}

    def inputs(L, seed):
        gen = torch.Generator().manual_seed(seed)
        return ([torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)],
                [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)])

    path_err = None
    cases = [
        # grid, layer, dt_limit, wide span
        (14, 0, no_limit, False), (14, 3, no_limit, False), (5, 0, no_limit, False),
        (14, 1, (0.5, 0.9), False), (14, 2, no_limit, True),
    ]
    for grid_n, layer, dt_limit, wide in cases:
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        ws = [m.weights() for m in mamba2_mixers(spec, 20 * layer, wide)]
        xs, gs = inputs(L, 60 + layer)
        sp = torch.nn.functional.softplus(
            torch.nn.functional.linear(xs[0], ws[0].in_w)[..., -16:] + ws[0].dt_bias)
        inside = ((sp >= dt_limit[0]) & (sp <= dt_limit[1])).float().mean().item()
        span = (sp.sum(1) * torch.exp(ws[0].A_log)).max().item()
        if dt_limit != no_limit and not 0.05 < inside < 0.95:
            fail(f"dt_limit {dt_limit} leaves {inside:.2f} of the steps unclipped: it must clip "
                 f"some and not others")
        if wide and span < 200:
            fail(f"the wide-span case has a span of only {span:.0f}")
        with torch.no_grad():
            plain = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit)
            outs, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
            outs1, zx1 = ssd_mixer_fused_cuda(spec, xs[:1], ws[:1], dt_limit, want_res=True)
        if not all(torch.equal(a, b) for a, b in zip((*outs, *outs1), (*plain, plain[0]))):
            fail(f"kernel E's residual mode changed its outputs: layer {layer}, L={L}")
        want = {}
        for m in range(2):
            want.update(grads_of(*ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m], dt_limit), m))
        tag = (f"spiral layer {layer}: B={batch} L={L} h={h} d=1024 H=16 n=16 dt_limit={dt_limit} "
               f"(unclipped {inside:.2f}) max span of dt*|A| {span:.0f}")
        for entry, M, res in (("dual", 2, zx), ("single", 1, zx1)):
            first = None
            for call in (1, 2):  # two calls in a row: nothing is left over from the first
                gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M], res, dt_limit)
                torch.cuda.synchronize()
                got = {}
                for m in range(M):
                    got.update(grads_of(gxs[m], gws[m], m))
                rows = grad_errors(got, {k: want[k] for k in got}, TOL_GRAD)
                if first is not None and not all(torch.equal(got[k], first[k]) for k in got):
                    fail(f"kernel F gave other bits on its second call: {entry}, {tag}")
                first = got
            err = max(e for _, e, _ in rows)
            worst = max(rows, key=lambda row: row[1] / row[2])
            print(f"  {entry}, {tag}  max|err| {err:.3e} over {len(rows)} gradients, twice, "
                  f"same bits; nearest its bar: {worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e}); "
                  f"residual mode's outputs equal plain E's")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    mixers = mamba2_mixers(spec, 200)
    ws = [m.weights() for m in mixers]
    xs, gs = inputs(196, 200)
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
        e_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, xs, ws), reps=20)
        e_res_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, xs, ws, want_res=True), reps=20)
    ms = cuda_ms(lambda: ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx), reps=10)
    plain_ms = cuda_ms(lambda: [ssd_mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(xs, gs, ws)],
                       reps=5)
    for m in mixers:
        m.train()
    leaves = [x.clone().requires_grad_() for x in xs]
    outs = [m(x) for m, x in zip(mixers, leaves)]  # scan_impl "auto": the composable path
    params = leaves + [p for m in mixers for p in m.parameters()]
    pair_ms = cuda_ms(lambda: torch.autograd.grad(outs, params, gs, retain_graph=True), reps=10)
    bound_ms, bound_by = ssd_mixer_bwd_bound_ms(M=2, B=batch, L=196, h=h, d=1024, n=16, H=16, S=3,
                                                K=4)
    e_bound_ms, _ = ssd_mixer_bound_ms(M=2, B=batch, L=196, h=h, d=1024, n=16, H=16, S=3, K=4)
    print(f"  [{card}] ssd_mixer_bwd fp32, both branches, B={batch} L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (forward and autograd backward), bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the whole mixer's backward")
    print(f"  [{card}] yardstick: the composable pair's backward (autograd through "
          f"ssd_mixer_ref: torch operators and cuBLAS, same weights) {pair_ms:.4f} ms")
    print(f"  [{card}] ssd_mixer_fwd at the training shapes (B={batch}, both branches): plain "
          f"mode {e_ms:.4f} ms, residual mode {e_res_ms:.4f} ms (bound {e_bound_ms * 1e3:.2f} us); "
          f"the residual is {zx.numel() * 4 / 1e6:.1f} MB per call")
    return {
        "name": "ssd_mixer_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_ssd_bwd.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:555",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def inner_bound_ms(G, L, d, n, r, K) -> tuple[float, str]:
    """Least time for one call of the mixer's inner part on an H100: xz and
    the weights read and the output written once over the HBM rate, or the
    operations (conv, x_proj, dt_proj, scan with the D skip and the gate)
    over fp32."""
    rows = G * L
    ops = rows * d * 2 * K + 2 * rows * d * (r + 2 * n) + 2 * rows * r * d + rows * d * (6 * n + 8)
    weights = d * K + d + (r + 2 * n) * d + d * r + d + d * n + d
    nbytes = 4 * (rows * 2 * d + rows * d + weights)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def inner_inputs(G, L, seed, dt_bias=0.0):
    """xz (G, L, 2048) and one mixer's inner weights at DiffMa's width on the
    card, every parameter off its init, dt_proj's bias moved by ``dt_bias``."""
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    m = random_(Mamba(512, build_scan_spec("zig", 2, 0)), seed)
    with torch.no_grad():
        m.dt_proj.bias.add_(dt_bias)
    w = m.cuda().weights()
    xz = torch.randn(G, L, 2048, generator=torch.Generator().manual_seed(seed + 1)).cuda()
    return (xz, w.conv_w[:, 0, :].detach(), w.conv_b.detach(), w.xp_w.detach(),
            w.dt_w.detach(), w.dt_b.detach(), -torch.exp(w.A_log.detach()), w.D.detach())


def doubled_atrous_spec(grid_n: int):
    """A scan spec that the whole-mixer kernel C cannot run: the four atrous
    streams of the grid and their reverses (every token twice, in 8 streams
    of L / 4 steps, merged with scale 0.5)."""
    import numpy as np

    from diffma_tpu_torch.ops.scan_orders import ScanSpec, _build_merge_table, build_scan_spec

    eff = build_scan_spec("efficientVMamba", grid_n, 0)
    fwd = np.concatenate([eff.fwd, eff.fwd[:, ::-1]])
    return ScanSpec(fwd=fwd, merge=_build_merge_table(fwd, grid_n * grid_n), scale=0.5)


def stage_ms(report: dict, *needles: str) -> float:
    """ms per call of the profiled device kernels whose name holds every needle."""
    return sum(ms for name, ms in report["top_kernels_ms_per_call"].items()
               if all(n in name for n in needles))


def phase_mamba_inner(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mamba import (
        mamba_inner_fused,
        mamba_inner_fused_cuda,
        mamba_inner_ref,
    )
    from diffma_tpu_torch.ops.fused_mixer import mamba_mixer_fused
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec
    from diffma_tpu_torch.utils.profiling import profile_calls

    print("== phase 2h: kernel H (the Mamba-1 mixer's inner part) against its plain version "
          "on the card, values and gradients", flush=True)
    names = ("xz", "conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D")
    cases = [
        # G, L, dt_bias: the path's shape (8 atrous streams of 49 steps at batch 1) first,
        # the three B/2 streams at batch 1 and 8, ragged lengths
        (8, 49, 0.0), (3, 196, 0.0), (24, 196, 0.0), (64, 49, 0.0), (3, 25, -2.0), (5, 13, 2.0),
    ]
    path_err = None
    for i, (G, L, dt_bias) in enumerate(cases):
        args = inner_inputs(G, L, seed=300 + i, dt_bias=dt_bias)
        with torch.no_grad():
            got, want = mamba_inner_fused_cuda(*args), mamba_inner_ref(*args)
        torch.cuda.synchronize()
        err = close_to_ref(f"fused Mamba inner, G={G} L={L}", got, want)
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(i)).cuda()
        leaves = [t.clone().requires_grad_() for t in args]
        refs = [t.clone().requires_grad_() for t in args]
        mamba_inner_fused(*leaves).backward(g)  # MambaInnerFn: H, then A and B
        mamba_inner_ref(*refs).backward(g)
        rows = grad_errors(dict(zip(names, (t.grad for t in leaves))),
                           dict(zip(names, (t.grad for t in refs))), TOL_GRAD)
        worst = max(rows, key=lambda row: row[1] / row[2])
        print(f"  G={G} L={L} d=1024 n=16 r=32, dt_bias {dt_bias:+.0f} + noise: max|err| {err:.3e} "
              f"(tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e}); 8 gradients through "
              f"MambaInnerFn, nearest its bar: {worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e})")
        if path_err is None:
            path_err = err

    times = {}
    with torch.no_grad():
        for G, L in ((8, 49), (3, 196), (24, 196)):
            args = inner_inputs(G, L, seed=400 + G)
            bound_ms, bound_by = inner_bound_ms(G, L, 1024, 16, 32, 4)
            times[G, L] = (cuda_ms(lambda: mamba_inner_fused_cuda(*args), reps=50),
                           cuda_ms(lambda: mamba_inner_ref(*args), reps=5), bound_ms, bound_by)
            print(f"  [{card}] mamba_inner_fwd fp32 G={G} L={L} d=1024: kernel {times[G, L][0]:.4f} ms, "
                  f"plain {times[G, L][1]:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
        # The same two stages inside kernel C (one mixer, 3 spiral streams, batch 1).
        args = inner_inputs(3, 196, seed=403)
        h_prof = profile_calls(lambda: mamba_inner_fused_cuda(*args), calls=20)
        spec = build_scan_spec("spiral", 14, 0)
        m = random_(Mamba(512, spec), 404).cuda()
        x = torch.randn(1, 196, 512, generator=torch.Generator().manual_seed(405)).cuda()
        c_prof = profile_calls(lambda: mamba_mixer_fused(spec, x, m.weights()), calls=20)
    print(f"  [{card}] device ms per call by stage (torch.profiler, G=3 L=196): kernel H conv + "
          f"x_proj {stage_ms(h_prof, 'ConvXProj'):.4f}, scan {stage_ms(h_prof, 'scan_kernel'):.4f}; "
          f"kernel C (one mixer, 3 streams) conv + x_proj {stage_ms(c_prof, 'ConvXProj'):.4f}, scan "
          f"{stage_ms(c_prof, 'scan_kernel'):.4f}, in_proj {stage_ms(c_prof, 'InProj'):.4f}, "
          f"merge + out_proj {stage_ms(c_prof, 'MergeOutProj'):.4f}")
    print("  library_ms: none; no single PyTorch call computes the mixer's inner part")
    ms, plain_ms, bound_ms, bound_by = times[8, 49]
    return {
        "name": "mamba_inner_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mamba_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_mamba.py:42",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "other_shapes": {f"G{G}_L{L}": {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2]}
                         for (G, L), t in times.items()},
    }


def phase_mixer_families(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import mamba_mixer_fused, mixer_ref
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2i: kernel C's one-mixer form on the vim quirk, the EfficientVMamba "
          "partition, one stream (zig) and four (vmamba), against its plain version", flush=True)
    h = 512
    times = {}
    for family, batches in (("vim", (1, 8)), ("efficientVMamba", (1, 8)), ("zig", (1,)),
                            ("vmamba", (1,))):
        for grid_n in (14, 4):  # 196 tokens, and 16 (streams of 4 steps in the partition)
            spec = build_scan_spec(family, grid_n, 1)
            L = grid_n * grid_n
            S, Ls = spec.fwd.shape
            m = random_(Mamba(h, spec), 500 + grid_n).cuda()
            for batch in batches:
                x = torch.randn(batch, L, h, generator=torch.Generator().manual_seed(batch)).cuda()
                with torch.no_grad():
                    got, want = mamba_mixer_fused(spec, x, m.weights()), mixer_ref(spec, x, m.weights())
                torch.cuda.synchronize()
                err = close_to_ref(f"fused mixer, {family}, B={batch} L={L}", got, want)
                print(f"  {family}: B={batch} L={L} S={S} Ls={Ls} quirk={spec.mamba1_vim_quirk}  "
                      f"max|err| {err:.3e}  (tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
        spec = build_scan_spec(family, 14, 1)
        S, Ls = spec.fwd.shape
        m = random_(Mamba(h, spec), 600).cuda()
        x = torch.randn(1, 196, h, generator=torch.Generator().manual_seed(600)).cuda()
        with torch.no_grad():
            ms = cuda_ms(lambda: mamba_mixer_fused(spec, x, m.weights()), reps=50)
            plain_ms = cuda_ms(lambda: mixer_ref(spec, x, m.weights()), reps=5)
        bound_ms, bound_by = mixer_bound_ms(M=1, B=1, L=196, h=h, d=1024, n=16, r=32, S=S, K=4,
                                            Ls=Ls, quirk=spec.mamba1_vim_quirk)
        times[family] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
        print(f"  [{card}] mixer_fused_fwd fp32, one mixer, {family} (S={S}, Ls={Ls}), B=1 L=196: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return times


def phase_ssd_partition(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        mamba2_dual_mixer_fused,
        mamba2_mixer_fused,
        ssd_mixer_ref,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2j: kernel E on the EfficientVMamba partition against its plain version",
          flush=True)
    h = 512
    for grid_n, batch in ((14, 1), (14, 8), (4, 1), (4, 8)):
        spec = build_scan_spec("efficientVMamba", grid_n, 0)
        L = grid_n * grid_n
        m0, m1 = mamba2_mixers(spec, 700 + grid_n)
        w0, w1 = m0.weights(), m1.weights()
        x0, _, wmask = block_inputs(L, 700 + batch, batch)
        x1 = x0 * wmask
        with torch.no_grad():
            want = [ssd_mixer_ref(spec, x, w) for x, w in ((x0, w0), (x1, w1))]
            got = (*mamba2_dual_mixer_fused(spec, x0, x1, w0, w1),
                   mamba2_mixer_fused(spec, x1, w1))
        torch.cuda.synchronize()
        err = max(close_to_ref(f"fused SSD mixer, partition, B={batch} L={L}", o, r)
                  for o, r in zip(got, (*want, want[1])))
        print(f"  dual and single: B={batch} L={L} S=4 Ls={L // 4}  max|err| {err:.3e}  "
              f"(tol {TOL_FP32 * max(1.0, max(r.abs().max().item() for r in want)):.1e})")
    spec = build_scan_spec("efficientVMamba", 14, 0)
    (m0, _) = mamba2_mixers(spec, 800)
    x0 = block_inputs(196, 800, 1)[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba2_mixer_fused(spec, x0, m0.weights()), reps=50)
        plain_ms = cuda_ms(lambda: ssd_mixer_ref(spec, x0, m0.weights()), reps=10)
    bound_ms, bound_by = ssd_mixer_bound_ms(M=1, B=1, L=196, h=h, d=1024, n=16, H=16, S=4, K=4,
                                            Ls=49)
    print(f"  [{card}] ssd_mixer_fwd fp32, one mixer, partition (S=4, Ls=49), B=1 L=196: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return {"efficientVMamba": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}}


def phase_inner_path(card: str) -> int:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba

    print("== phase 3e: Mamba(512, scan_impl='fused') on a spec kernel C cannot run (4 atrous "
          "streams and their reverses): kernel H on the path", flush=True)
    spec = doubled_atrous_spec(14)
    if spec.fwd.shape != (8, 49) or spec.merge.shape != (196, 2):
        fail(f"the doubled-atrous spec has streams {spec.fwd.shape} and merge {spec.merge.shape}")
    m = random_(Mamba(512, spec, scan_impl="fused"), 900).cuda().eval()
    zero = {name: 0 for name in kernel_counters()}
    for batch in (1, 8):
        x = torch.randn(batch, 196, 512, generator=torch.Generator().manual_seed(batch)).cuda()
        with torch.no_grad():
            reset_counts()
            got = m(x)
            check_counts(f"Mamba on the doubled-atrous spec, B={batch}",
                         {**zero, "mamba_inner_fwd": 1})
            m.scan_impl = "ref"
            want = m(x)
            m.scan_impl = "fused"
        torch.cuda.synchronize()
        err = close_to_ref(f"Mamba through kernel H, B={batch}", got, want)
        print(f"  B={batch} L=196, 8 streams of 49 steps: max|fused - plain route| {err:.3e}  "
              f"(tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
    calls = 8 * 250  # blocks x steps: a DDPM-250 chain's worth of one B/2 model's mixers
    x = torch.randn(1, 196, 512, generator=torch.Generator().manual_seed(3)).cuda()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(calls):
            x = x + 0.01 * m(x)  # each call feeds the next, as a chain's steps do
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = check_counts("2000 Mamba forwards through kernel H", {**zero, "mamba_inner_fwd": calls})
    if not bool(torch.isfinite(x).all()):
        fail("2000 Mamba forwards through kernel H left a non-finite value")
    print(f"  [{card}] {calls} forwards at batch 1 in {seconds:.3f} s ({seconds / calls * 1e3:.4f} ms "
          f"each, host clock), every one through kernel H, none through kernel C")
    return counts["mamba_inner_fwd"]


FAMILY_MODELS = ("ZigMa-B/2", "ViM-B/2", "VMamba-B/2", "EMamba-B/2", "DiT-B/2")


def seeded_model(name: str, seed: int, **kw):
    """A registry model on the CPU whose every parameter is seeded noise (std
    0.3 / sqrt(fan-in) on top of the init), so that the blocks' gates are
    open and the mixers shape the output."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    model = build_model(name, input_size=28, **kw)
    return random_(model.init_weights(torch.Generator().manual_seed(seed)), seed, scale=0.3)


def phase_family_forwards(card: str) -> None:
    import torch

    from diffma_tpu_torch.utils.profiling import profile_denoiser

    print("== phase 3f: full-width forward of each other family (B/2: depth 8, hidden 512, 196 "
          "tokens), fused route against the plain one", flush=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()
    inputs = (x, t, y, y2, w)
    zero = {name: 0 for name in kernel_counters()}
    for name in FAMILY_MODELS:
        for use_mamba2 in (False, True):
            dit = name.startswith("DiT")
            if dit and use_mamba2:
                continue  # DiT has no mixer
            model = seeded_model(name, 21, scan_impl="fused", use_mamba2=use_mamba2).cuda().eval()
            kernel = "ssd_mixer_fwd" if use_mamba2 else "mixer_fused_fwd"
            reset_counts()
            with torch.no_grad():
                got = model(*inputs)
            check_counts(f"the {name} forward", zero if dit else {**zero, kernel: 8})
            report = profile_denoiser(model, inputs, calls=5)
            with torch.no_grad():
                event_ms = cuda_ms(lambda: model(*inputs), reps=10)
                if not dit:
                    model.set_scan_impl("ref")
                want = model(*inputs)
            if tuple(got.shape) != (1, 8, 28, 28):
                fail(f"the {name} forward gave shape {tuple(got.shape)}")
            err = close_to_ref(f"{name} forward, use_mamba2={use_mamba2}", got, want, TOL_MODEL)
            mixer = "no mixer" if dit else ("Mamba-2, kernel E" if use_mamba2 else "Mamba-1, kernel C")
            print(f"  [{card}] {name} ({mixer}): max|fused - plain| {err:.3e} (max|ref| "
                  f"{want.abs().max().item():.3f}, tol {TOL_MODEL * max(1.0, want.abs().max().item()):.1e}); "
                  f"{event_ms:.3f} ms per forward at batch 1 (CUDA events); under the profiler "
                  f"{report['ms_per_call']:.3f} ms wall, device busy "
                  f"{report['device_busy_ms_per_call']:.3f} ms, idle share "
                  f"{report['device_idle_share']:.3f}, {report['kernels_per_call']:.0f} device "
                  f"kernels per forward")
            del model
    torch.cuda.empty_cache()


def write_checkpoint(path: str, name: str, seed: int, use_mamba2: bool = False) -> None:
    """A reference-format checkpoint of ``seeded_model(name, seed)``."""
    import torch

    model = seeded_model(name, seed, use_mamba2=use_mamba2)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)


def phase_family_samplers(card: str) -> None:
    import tempfile

    from diffma_tpu_torch.train import sample

    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    zero = {name: 0 for name in kernel_counters()}
    runs = (
        # name, use_mamba2, the kernel of its path, its calls: blocks x 250 steps
        ("ViM-B/2", False, "mixer_fused_fwd", 8 * 250),
        ("EMamba-B/2", False, "mixer_fused_fwd", 8 * 250),
        ("VMamba-BL/2", False, "mixer_fused_fwd", 13 * 250),
        ("EMamba-B/2", True, "ssd_mixer_fwd", 8 * 250),
        ("ZigMa-B/2", True, "ssd_mixer_fwd", 8 * 250),
        ("DiT-SB/2", False, None, 0),
    )
    for i, (name, use_mamba2, kernel, calls) in enumerate(runs):
        flag = ["--use-mamba2"] if use_mamba2 else []
        print(f"== phase 14.{i + 1}: sampler CLI on configs/brain.yaml --model {name} "
              f"{' '.join(flag)} from a checkpoint, DDPM-250, 1 image", flush=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            path = os.path.join(tmp, "0050000.pt")
            write_checkpoint(path, name, 50 + i, use_mamba2)
            reset_counts()
            images = sample.cli([
                "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model", name, *flag,
                "--ckpt", path, "--num-batches", "1",
            ])
        check_counts(f"the {name} sampler", {**zero, kernel: calls} if kernel else zero)
        check_images(card, f"the {name}{' --use-mamba2' if use_mamba2 else ''} sampler", images, 1)


def phase_family_trainers(card: str) -> None:
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train

    zero = {name: 0 for name in kernel_counters()}
    calls = 8 * 5  # blocks x steps: one mixer per block
    runs = (
        ("VMamba-B/2", {}, "fused (kernels C + D, 4 streams)",
         {"mixer_fused_fwd": calls, "mixer_fused_bwd": calls}),
        ("ViM-B/2", {"scan_impl": "auto"}, "scan_impl: auto (kernels A + B)",
         {"selective_scan_fwd": calls, "selective_scan_bwd": calls}),
    )
    for i, (name, extra, what, expect) in enumerate(runs):
        print(f"== phase 15.{i + 1}: trainer on configs/brain.yaml, {name}, batch 8, 5 steps, {what}",
              flush=True)
        results = os.path.join(ROOT, "results", f"chip_smoke_train_family_{i}")
        shutil.rmtree(results, ignore_errors=True)
        cfg = brain_config(model=name, max_steps=5, log_every=5, ckpt_every=10**9,
                           results_dir=results, **extra)
        reset_counts()
        state = train.main(cfg, device="cuda")
        check_counts(f"the {name} trainer", {**zero, **expect})
        if state.step != 5:
            fail(f"the {name} trainer counted {state.step} finite steps of 5")
        init = build_model(name, input_size=28).init_weights(
            torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
        still = moved_from_init(state.model, init)
        if still:
            fail(f"{still} tensors of the {name} params did not move in 5 steps")
        (exp,) = os.listdir(results)
        steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
        print(f"  [{card}] {name} training, batch 8, steps 1-5 (first step included): {steps_s} "
              f"steps/s, {images_s} images/s; every parameter moved")
        shutil.rmtree(results, ignore_errors=True)
        del state
        torch.cuda.empty_cache()

    print("== phase 15.3: trainer on ViM-B/2 on the fused route must raise: kernel D has no vim "
          "branch yet", flush=True)
    results = os.path.join(ROOT, "results", "chip_smoke_train_family_raise")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(model="ViM-B/2", max_steps=1, results_dir=results)
    reset_counts()
    try:
        train.main(cfg, device="cuda")
    except NotImplementedError as e:
        if "kernel D" not in str(e) or "scan_impl: auto" not in str(e):
            fail(f"the fused ViM trainer raised, but does not name the branch or the route: {e}")
        print(f"  raised NotImplementedError: {e}")
    else:
        fail("the fused ViM trainer did not raise")
    check_counts("the refused ViM trainer", zero)
    shutil.rmtree(results, ignore_errors=True)


def phase_forward(card: str) -> None:
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    print("== phase 3: full-width DiffMa-B/2 forward: plain scan, kernel A, kernel C",
          flush=True)
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
        model.set_scan_impl(impl)
        with torch.no_grad():
            return model(x, t, y, y2, w)

    want = run("ref")
    got_a = run("pallas")
    ms_a = cuda_ms(lambda: run("pallas"), reps=10)
    got_c = run("fused")
    ms_c = cuda_ms(lambda: run("fused"), reps=10)
    scale = want.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # fp32 through 8 blocks, 16 mixers
    for name, got, ref, ref_name in (("kernel A", got_a, want, "plain"),
                                     ("kernel C", got_c, got_a, "kernel A")):
        err = (got - ref).abs().max().item()
        print(f"  out {tuple(got.shape)}  max|ref| {scale:.3f}  max|{name} - {ref_name}| "
              f"{err:.3e}  (tol {tol:.1e})")
        if tuple(got.shape) != (1, 8, 28, 28) or not torch.isfinite(got).all() or err > tol:
            fail(f"DiffMa-B/2 forward through {name} disagrees with the {ref_name} path")
    print(f"  [{card}] one denoiser forward at batch 1: {ms_a:.3f} ms through kernel A "
          f"(pallas), {ms_c:.3f} ms through kernel C (fused)")


def phase_train_step(card: str) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    print("== phase 3b: full-width DiffMa-B/2 training step, batch 2: plain path, "
          "kernels A + B, kernels C + D", flush=True)
    # Weights as phase 6 draws them (std 0.3 / sqrt(fan-in)), so that every
    # block's gate is open and the mixers' gradients are of order 1.
    model = build_model("DiffMa-B/2", input_size=28)
    model = random_(model.init_weights(torch.Generator().manual_seed(3)), 3, scale=0.3)
    model = model.cuda()
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(3), 2, 28, 196)
    batch["t"] = torch.tensor([10, 900], device="cuda")
    batch["noise"] = torch.randn(2, 4, 28, 28, generator=torch.Generator().manual_seed(4)).cuda()
    loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
    losses, grads = {}, {}
    zero = {name: 0 for name in kernel_counters()}
    expect = {"ref": zero, "pallas": {**zero, "selective_scan_fwd": 16, "selective_scan_bwd": 16},
              "fused": {**zero, "mixer_fused_fwd": 8, "mixer_fused_bwd": 8}}
    for impl in ("ref", "pallas", "fused"):
        model.set_scan_impl(impl)
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, _ = loss_fn(batch, None)
        loss.backward()
        torch.cuda.synchronize()
        check_counts(f"the {impl} training step", expect[impl])
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        if any(g is None for g in grads[impl].values()):
            fail(f"the {impl} path left a parameter without a gradient")
    mixer_grads = [g for n, g in grads["ref"].items() if ".mamba" in n]
    print(f"  plain path: max |gradient| {max(g.abs().max().item() for g in grads['ref'].values()):.3e} "
          f"over all parameters, {max(g.abs().max().item() for g in mixer_grads):.3e} over the "
          f"mixers' ({len(mixer_grads)} tensors)")
    for impl, what in (("pallas", "kernels A + B"), ("fused", "kernels C + D")):
        rows = grad_errors(grads[impl], grads["ref"], TOL_MODEL)
        worst = max(rows, key=lambda row: row[1] / row[2])
        rel = max((got - grads["ref"][n]).abs().max().item()
                  / max(grads["ref"][n].abs().max().item(), 1e-30)
                  for n, got in grads[impl].items())
        loss_err = abs(losses[impl] - losses["ref"])
        print(f"  {what}: loss {losses[impl]:.6f} (plain {losses['ref']:.6f}, |err| "
              f"{loss_err:.2e}); {len(rows)} gradients, max |err| "
              f"{max(e for _, e, _ in rows):.3e}, largest error relative to its tensor's "
              f"max |ref| {rel:.2e}; nearest its bar: {worst[0]} {worst[1]:.2e} "
              f"(bar {worst[2]:.1e})")
        if not math.isfinite(losses[impl]) or loss_err > TOL_MODEL * max(1.0, abs(losses["ref"])):
            fail(f"the training loss through {what} disagrees with the plain path's")


def phase_mamba2_forward(card: str) -> None:
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.utils.profiling import profile_denoiser

    print("== phase 3c: full-width Mamba-2 DiffMa-B/2 forward: composable, dual kernel E, "
          "fuse_block (kernel E prologue + kernel G)", flush=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()
    inputs = (x, t, y, y2, w)

    def build(use_mamba2):
        model = build_model("DiffMa-B/2", input_size=28, use_mamba2=use_mamba2)
        g = torch.Generator().manual_seed(1)
        model.init_weights(g)
        with torch.no_grad():
            for p in model.parameters():  # every parameter random, adaLN included
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        return model.cuda().eval()

    model = build(True)
    routes = (("composable", "auto", False, {}),
              ("dual kernel E", "fused", False, {"ssd_mixer_fwd": 8}),
              ("fuse_block", "fused", True, {"ssd_mixer_fwd": 8, "spiral_epilogue": 8}))
    outs, reports = {}, {}
    for route, impl, fuse, expect in routes:
        model.set_scan_impl(impl)
        for blk in model.blocks:
            blk.fuse_block = fuse
        reset_counts()
        with torch.no_grad():
            outs[route] = model(*inputs)
        check_counts(f"the Mamba-2 forward, {route}",
                     {name: expect.get(name, 0) for name in kernel_counters()})
        reports[route] = profile_denoiser(model, inputs, calls=5)
        with torch.no_grad():
            reports[route]["event_ms"] = cuda_ms(lambda: model(*inputs), reps=10)
    mamba1 = build(False).set_scan_impl("fused")
    reports["Mamba-1 fused (kernel C)"] = profile_denoiser(mamba1, inputs, calls=5)
    with torch.no_grad():
        reports["Mamba-1 fused (kernel C)"]["event_ms"] = cuda_ms(lambda: mamba1(*inputs), reps=10)
    want = outs.pop("composable")
    scale = want.abs().max().item()
    for route, got in outs.items():
        if tuple(got.shape) != (1, 8, 28, 28):
            fail(f"the Mamba-2 forward gave shape {tuple(got.shape)}")
        err = close_to_ref(f"Mamba-2 DiffMa-B/2 forward, {route}", got, want, TOL_MODEL)
        print(f"  out {tuple(got.shape)}  max|ref| {scale:.3f}  max|{route} - composable| "
              f"{err:.3e}  (tol {TOL_MODEL * max(1.0, scale):.1e})")
    for route, r in reports.items():
        print(f"  [{card}] {route}: {r['event_ms']:.3f} ms per forward at batch 1 (CUDA events); "
              f"under the profiler {r['ms_per_call']:.3f} ms wall, device busy "
              f"{r['device_busy_ms_per_call']:.3f} ms, idle share {r['device_idle_share']:.3f}, "
              f"{r['kernels_per_call']:.0f} device kernels per forward")


def phase_mamba2_train_step(card: str) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    print("== phase 3d: full-width Mamba-2 DiffMa-B/2 training step, batch 2: composable "
          "(torch autograd), dual (kernels E + F), fuse_block (E + G forward, recomputing "
          "backward)", flush=True)
    model = build_model("DiffMa-B/2", input_size=28, use_mamba2=True)
    model = random_(model.init_weights(torch.Generator().manual_seed(5)), 5, scale=0.3)
    model = model.cuda()
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(5), 2, 28, 196)
    batch["t"] = torch.tensor([10, 900], device="cuda")
    batch["noise"] = torch.randn(2, 4, 28, 28, generator=torch.Generator().manual_seed(6)).cuda()
    loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
    zero = {name: 0 for name in kernel_counters()}
    routes = (
        ("composable", "auto", False, zero),
        ("dual (E + F)", "fused", False, {**zero, "ssd_mixer_fwd": 8, "ssd_mixer_bwd": 8}),
        # forward E (prologue) + G per block; backward E (residual) + F per block
        ("fuse_block", "fused", True,
         {**zero, "ssd_mixer_fwd": 16, "spiral_epilogue": 8, "ssd_mixer_bwd": 8}),
    )
    losses, grads = {}, {}
    for route, impl, fuse, expect in routes:
        model.set_scan_impl(impl)
        for blk in model.blocks:
            blk.fuse_block = fuse
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, _ = loss_fn(batch, None)
        loss.backward()
        torch.cuda.synchronize()
        check_counts(f"the Mamba-2 training step, {route}", expect)
        losses[route] = loss.item()
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
        if any(g is None for g in grads[route].values()):
            fail(f"the Mamba-2 {route} route left a parameter without a gradient")
    ref = grads["composable"]
    mixer_grads = [g for n, g in ref.items() if ".mamba" in n]
    print(f"  composable route: max |gradient| {max(g.abs().max().item() for g in ref.values()):.3e} "
          f"over all parameters, {max(g.abs().max().item() for g in mixer_grads):.3e} over the "
          f"mixers' ({len(mixer_grads)} tensors)")
    for route in ("dual (E + F)", "fuse_block"):
        rows = grad_errors(grads[route], ref, TOL_MODEL)
        worst = max(rows, key=lambda row: row[1] / row[2])
        rel = max((got - ref[n]).abs().max().item() / max(ref[n].abs().max().item(), 1e-30)
                  for n, got in grads[route].items())
        loss_err = abs(losses[route] - losses["composable"])
        print(f"  {route}: loss {losses[route]:.6f} (composable {losses['composable']:.6f}, |err| "
              f"{loss_err:.2e}); {len(rows)} gradients, max |err| "
              f"{max(e for _, e, _ in rows):.3e}, largest error relative to its tensor's "
              f"max |ref| {rel:.2e}; nearest its bar: {worst[0]} {worst[1]:.2e} "
              f"(bar {worst[2]:.1e})")
        if (not math.isfinite(losses[route])
                or loss_err > TOL_MODEL * max(1.0, abs(losses["composable"]))):
            fail(f"the Mamba-2 training loss on the {route} route disagrees with the "
                 f"composable route's")


def write_mamba2_checkpoint(path: str) -> dict:
    """A reference-format checkpoint of a Mamba-2 DiffMa-B/2 whose every
    parameter is seeded noise (std 0.3 / sqrt(fan-in), as phase 6's), so that
    the blocks' gates are open and the mixers shape the image; returns the
    state dict written."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    model = build_model("DiffMa-B/2", input_size=28, use_mamba2=True)
    model = random_(model.init_weights(torch.Generator().manual_seed(42)), 42, scale=0.3)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)
    return model.state_dict()


def phase_mamba2_samplers(card: str) -> dict:
    import tempfile

    import numpy as np
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint

    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    calls = 8 * 250  # blocks x steps: one kernel E call per block and step, per image
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        written = write_mamba2_checkpoint(path)

        print("== phase 10: Mamba-2 sampler, CLI on configs/brain.yaml --model DiffMa-B/2 "
              "--use-mamba2 from a checkpoint, DDPM-250, 2 batches of 1 (kernel E)", flush=True)
        reset_counts()
        dual = sample.cli([
            "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model", "DiffMa-B/2",
            "--use-mamba2", "--ckpt", path, "--num-batches", "2",
        ])
        counts = check_counts("the Mamba-2 sampler", {name: 0 for name in kernel_counters()}
                              | {"ssd_mixer_fwd": 2 * calls})
        loaded = sample.load_model(
            brain_config(model="DiffMa-B/2", use_mamba2=True, ckpt=path), "cuda")
        for key, value in loaded.state_dict().items():
            if not torch.equal(value.cpu(), written[key]):
                fail(f"the sampler's model does not hold the checkpoint's {key}")
        if loaded.blocks[0].scan_impl != "fused" or loaded.blocks[0].fuse_block:
            fail("the Mamba-2 sampler's default route is not the dual fused one")

        print("== phase 11: block-fused Mamba-2 sampler (fuse_block: kernel E prologue + "
              "kernel G), same checkpoint and seed, 1 batch of 1", flush=True)
        cfg = brain_config(
            model="DiffMa-B/2", synthetic_data=True, sample_global_batch_size=1,
            sample_num_steps=250, sample_num_batches=1,
            save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_fuse_block"),
        )
        model = build_model("DiffMa-B/2", input_size=28, scan_impl="fused", use_mamba2=True,
                            fuse_block=True)
        load_diffma_checkpoint(model, path, "ema")
        reset_counts()
        whole = sample.sample_batches(model.cuda().eval(), cfg, device="cuda")
        counts |= {"spiral_epilogue": check_counts(
            "the block-fused Mamba-2 sampler", {name: 0 for name in kernel_counters()}
            | {"ssd_mixer_fwd": calls, "spiral_epilogue": calls})["spiral_epilogue"]}
    check_images(card, "the Mamba-2 sampler", dual, 2)
    check_images(card, "the block-fused Mamba-2 sampler", whole, 1)
    a, b = dual[0]["images"], whole[0]["images"]
    err, scale = float(np.abs(a - b).max()), float(np.abs(a).max())
    bar = TOL_IMAGE * max(1.0, scale)
    print(f"  first image, dual route against fuse_block, same seed: max |diff| {err:.3e} "
          f"(max |image| {scale:.3f}, bar {bar:.1e}); image std {a.std():.4f}")
    if err > bar:
        fail(f"the two Mamba-2 routes' images differ by {err:.3e}, over the bar {bar:.1e}")
    return counts


def phase_mamba2_trainer(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample, train

    print("== phase 12: Mamba-2 trainer CLI on configs/brain.yaml --use-mamba2 (DiffMa-L/2, "
          "batch 8, synthetic), 20 steps, checkpoint at step 20, sampled back", flush=True)
    cfg = brain_config()
    results = os.path.join(ROOT, "results", "chip_smoke_train_mamba2")
    shutil.rmtree(results, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    state = train.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--use-mamba2",
        "--max-steps", "20", "--ckpt-every", "20", "--results-dir", results,
    ])
    seconds = time.perf_counter() - t0
    zero = {name: 0 for name in kernel_counters()}
    calls = 16 * 20  # blocks x steps: one E and one F call per block and step
    counts = check_counts("the Mamba-2 trainer", {**zero, "ssd_mixer_fwd": calls,
                                                  "ssd_mixer_bwd": calls})
    if state.step != 20:
        fail(f"the Mamba-2 trainer counted {state.step} finite steps of 20")
    if not state.model.blocks[0].use_mamba2 or state.model.blocks[0].scan_impl != "fused":
        fail("the Mamba-2 trainer's default path is not the fused Mamba-2 one")
    init = build_model(cfg.model, input_size=28, use_mamba2=True).init_weights(
        torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
    for what, module in (("params", state.model), ("EMA", state.ema)):
        still = moved_from_init(module, init)
        if still:
            fail(f"{still} tensors of the Mamba-2 {what} did not move in 20 steps")
    (exp,) = os.listdir(results)
    ckpt = os.path.join(results, exp, "checkpoints", "0000020.pt")
    if not os.path.exists(ckpt):
        fail(f"the Mamba-2 trainer wrote no checkpoint at {ckpt}")
    loaded = sample.load_model(brain_config(ckpt=ckpt, use_mamba2=True), "cuda")
    ema = state.ema.state_dict()
    for key, value in loaded.state_dict().items():
        if not torch.equal(value, ema[key]):
            fail(f"the sampler's model does not hold the Mamba-2 checkpoint's EMA {key}")
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  20 steps, every loss finite; params and EMA moved; checkpoint "
          f"{os.path.getsize(ckpt) / 2**20:.0f} MiB read back by the sampler, EMA equal")
    print(f"  [{card}] DiffMa-L/2 Mamba-2 fused training, batch 8, steps 11-20: {steps_s} "
          f"steps/s, {images_s} images/s ({seconds:.1f} s for the whole CLI run, init included)")
    del state, loaded
    torch.cuda.empty_cache()
    reset_counts()
    images = sample.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--use-mamba2", "--ckpt", ckpt,
        "--num-batches", "1",
    ])
    check_counts("the sampler on the Mamba-2 trainer's checkpoint",
                 {**zero, "ssd_mixer_fwd": 16 * 250})  # blocks x steps, no backward
    check_images(card, "the sampler on the Mamba-2 trainer's checkpoint", images, 1)
    shutil.rmtree(results, ignore_errors=True)
    return counts


def brain_config(**override):
    from diffma_tpu_torch.utils.config import load_config, merge

    return merge(load_config(os.path.join(ROOT, "configs", "brain.yaml")), override)


def run_sampler(card: str, cfg, batches: int, expect: dict) -> list:
    """``sample.main`` with the kernels' counts set to 0 just before it;
    checks the images and that each kernel ran exactly ``expect[name]`` times."""
    from diffma_tpu_torch.train import sample

    reset_counts()
    results = sample.main(cfg, device="cuda")
    check_counts("the sampler", {name: expect.get(name, 0) for name in kernel_counters()})
    check_images(card, "the sampler", results, batches)
    return results


def check_images(card: str, what: str, results: list, batches: int) -> None:
    """``batches`` batches of one finite (1, 3, 224, 224) image each, whose
    values vary and stay in the thousands (the VAE's weights are random, so
    its range is its own); prints the seconds per batch."""
    import numpy as np

    if len(results) != batches:
        fail(f"{what}: expected {batches} batches, got {len(results)}")
    for i, r in enumerate(results, start=1):
        img = r["images"]
        print(f"  batch {i}: images {img.shape}, {r['seconds']:.3f} s, "
              f"PSNR {r['quality']['psnr_db']:.2f} dB (random weights)")
        if img.shape != (1, 3, 224, 224) or not np.isfinite(img).all():
            fail(f"{what}, batch {i}: expected finite (1, 3, 224, 224) images, got {img.shape}")
        if float(np.abs(img).max()) > 1e3 or float(img.std()) == 0.0:
            fail(f"{what}, batch {i}: image values out of range or constant")
    seconds = [r["seconds"] for r in results]
    print(f"  [{card}] {what}: seconds per batch {', '.join(f'{x:.3f}' for x in seconds)}; "
          f"images/s {len(seconds) / sum(seconds):.4f} over all, {1 / seconds[-1]:.4f} last")


def phase_sampler(card: str) -> int:
    print("== phase 4: composable sampler (kernel A), DiffMa-B/2, DDPM-250, 1 batch of 1",
          flush=True)
    cfg = brain_config(
        model="DiffMa-B/2", scan_impl="pallas", synthetic_data=True,
        sample_global_batch_size=1, sample_num_steps=250, sample_num_batches=1,
        save_dir=os.path.join(ROOT, "result_sample", "chip_smoke"),
    )
    expected = 2 * 8 * 250 * 1  # mixers x blocks x steps x batches
    run_sampler(card, cfg, 1, {"selective_scan_fwd": expected})
    return expected


def phase_fused_sampler(card: str) -> int:
    print("== phase 5: default (fused) sampler, DiffMa-B/2, DDPM-250, 2 batches of 1",
          flush=True)
    cfg = brain_config(
        model="DiffMa-B/2", synthetic_data=True, sample_global_batch_size=1,
        sample_num_steps=250, sample_num_batches=2,
        save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_fused"),
    )
    if "scan_impl" in cfg:
        fail("configs/brain.yaml sets scan_impl; this phase samples with the default")
    expected = 8 * 250 * 2  # blocks x steps x batches: one call per block
    run_sampler(card, cfg, 2, {"mixer_fused_fwd": expected})
    return expected


def phase_checkpoint(card: str) -> None:
    import tempfile

    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample

    print("== phase 6: DiffMa-L/2 from a reference-format checkpoint, sampler CLI on "
          "configs/brain.yaml, 1 batch", flush=True)
    model = build_model("DiffMa-L/2", input_size=28)
    model = random_(model.init_weights(torch.Generator().manual_seed(16)), 16, scale=0.3)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)
        reset_counts()
        t0 = time.perf_counter()
        results = sample.cli([
            "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--ckpt", path,
            "--num-batches", "1",
        ])
        seconds = time.perf_counter() - t0
        check_counts("the checkpoint sampler", {name: 0 for name in kernel_counters()}
                     | {"mixer_fused_fwd": 16 * 250})  # blocks x steps
        loaded = sample.load_model(brain_config(ckpt=path), "cuda")
    written = model.state_dict()
    for key, value in loaded.state_dict().items():
        if not torch.equal(value.cpu(), written[key]):
            fail(f"the sampler's model does not hold the checkpoint's {key}")
    print(f"  loaded {len(written)} tensors of {loaded.depth}-block "
          f"{brain_config().model}, equal to the written ones")
    img = results[0]["images"]
    if len(results) != 1 or img.shape != (1, 3, 224, 224) or not math.isfinite(float(abs(img).max())):
        fail(f"expected one batch of finite (1, 3, 224, 224) images, got {img.shape}")
    print(f"  [{card}] batch 1: {results[0]['seconds']:.3f} s ({seconds:.3f} s with loading)")


def trainer_log_rate(exp_dir: str) -> tuple[float, float]:
    """The last (steps/s, images/s) the trainer logged in ``exp_dir``."""
    with open(os.path.join(exp_dir, "log_0.txt")) as f:
        found = re.findall(r"Train Steps/Sec: ([0-9.]+), Images/Sec: ([0-9.]+)", f.read())
    if not found:
        fail(f"the trainer logged no throughput in {exp_dir}")
    return float(found[-1][0]), float(found[-1][1])


def moved_from_init(module, init_state: dict) -> int:
    """How many of ``module``'s parameters still equal their init."""
    import torch

    state = module.state_dict()
    return sum(torch.equal(state[k].cpu(), v) for k, v in init_state.items())


def phase_trainer(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample, train

    print("== phase 7: trainer CLI on configs/brain.yaml (DiffMa-L/2, batch 8, synthetic), "
          "20 steps, checkpoint at step 20", flush=True)
    cfg = brain_config()
    if "scan_impl" in cfg:
        fail("configs/brain.yaml sets scan_impl; this phase trains with the default")
    results = os.path.join(ROOT, "results", "chip_smoke_train")
    shutil.rmtree(results, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    state = train.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--max-steps", "20",
        "--ckpt-every", "20", "--results-dir", results,
    ])
    seconds = time.perf_counter() - t0
    zero = {name: 0 for name in kernel_counters()}
    calls = 16 * 20  # blocks x steps: one C and one D call per block and step
    counts = check_counts("the trainer", {**zero, "mixer_fused_fwd": calls,
                                          "mixer_fused_bwd": calls})
    if state.step != 20:
        fail(f"the trainer counted {state.step} finite steps of 20")
    init = build_model(cfg.model, input_size=28).init_weights(
        torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
    for what, module in (("params", state.model), ("EMA", state.ema)):
        still = moved_from_init(module, init)
        if still:
            fail(f"{still} tensors of the {what} did not move in 20 steps")
    (exp,) = os.listdir(results)
    ckpt = os.path.join(results, exp, "checkpoints", "0000020.pt")
    if not os.path.exists(ckpt):
        fail(f"the trainer wrote no checkpoint at {ckpt}")
    loaded = sample.load_model(brain_config(ckpt=ckpt), "cuda")
    ema = state.ema.state_dict()
    for key, value in loaded.state_dict().items():
        if not torch.equal(value, ema[key]):
            fail(f"the sampler's model does not hold the checkpoint's EMA {key}")
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  20 steps, every loss finite; params and EMA moved; checkpoint "
          f"{os.path.getsize(ckpt) / 2**20:.0f} MiB read back by the sampler, EMA equal")
    print(f"  [{card}] DiffMa-L/2 fused training, batch 8, steps 11-20: {steps_s} steps/s, "
          f"{images_s} images/s ({seconds:.1f} s for the whole CLI run, build and init included)")
    shutil.rmtree(results, ignore_errors=True)
    return counts


def phase_composable_trainer(card: str) -> dict:
    from diffma_tpu_torch.train import train

    print("== phase 8: composable trainer (kernels A + B), DiffMa-B/2, batch 8, 5 steps",
          flush=True)
    results = os.path.join(ROOT, "results", "chip_smoke_train_composable")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(model="DiffMa-B/2", scan_impl="pallas", max_steps=5, log_every=5,
                       ckpt_every=10**9, results_dir=results)
    reset_counts()
    state = train.main(cfg, device="cuda")
    zero = {name: 0 for name in kernel_counters()}
    calls = 2 * 8 * 5  # mixers x blocks x steps
    counts = check_counts("the composable trainer", {**zero, "selective_scan_fwd": calls,
                                                     "selective_scan_bwd": calls})
    if state.step != 5:
        fail(f"the composable trainer counted {state.step} finite steps of 5")
    (exp,) = os.listdir(results)
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  [{card}] DiffMa-B/2 composable training, batch 8, steps 1-5 (first step "
          f"included): {steps_s} steps/s, {images_s} images/s")
    shutil.rmtree(results, ignore_errors=True)
    return counts


def phase_learning(card: str, phase: int, use_mamba2: bool) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train

    steps = 100
    family = "Mamba-2 (use_mamba2) " if use_mamba2 else ""
    print(f"== phase {phase}: does it learn: DiffMa-B/2 {family}fused, one fixed batch of 8, "
          f"lr 1e-3, {steps} steps", flush=True)
    results = os.path.join(ROOT, "results", f"chip_smoke_overfit_{phase}")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(model="DiffMa-B/2", overfit_fixed_batch=True, lr=1e-3, max_steps=steps,
                       log_every=10, ckpt_every=10**9, results_dir=results,
                       use_mamba2=use_mamba2)
    seed = int(cfg.global_seed)
    # The trainer's fixed batch, and one fixed (t, noise) to evaluate at.
    batch = train.synthetic_batch(torch.Generator(device="cuda").manual_seed(seed + 1), 8, 28,
                                  196)
    t = torch.randint(0, 1000, (8,), generator=torch.Generator().manual_seed(7)).cuda()
    noise = torch.randn(8, 4, 28, 28, generator=torch.Generator().manual_seed(8)).cuda()
    diffusion = create_diffusion("", device="cuda")

    def mse(model) -> float:
        with torch.no_grad():
            terms = diffusion.training_losses(
                model, batch["z"], t, noise=noise,
                model_kwargs={"y": batch["y"], "y2": batch["y2"], "w": batch["w"]})
        return terms["mse"].mean().item()

    init = build_model("DiffMa-B/2", input_size=28, scan_impl="fused", use_mamba2=use_mamba2)
    before = mse(init.init_weights(torch.Generator().manual_seed(seed)).cuda().eval())
    state = train.main(cfg, device="cuda")
    after = mse(state.model.eval())
    (exp,) = os.listdir(results)
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  MSE term at the fixed (t, noise): {before:.5f} before, {after:.5f} after "
          f"{steps} steps: fell {before / after:.2f}x (at least 2x required)")
    print(f"  [{card}] DiffMa-B/2 {family}fused training, batch 8, steps {steps - 9}-{steps}: "
          f"{steps_s} steps/s, {images_s} images/s")
    if state.step != steps or not after * 2 <= before:
        fail(f"the MSE term fell {before / after:.2f}x in {steps} steps, not 2x")
    shutil.rmtree(results, ignore_errors=True)


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
    scan = phase_kernels(card)
    mixer = phase_fused_mixer(card)
    scan_bwd = phase_scan_bwd(card)
    mixer_bwd = phase_mixer_bwd(card)
    ssd = phase_fused_ssd(card)
    epilogue = phase_spiral_epilogue(card)
    ssd_bwd = phase_ssd_bwd(card)
    inner = phase_mamba_inner(card)
    mixer["branches"] = phase_mixer_families(card)
    ssd["branches"] = phase_ssd_partition(card)
    phase_forward(card)
    phase_train_step(card)
    phase_mamba2_forward(card)
    phase_mamba2_train_step(card)
    inner["launches"] = phase_inner_path(card)
    phase_family_forwards(card)
    scan["launches"] = phase_sampler(card)
    mixer["launches"] = phase_fused_sampler(card)
    phase_checkpoint(card)
    mixer_bwd["launches"] = phase_trainer(card)["mixer_fused_bwd"]
    scan_bwd["launches"] = phase_composable_trainer(card)["selective_scan_bwd"]
    phase_learning(card, 9, use_mamba2=False)
    counts = phase_mamba2_samplers(card)
    ssd["launches"], epilogue["launches"] = counts["ssd_mixer_fwd"], counts["spiral_epilogue"]
    ssd_bwd["launches"] = phase_mamba2_trainer(card)["ssd_mixer_bwd"]
    phase_learning(card, 13, use_mamba2=True)
    phase_family_samplers(card)
    phase_family_trainers(card)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [scan, mixer, scan_bwd, mixer_bwd, ssd, epilogue, ssd_bwd,
                                  inner]}))
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
