#!/usr/bin/env python3
"""Time kernels A, B and H (the Mamba-1 scan, its backward and the mixer's inner part), C,
D, E and F (the fused Mamba-1 and Mamba-2 mixers' forward and backward), G (the
Spiral block's tail) and P (the split SSD probe's core) of a
checkout of the PyTorch port, per call and per stage, the batch-1 DiffMa-B/2
sampler forwards (Mamba-2 and the composable Mamba-1 route) and the training
steps that run them.

Run it once per checkout, each in a process of its own (both packages have
the same name), in turns on one card so that two versions meet the same
clocks, and print the runs side by side:

    python tools/port_mixer_times.py run --root path/to/parent --out p1.json
    python tools/port_mixer_times.py run --root . --out c1.json
    python tools/port_mixer_times.py run --root . --out c2.json
    python tools/port_mixer_times.py run --root path/to/parent --out p2.json
    python tools/port_mixer_times.py table p1.json c1.json c2.json p2.json

``run`` times each case with CUDA events (the median over 5 windows of the
mean over back-to-back calls), takes the device ms per call by stage from
torch.profiler's kernel table (the stage names of ``chip_smoke.py``; for E
and F also each SSD kernel's), profiles the DiffMa-B/2 forward at batch 1
(``chip_smoke.py`` phase 3c's model and inputs: CUDA-event ms, wall and device
busy ms, launches) on Mamba-2's dual and ``fuse_block`` routes and on
Mamba-1's composable route (kernel A, ``scan_impl="auto"``), and profiles the
trainer's step on DiffMa-L/2 and DiffMa-B/2 at batch 8, fused Mamba-1 and
Mamba-2, and B/2 on the composable route (kernels A and B)
(``diffma_tpu_torch.utils.profiling.profile_train_step``). G runs at batch 1
and 8 on ``chip_smoke.epilogue_inputs``, P on the split probe's zx (48, 196,
2096), each with its device kernels per call. ``--kernels A,H``
times only those kernels' cases, ``--steps-of "B/2 auto"`` only the steps
whose names hold those words. Every case uses entry points that both
checkouts have; a case that a checkout refuses (a stream past its kernel's
length cap) is recorded as refused. It needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The stage kernels of earlier versions of A, C, D, E, F, G, H and P (before
# gemm_tc.cuh, the chunked scans and P's own kernels), under chip_smoke.py's
# labels, so that an older checkout's calls split the same way.
OLD_STAGE_NAMES = {"conv + x_proj": "ConvXProj", "merge + out_proj": "MergeOutProj|QuirkOutProj",
                   "ssd": "ssd_fwd_kernel", "recompute y": "ssd_fwd_kernel",
                   "scan": "selective_scan_fwd_kernel", "LayerNorm": "stats_kernel",
                   "fc1 + SiLU + fc2 partials": "gemm_nt", "chunk states": "ssd_state_kernel",
                   "y + gate + norm": "ssd_out_kernel|gate_norm_merge"}


def with_old_names(stages):
    return tuple((label, f"{pattern}|{OLD_STAGE_NAMES[label]}" if label in OLD_STAGE_NAMES
                  else pattern) for label, pattern in stages)


# Each SSD kernel of E and F on its own, the whole-stream versions' too.
SSD_KERNELS = (("state", r"ssd_state_kernel"), ("out", r"ssd_out_kernel"),
               ("whole stream (old)", r"ssd_fwd_kernel"), ("a_c", r"ssd_chunk_adj"),
               ("adjoint", r"ssd_adjoint_kernel"), ("adjoint finish", r"ssd_adjoint_finish"))

# (name, kernel, streams G, steps L) of kernels A (G = 3: the sampler at batch
# 1; 24: the composable training step at batch 8), B (that step's backward)
# and H (8 atrous streams of 49 steps: chip_smoke.py phase 3e's path; the B/2
# streams at batch 1 and 8)
SCAN_CASES = (
    ("A G=3 L=196", "A", 3, 196),
    ("A G=24 L=196", "A", 24, 196),
    ("B G=24 L=196", "B", 24, 196),
    ("H G=8 L=49", "H", 8, 49),
    ("H G=3 L=196", "H", 3, 196),
    ("H G=24 L=196", "H", 24, 196),
)
# (name, kernel, batch) of kernels G (the sampler's batch 1, the fuse_block
# training forward's 8) and P (the split probe at batch 8)
TAIL_CORE_CASES = (("G B=1", "G", 1), ("G B=8", "G", 8), ("P zx (48, 196, 2096)", "P", 8))
# (name, kernel, family, batch, branches[, grid]): the main path's cases first;
# the grid is 14 (196 tokens) unless given
CASES = (
    ("C spiral B=1 dual", "C", "spiral", 1, 2),
    ("C spiral B=8 dual", "C", "spiral", 8, 2),
    ("C vim B=1", "C", "vim", 1, 1),
    ("C partition B=1", "C", "efficientVMamba", 1, 1),
    ("C zig B=1", "C", "zig", 1, 1),
    ("C vmamba B=1", "C", "vmamba", 1, 1),
    ("D spiral B=8 dual", "D", "spiral", 8, 2),
    ("D vim B=8", "D", "vim", 8, 1),
    ("D partition B=8", "D", "efficientVMamba", 8, 1),
    ("E spiral B=1 dual", "E", "spiral", 1, 2),
    ("E spiral B=8 dual", "E", "spiral", 8, 2),
    ("E partition B=1", "E", "efficientVMamba", 1, 1),
    ("F spiral B=8 dual", "F", "spiral", 8, 2),
    ("F partition B=8 dual", "F", "efficientVMamba", 8, 2),
    ("F spiral L=256 B=8 dual", "F", "spiral", 8, 2, 16),
    ("E spiral L=1024 B=1 dual", "E", "spiral", 1, 2, 32),
    ("F spiral L=1024 B=1 dual", "F", "spiral", 1, 2, 32),
)
# (name, use_mamba2, scan_impl, fuse_block)
FORWARDS = (("B/2 Mamba-2 forward B=1, dual", True, "fused", False),
            ("B/2 Mamba-2 forward B=1, fuse_block", True, "fused", True),
            ("B/2 Mamba-1 forward B=1, composable", False, "auto", False))
STAGES = {"A": "SCAN_STAGES", "B": "SCAN_BWD_STAGES", "H": "INNER_STAGES", "C": "MIXER_STAGES", "D": "MIXER_BWD_STAGES",
          "E": "SSD_STAGES", "F": "SSD_BWD_STAGES", "G": "EPILOGUE_STAGES", "P": "CORE_STAGES"}
# (model, use_mamba2, scan_impl)
STEPS = (("DiffMa-L/2", False, "fused"), ("DiffMa-B/2", False, "fused"),
         ("DiffMa-L/2", True, "fused"), ("DiffMa-B/2", True, "fused"),
         ("DiffMa-B/2", False, "auto"))


def run(root: str, out: str, steps: bool, kernels: str, steps_of: str = "") -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # helpers only; its functions import the package lazily

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec
    from diffma_tpu_torch.utils.profiling import profile_denoiser

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = 512
    report = {"root": os.path.abspath(root), "card": cs.card_line(), "cases": {}}
    for name, kernel, G, L in SCAN_CASES:
        if kernel in kernels:
            report["cases"][name] = time_scan_case(cs, kernel, G, L)
            print(f"{name}: {report['cases'][name]['ms']:.4f} ms; "
                  f"{cs.stage_line(report['cases'][name]['stages_ms'])}", flush=True)
    for name, kernel, batch in TAIL_CORE_CASES:
        if kernel not in kernels:
            continue
        report["cases"][name] = time_tail_core_case(cs, kernel, batch)
        print(f"{name}: {report['cases'][name]['ms']:.4f} ms; "
              f"{cs.stage_line(report['cases'][name]['stages_ms'])}", flush=True)
    for name, kernel, family, batch, M, *grid in CASES:
        if kernel not in kernels:
            continue
        grid_n = grid[0] if grid else 14
        spec = build_scan_spec(family, grid_n, 1)
        module = Mamba if kernel in "CD" else Mamba2
        mixers = [cs.random_(module(h, spec), 900 + i).cuda() for i in range(M)]
        ws = tuple(m.weights() for m in mixers)
        gen = torch.Generator().manual_seed(900)
        L = grid_n * grid_n
        xs = tuple(torch.randn(batch, L, h, generator=gen).cuda() for _ in range(M))
        gs = tuple(torch.randn(batch, L, h, generator=gen).cuda() for _ in range(M))
        try:
            report["cases"][name] = time_case(cs, kernel, spec, xs, gs, ws, batch)
        except ValueError as e:  # the kernel's wrapper refuses the shape
            report["cases"][name] = {"refused": str(e)}
            print(f"{name}: refused: {e}", flush=True)
            continue
        print(f"{name}: {report['cases'][name]['ms']:.4f} ms; "
              f"{cs.stage_line(report['cases'][name]['stages_ms'])}", flush=True)
    report["forwards"] = {}
    inputs = cs.sampler_forward_inputs()
    for name, mamba2, scan_impl, fuse in FORWARDS:
        model = cs.sampler_model(mamba2).set_scan_impl(scan_impl)
        for blk in model.blocks:
            blk.fuse_block = fuse
        with torch.no_grad():
            fwd = profile_denoiser(model, inputs, calls=20)
            fwd["event_ms"] = cs.cuda_ms(lambda: model(*inputs), reps=20)
        fwd.pop("top_kernels_ms_per_call")
        report["forwards"][name] = fwd
        print(f"{name}: {json.dumps(fwd)}", flush=True)
        del model
    if steps:
        from diffma_tpu_torch.utils.profiling import profile_train_step

        report["steps"] = {}
        for model_name, mamba2, scan_impl in STEPS:
            key = model_name + (" Mamba-2" if mamba2 else "") + (
                f" {scan_impl}" if scan_impl != "fused" else "")
            if steps_of and not any(w in key for w in steps_of.split(",")):
                continue
            step = profile_train_step(model_name, 8, scan_impl, use_mamba2=mamba2)
            report["steps"][key] = step
            print(f"{key} train step, batch 8: {json.dumps(step)}", flush=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)


def time_scan_case(cs, kernel, G, L) -> dict:
    """Kernel A's, B's or H's ms per call (CUDA events) and device ms per
    stage at DiffMa's width, on chip_smoke.py's inputs."""
    import torch

    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_cuda, selective_scan_cuda

    if kernel in "AB":
        x = cs.scan_inputs(G, L, 1024, 16, torch.float32, torch.float32, seed=0)
        g = torch.randn(G, L, 1024, generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        if kernel == "A":
            fn = lambda: selective_scan_cuda(**x)  # noqa: E731
        else:
            fn = lambda: selective_scan_bwd_cuda(**x, g=g)  # noqa: E731
    else:
        args = cs.inner_inputs(G, L, seed=400 + G)
        fn = lambda: mamba_inner_fused_cuda(*args)  # noqa: E731
    with torch.no_grad():
        return {"ms": cs.cuda_ms(fn, reps=50),
                "stages_ms": cs.stage_table(fn, with_old_names(getattr(cs, STAGES[kernel])))}


def time_tail_core_case(cs, kernel, batch) -> dict:
    """Kernel G's or P's ms per call (CUDA events) and device ms per stage."""
    import torch

    from diffma_tpu_torch.ops.fused_ssd import spiral_epilogue_cuda, ssd_core_cuda
    from diffma_tpu_torch.utils.profiling import profile_calls

    with torch.no_grad():
        if kernel == "G":
            tail = cs.epilogue_inputs(batch)
            fn = lambda: spiral_epilogue_cuda(*tail)  # noqa: E731
        else:
            probe = cs.load_split_probe()
            x12, ws = probe.inputs(batch, seed=batch, device="cuda")
            zxs = probe.gathered_streams(x12, ws)
            fn = lambda: ssd_core_cuda(zxs, ws)  # noqa: E731
        fn()
        stages = with_old_names(getattr(cs, STAGES[kernel]))
        return {"ms": cs.cuda_ms(fn, reps=50), "stages_ms": cs.stage_table(fn, stages, calls=50),
                "kernels_per_call": profile_calls(fn, calls=20)["kernels_per_call"]}


def time_case(cs, kernel, spec, xs, gs, ws, batch) -> dict:
    """One kernel case's ms per call (CUDA events) and device ms per stage
    (and, for E and F, per SSD kernel)."""
    import torch

    from diffma_tpu_torch.ops import fused_mixer, fused_ssd

    with torch.no_grad():
        if kernel == "C":
            fn = lambda: fused_mixer.mixer_fused_cuda(spec, xs, ws)  # noqa: E731
        elif kernel == "D":
            fn = lambda: fused_mixer.mixer_fused_bwd_cuda(spec, xs, gs, ws)  # noqa: E731
        elif kernel == "E":
            fn = lambda: fused_ssd.ssd_mixer_fused_cuda(spec, xs, ws)  # noqa: E731
        else:
            _, zx = fused_ssd.ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
            fn = lambda: fused_ssd.ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx)  # noqa: E731
        stages = with_old_names(getattr(cs, STAGES[kernel]))
        case = {"ms": cs.cuda_ms(fn, reps=50 if batch == 1 else 20),
                "stages_ms": cs.stage_table(fn, stages)}
        if kernel in "EF":
            case["ssd_kernels_ms"] = cs.stage_table(fn, SSD_KERNELS)
    return case


def table(paths) -> None:
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    heads = [os.path.basename(p) for p in paths]
    print(f"card: {runs[0]['card']}")
    print("| case | " + " | ".join(heads) + " |")
    print("| --- |" + " --- |" * len(runs))
    for name in runs[0]["cases"]:
        cases = [r["cases"][name] for r in runs]
        print(f"| {name} | " + " | ".join(f"{c['ms']:.4f}" if "ms" in c else "refused"
                                          for c in cases) + " |")
        if any("kernels_per_call" in c for c in cases):
            print("| &nbsp; kernels per call | " + " | ".join(
                json.dumps(c.get("kernels_per_call")) for c in cases) + " |")
        for key, prefix in (("stages_ms", ""), ("ssd_kernels_ms", "SSD kernel ")):
            tables = [c.get(key, {}) for c in cases]
            labels = [k for t in tables for k in t if k not in ("other", "total")]
            labels = list(dict.fromkeys(labels)) + ([] if prefix else ["other", "total"])
            for label in labels:
                vals = [t.get(label, 0.0) for t in tables]
                if any(v > 0 for v in vals):
                    print(f"| &nbsp; {prefix}{label} | " + " | ".join(f"{v:.4f}" for v in vals)
                          + " |")
    for name in runs[0].get("forwards", {}):
        for key in ("event_ms", "ms_per_call", "device_busy_ms_per_call", "device_idle_share",
                    "kernels_per_call"):
            vals = [r["forwards"][name][key] for r in runs]
            print(f"| {name} {key} | " + " | ".join(json.dumps(v) for v in vals) + " |")
    for model in runs[0].get("steps", {}):
        for mode in ("eager", "graphed"):  # a checkout before the graphed step has eager only
            for key in ("ms_per_call", "device_busy_ms_per_call", "device_idle_share",
                        "kernels_per_call"):
                vals = [r["steps"][model].get(mode, r["steps"][model] if mode == "eager" else {})
                        .get(key) for r in runs]
                print(f"| {model} {mode} step {key} | " + " | ".join(json.dumps(v) for v in vals)
                      + " |")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", default=".")
    r.add_argument("--out", required=True)
    r.add_argument("--no-steps", dest="steps", action="store_false",
                   help="leave out the training steps")
    r.add_argument("--steps-of", default="",
                   help="only the steps whose names hold one of these comma-separated words, "
                        "e.g. 'B/2 auto'")
    r.add_argument("--kernels", default="ABCDEFGHP",
                   help="the kernels whose cases to time, e.g. A,H (default: all; '' for none)")
    t = sub.add_parser("table")
    t.add_argument("paths", nargs="+")
    args = parser.parse_args()
    if args.command == "run":
        run(args.root, args.out, args.steps, args.kernels, args.steps_of)
    else:
        table(args.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
