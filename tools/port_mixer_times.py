#!/usr/bin/env python3
"""Time kernels C and D (the fused Mamba-1 mixer's forward and backward) of a
checkout of the PyTorch port, per call and per stage, and the Mamba-1
training steps that run them.

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
torch.profiler's kernel table (the stage names of ``chip_smoke.py``), and
profiles the trainer's step on DiffMa-L/2 and DiffMa-B/2 at batch 8
(``diffma_tpu_torch.utils.profiling.profile_train_step``). Every case uses
entry points that both checkouts have. It needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The stage classes of kernel C's and D's versions before gemm_tc.cuh, under
# chip_smoke.py's labels, so that an older checkout's calls split the same way.
OLD_STAGE_NAMES = {"conv + x_proj": "ConvXProj", "merge + out_proj": "MergeOutProj|QuirkOutProj"}


def with_old_names(stages):
    return tuple((label, f"{pattern}|{OLD_STAGE_NAMES[label]}" if label in OLD_STAGE_NAMES
                  else pattern) for label, pattern in stages)


# (name, kernel, family, batch, branches): the main path's cases first
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
)


def run(root: str, out: str, steps: bool) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # helpers only; its functions import the package lazily

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops import fused_mixer
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = 512
    report = {"root": os.path.abspath(root), "card": cs.card_line(), "cases": {}}
    for name, kernel, family, batch, M in CASES:
        spec = build_scan_spec(family, 14, 1)
        mixers = [cs.random_(Mamba(h, spec), 900 + i).cuda() for i in range(M)]
        ws = tuple(m.weights() for m in mixers)
        gen = torch.Generator().manual_seed(900)
        xs = tuple(torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(M))
        gs = tuple(torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(M))
        with torch.no_grad():
            if kernel == "C":
                fn = lambda: fused_mixer.mixer_fused_cuda(spec, xs, ws)  # noqa: E731
                stages = with_old_names(cs.MIXER_STAGES)
            else:
                fn = lambda: fused_mixer.mixer_fused_bwd_cuda(spec, xs, gs, ws)  # noqa: E731
                stages = with_old_names(cs.MIXER_BWD_STAGES)
            ms = cs.cuda_ms(fn, reps=50 if batch == 1 else 20)
            table = cs.stage_table(fn, stages)
        report["cases"][name] = {"ms": ms, "stages_ms": table}
        print(f"{name}: {ms:.4f} ms; {cs.stage_line(table)}", flush=True)
    if steps:
        from diffma_tpu_torch.utils.profiling import profile_train_step

        report["steps"] = {}
        for model in ("DiffMa-L/2", "DiffMa-B/2"):
            step = profile_train_step(model, 8, "fused")
            report["steps"][model] = step
            print(f"{model} train step, batch 8: {json.dumps(step)}", flush=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)


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
        print(f"| {name} | " + " | ".join(f"{r['cases'][name]['ms']:.4f}" for r in runs) + " |")
        labels = [k for k in runs[-1]["cases"][name]["stages_ms"] if k not in ("other", "total")]
        for label in labels + ["other", "total"]:
            vals = [r["cases"][name]["stages_ms"].get(label, 0.0) for r in runs]
            if any(v > 0 for v in vals):
                print(f"| &nbsp; {label} | " + " | ".join(f"{v:.4f}" for v in vals) + " |")
    for model in runs[0].get("steps", {}):
        for key in ("ms_per_call", "device_busy_ms_per_call", "device_idle_share",
                    "kernels_per_call", "ms_per_step_with_loss_check"):
            vals = [r["steps"][model][key] for r in runs]
            print(f"| {model} step {key} | " + " | ".join(json.dumps(v) for v in vals) + " |")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", default=".")
    r.add_argument("--out", required=True)
    r.add_argument("--no-steps", dest="steps", action="store_false",
                   help="time the kernels only, not the training steps")
    t = sub.add_parser("table")
    t.add_argument("paths", nargs="+")
    args = parser.parse_args()
    if args.command == "run":
        run(args.root, args.out, args.steps)
    else:
        table(args.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
