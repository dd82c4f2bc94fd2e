"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--seconds 3]

For each seed, in one process: a run of the cell with a short window, the
numbers that decide ``correct`` for the program (the lower readings), and
the control's: the reference in TF32, the precision below the
configuration's fp32, put in the program's place; for a training cell also
a planted fault, half of each batch left out and the mean taken over the
rest. A step that returns its state unchanged reads 1 on ``change_gap`` by
construction and needs no run. Prints one JSON line per seed and, last, the
largest program reading and the smallest control and fault readings of each
number; ``--out`` writes the lines to a file too. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402
from benchmark.harness.checks import leaf_gaps, moving_leaves  # noqa: E402


def leaves(readings: dict) -> dict:
    """For each compared norm and each of the program, the control and the
    fault: the worst leaf with its gap, its size and its reference norm, and
    the median leaf's gap (the look behind a training number)."""
    ref = readings["reference"]
    out = {}
    for kind in ("program", "tf32", "half_batch"):
        got = readings[kind]
        for key in ("grad", "change", "ema_change"):
            gaps = dict(zip(ref[key], leaf_gaps(got[key], ref[key], list(ref[key]))))
            worst = max(gaps, key=gaps.get)
            out[f"{kind}.{key}"] = {"worst": worst, "gap": gaps[worst], "ref": ref[key][worst],
                                    "median_leaf_gap": statistics.median(gaps.values())}
    out["excluded_leaves"] = len(ref["grad"]) - len(moving_leaves(ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        opts = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                  trace=0, toy=False, control=True)
        t0 = time.perf_counter()
        result = run.measure(opts, t_start=t0)
        out = result["outcome"]
        line = {"seed": seed, "correct": result["line"]["correct"], "program": out["values"],
                "control": out["control"], "seconds": time.perf_counter() - t0}
        if "readings" in out:
            line["leaves"] = leaves(out["readings"])
        lines.append(line)
        print(json.dumps(line), flush=True)
    numbers = list(lines[0]["program"])
    summary = {"program_max": {k: max(ln["program"][k] for ln in lines) for k in numbers}}
    for kind in lines[0]["control"]:
        summary[f"{kind}_min"] = {k: min(ln["control"][kind][k] for ln in lines)
                                  for k in numbers}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
