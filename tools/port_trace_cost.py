#!/usr/bin/env python3
"""What the port's tracer costs with its records on, on the card.

    python tools/port_trace_cost.py [--steps 100] [--rounds 2] [--seed 1]

Builds the benchmark's cells from the seed (``benchmark/drivers/``: the
DiffMa-L/2 Mamba-1 and Mamba-2 train steps at batch 8 and the DDPM-250
sampling request at batch 1), warms them up, then times in turns, records
off, on, on, off (``utils/trace.py``'s ``records_on``, no profiler), and
``--rounds`` times over: ``--steps`` graphed train steps, and one sampling
request. Each block is timed by CUDA events around it and by the host clock
to a synchronize after it. Prints one JSON object: per cell and setting the
ms per step or per request by each clock, and the records a block left.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, n: int):
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from benchmark.drivers.sample_chain import Sampler
    from benchmark.drivers.train_synthetic import Trainer
    from benchmark.harness.cell import load_cell
    from diffma_tpu_torch.utils import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True).stdout.strip()}
    cells = {"diffma-l2-m1.train-b8": args.steps, "diffma-l2-m2.train-b8": args.steps,
             "diffma-l2-m1.sample-ddpm250-b1": 1}
    for name, n in cells.items():
        cell = load_cell(name)
        if "steps" in cell.traffic:
            runner = Sampler(cell, args.seed, device)
            fn = lambda: runner(keep=False)  # noqa: E731
            for _ in range(2):
                fn()
        else:
            runner = Trainer(cell, args.seed, device)
            fn = runner
            for _ in range(13):
                fn()
        out = {"off": {"device_ms": [], "host_ms": [], "records": []},
               "on": {"device_ms": [], "host_ms": [], "records": []}}
        for _ in range(args.rounds):
            for setting in ("off", "on", "on", "off"):
                trace.tracer.records_on = setting == "on"
                before = len(trace.tracer.records)
                try:
                    dev, host = _timed(fn, n)
                finally:
                    trace.tracer.records_on = None
                out[setting]["device_ms"].append(dev)
                out[setting]["host_ms"].append(host)
                out[setting]["records"].append(len(trace.tracer.records) - before)
        for setting in out.values():
            setting["device_ms_median"] = statistics.median(setting["device_ms"])
            setting["host_ms_median"] = statistics.median(setting["host_ms"])
        report[name] = out
        del runner, fn
        torch.cuda.empty_cache()
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
