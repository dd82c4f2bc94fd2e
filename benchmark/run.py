"""Run one cell of the benchmark of the PyTorch and CUDA port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic; the traffic's ``driver`` (``benchmark/drivers/``)
sets the port up from the seed, warms up, measures for ``--seconds``, and
compares what the window produced with the plain reference
(``benchmark/reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each read
by ``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which the last lines of standard error repeat.

A run without as many CUDA cards as the cell asks for, or one whose process
holds JAX or the JAX package after the window, exits with a non-zero code
and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import card  # noqa: E402
from benchmark.harness.cell import load_cell, load_reader  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    opts.toy, opts.control = False, False
    return opts


def _metric(value, unit):
    return {"value": value, "unit": unit}


def measure(opts, overrides=None, t_start=None) -> dict:
    """The cell's outcome and its result line as a dict. ``overrides`` (the
    benchmark's own tests, with ``opts.toy``) resizes it for the CPU."""
    t_start = T_START if t_start is None else t_start
    cell = load_cell(opts.workload, overrides=overrides)
    if not opts.toy:
        card.require_cards(cell.chips)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, opts, t_start)
    if opts.trace:
        metrics = {}
        ctx = dict(out["layer"], config=cell.config, cell=cell.name, card=not opts.toy)
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        metrics = {m["name"]: _metric(out["end_to_end"][m["name"]], m["unit"])
                   for m in cell.end_to_end}
    import torch

    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if not opts.toy:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": all(c.ok for c in out["checks"]) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    trace = out["trace"]
    if opts.trace and trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = {"device_ops": [list(kv) for kv in trace.top_ops],
                             "idle_gaps": [list(kv) for kv in trace.idle_gaps]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out["checks"]}
    return {"line": line, "outcome": out, "cell": cell}


def main(argv=None) -> int:
    opts = parse(argv)
    try:
        result = measure(opts)
    except card.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = card.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window: the port or the "
              f"harness loaded JAX or the JAX package", file=sys.stderr)
        return 3
    line = result["line"]
    print(f"card: {card.card_line()}", file=sys.stderr)
    for note in result["outcome"]["notes"]:
        print(note, file=sys.stderr)
    for c in result["outcome"]["checks"]:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
