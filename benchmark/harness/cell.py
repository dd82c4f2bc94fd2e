"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

* ``BENCHMARK.json`` at the checkout's root: the cell's configuration, traffic
  and chips, and which metrics it reports (a metric's ``workloads``, or every
  cell where it has none).
* ``benchmark/configs/<config>.json`` (the configuration entry's ``file``):
  the model's sizes, dtype and path, with its ``source``, ``reduced`` and
  ``assumed``.
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters; its
  ``driver`` names the generator in ``benchmark/drivers/`` that reads them.
* ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.
* ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_benchmark", "load_cell", "load_reader"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: str = ROOT, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name``; ``overrides`` replaces keys of its configuration
    and traffic (the benchmark's own tests run a cell at toy size so)."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read(os.path.join(root, conf["file"]))
    traffic = _read(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    limits = _read(os.path.join(root, "benchmark", "limits", f"{name}.json"))["limits"]
    for key, value in (overrides or {}).get("config", {}).items():
        config[key] = value
    for key, value in (overrides or {}).get("traffic", {}).items():
        traffic[key] = value
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_reader(metric: str, root: str = ROOT):
    """The module ``benchmark/metrics/<metric>.py`` (its name may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
