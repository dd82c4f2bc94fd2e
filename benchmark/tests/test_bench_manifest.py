"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import math
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness.cell import load_cell, load_reader  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section,kind", [("configs", "config"), ("workloads", "workload"),
                                          ("end_to_end", "end_to_end"),
                                          ("per_layer", "per_layer")])
def test_entries_have_only_allowed_keys_and_names(section, kind):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[kind], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("config", "workload", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = load_cell(cell)
    assert c.chips == 1
    assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers",
                                       f"{c.traffic['driver']}.py"))
    for m in c.per_layer:
        assert load_reader(m["name"]).read is not None
    assert set(c.limits) >= {"loss_gap"} or set(c.limits) >= {"step_gap"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer_metric(cell):
    c = load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_declares_what_benchmark_json_says(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    reader = load_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], entry["unit"],
                                                        entry["moves"])


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_source_and_reduced(conf):
    entry = {c["name"]: c for c in BENCH["configs"]}[conf]
    assert entry["file"].startswith("benchmark/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["hidden_size"] == 512 and cfg["depth"] == 16 and cfg["d_state"] == 16
    assert any(w["config"] == conf for w in BENCH["workloads"])


def test_run_seconds_fits_the_check_with_24_cells():
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_limits_are_finite_and_non_negative():
    for cell in CELLS:
        for name, limit in load_cell(cell).limits.items():
            assert math.isfinite(limit) and limit >= 0, (cell, name)
