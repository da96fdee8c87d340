"""``BENCHMARK.json`` holds to the benchmark's contract, and every cell's
files are found by the names it gives."""

from __future__ import annotations

import json
import math
import re

import pytest

from portbench import bench
from portbench.bench import HERE, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time():
    # 24 cells at this run length, as later PRs may add
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in SPEC["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    # its reader is a file of its own, found by the metric's name
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert callable(bench.load_module("metrics", metric["name"]).read)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = bench.load_cell(name)
    entry = {c["name"]: c for c in SPEC["configs"]}[cell.config_name]
    assert entry["file"].startswith("portbench/configs/")
    assert cell.config["name"] == cell.config_name
    assert cell.config["reduced"] == entry["reduced"]
    assert (HERE / "traffic" / f"{cell.traffic_name}.json").is_file()
    assert (HERE / "workloads" / f"{cell.mix['kind']}.py").is_file()
    assert callable(bench.workload_module(cell.mix["kind"]).make)
    assert cell.limits and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    if "family" in cell.config:
        family, ref = bench.family_modules(cell.config["family"])
        assert callable(family.load_program) and callable(ref.make_weights)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_its_metrics(name):
    cell = bench.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_four_chip_cells_are_few():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_every_config_is_used_and_files_distinct():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_named_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "device" in layers and len(layers["device"]) == 2


def test_files_under_paths_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
