"""BENCHMARK.json against the files the harness finds by its names, and
against the contract's rules on names, keys and sizes."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark()
ALL = harness.entries()  # with the cells held out in benchmark/pending.json
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) < 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"


def test_run_seconds_fit_the_full_check():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("spec", [SPEC, harness.pending()], ids=["benchmark", "pending"])
def test_names_units_and_keys(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == [] and c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist_and_report_enough(name):
    cell = harness.Cell(name)
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                       cell.traffic["driver"] + ".py"))
    assert importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}").Driver
    importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    import meta_learning_pacoh_torch

    assert hasattr(meta_learning_pacoh_torch, cell.config["learner"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(isinstance(v, float) and v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))
    entry = next(m for m in ALL["per_layer"] if m["name"] == metric)
    moved = next(m for m in ALL["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in CELLS and cell in moved.get("workloads", CELLS)


def test_benchmark_json_names_no_pending_entry_and_reads_only_its_own():
    held = harness.pending()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        ours = {e["name"] for e in SPEC[key]}
        assert not ours & {e["name"] for e in held.get(key, [])}, key
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_layers_are_named_in_perf_md():
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in SPEC["per_layer"]}:
        assert layer in perf


@pytest.mark.parametrize("spec", [SPEC, harness.pending()], ids=["benchmark", "pending"])
def test_every_config_is_used_and_its_file_is_json(spec):
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["name"] in used
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
