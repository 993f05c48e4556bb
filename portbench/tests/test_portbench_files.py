"""Every cell, configuration, mix and metric of BENCHMARK.json resolves to
its files by name, and the file keeps to the benchmark's limits."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.Cell(REPO, cell)
    assert c.config["name"] == c.spec["config"]
    assert hasattr(c.job_module, "Job")
    assert c.limits is not None and c.limits["limits"], f"limits/{cell}.json"
    assert (REPO / "portbench" / "families" / f"{c.config['family']}.py").exists()
    assert c.spec["chips"] in (1, 4)
    assert any(m["name"] != "setup_s" for m in c.end_to_end())
    assert any(m["name"] == "setup_s" for m in c.end_to_end())
    assert c.per_layer()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    cell = next(w["name"] for w in BENCH["workloads"])
    assert callable(harness.Cell(REPO, cell).reader(metric).read)


@pytest.mark.parametrize("entry", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(entry):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    for w in entry.get("workloads", []):
        assert w in CELLS
    if entry in BENCH["per_layer"]:
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        moved = e2e[entry["moves"]]
        # each listed cell reports the end-to-end metric it moves
        assert set(entry["workloads"]) <= set(moved.get("workloads", CELLS))
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"],
                         ids=[e["name"] for e in BENCH["configs"] + BENCH["workloads"]])
def test_names_and_whys(entry):
    assert NAME.match(entry["name"])
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    if "file" in entry:
        assert entry["file"].startswith("portbench/")
        assert json.loads((REPO / entry["file"]).read_text())["name"] == entry["name"]
