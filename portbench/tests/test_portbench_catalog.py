"""Configurations, traffic, operations, generators and metrics are found by
their names, and unknown or malformed names are refused."""

from __future__ import annotations

import copy
import json
import re

import pytest

from portbench import harness

from .conftest import bench

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    spec = harness.find_cell(cell)
    harness.load("gen", spec.config["generator"])
    harness.load("ops", spec.traffic["operation"])
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s", "compress_mbases_s"}
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load("metrics", m["name"]).read)


def test_metrics_follow_their_cells():
    """A metric with a ``workloads`` key reaches the cells it lists only."""
    create = harness.find_cell("hpp-chr21x10.create")
    assert len(create.per_layer) == len(BENCH["per_layer"])
    assert "archive_ratio" in {m["name"] for m in create.end_to_end}
    for name in ("hpp-chr21x10.append", "sars-cov-2-1k.create"):
        later = harness.find_cell(name, bench())
        assert later.per_layer == []
        assert {m["name"] for m in later.end_to_end} == {"compress_mbases_s", "setup_s"}
        harness.load("ops", later.traffic["operation"])
        harness.load("gen", later.config["generator"])


@pytest.mark.parametrize("kind,name", [
    ("gen", "nosuch"), ("ops", "nosuch"), ("metrics", "nosuch"),
    ("gen", "../harness"), ("metrics", "a/b"), ("ops", ""),
])
def test_unknown_names_refused(kind, name):
    with pytest.raises(LookupError):
        harness.load(kind, name)


def test_unknown_cell_and_traffic_refused():
    with pytest.raises(LookupError):
        harness.find_cell("hpp-chr21x10.nosuch")
    bench = copy.deepcopy(BENCH)
    bench["workloads"][0]["traffic"] = "nosuch"
    with pytest.raises(LookupError):
        harness.find_cell(bench["workloads"][0]["name"], bench)


def test_benchmark_file_keeps_to_its_form():
    """Keys, names, units and lengths as the benchmark's contract has them."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and all(name.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert set(c["reduced"]) == set(harness.read_json(harness.ROOT / c["file"])["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
