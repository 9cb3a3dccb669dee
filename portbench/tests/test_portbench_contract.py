"""The result line's form, the check for JAX and agc_tpu by whole
top-level names, and the runs that must end without a result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness

from .conftest import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys():
    r = harness.run_cell(tiny("sars-cov-2-1k.create"), 5, 1, False, device="cpu")
    assert list(r)[: len(KEYS)] == KEYS and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"compress_mbases_s", "setup_s"}  # no archive_ratio under -c -a
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_result_on_the_cpu_names_no_device_metric():
    """Without a card the trace holds no device activity: the device's
    readers read nothing, and the stage timers' metrics are there."""
    r = harness.run_cell(tiny("hpp-chr21x10.create"), 6, 1, True, device="cpu")
    assert "kernel_roofline_pct" not in r["metrics"]
    assert "device_idle_pct" not in r["metrics"]
    assert {"discovery_s_per_gbase", "match_s_per_gbase", "store_s_per_gbase"} <= set(r["metrics"])
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "agc_tpu_torch.x", types.ModuleType("agc_tpu_torch.x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "agc_tpu.x", types.ModuleType("agc_tpu.x"))
    assert harness.forbidden_modules() == ["agc_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["agc_tpu", "jax"]


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpp-chr21x10.create",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    p = _run(harness.ROOT)
    if torch.cuda.is_available():
        return  # the card's own runs are the benchmark's
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_workload_no_result():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nosuch", "--seed", "1",
         "--seconds", "1"], cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_tiny_cells_on_the_card(card):
    for name in ("hpp-chr21x10.create", "sars-cov-2-1k.create", "hpp-chr21x10.append"):
        r = harness.run_cell(tiny(name), 8, 1, True, device=card)
        assert r["correct"] and r["device"]["platform"] == "gpu"
        assert r["device"]["busy_s"] > 0
