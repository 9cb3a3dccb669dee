"""Shared pieces of the benchmark's tests: tiny cells on the CPU.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
Tests that need a CUDA card carry the ``card`` marker and skip inside the
``card`` fixture when there is none.
"""

from __future__ import annotations

import pytest

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


# cells measured and left out of BENCHMARK.json (PERF.md §6-§7), kept so
# that their configurations, generators and drivers stay tested
LATER = {"sars-cov-2-1k.create": ("sars-cov-2-1k", "create"),
         "hpp-chr21x10.append": ("hpp-chr21x10", "append")}


def bench() -> dict:
    """BENCHMARK.json, with the cells that PERF.md keeps for later added."""
    b = harness.read_json(harness.ROOT / "BENCHMARK.json")
    known = {c["name"] for c in b["configs"]}
    for name, (config, traffic) in LATER.items():
        if config not in known:
            known.add(config)
            b["configs"].append({"name": config, "file": f"portbench/configs/{config}.json"})
        b["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "kept for later"})
    return b


def tiny(name: str) -> harness.Spec:
    """A cell cut to a size the CPU runs in seconds."""
    spec = harness.find_cell(name, bench())
    g = spec.config["generator_params"]
    if spec.config["generator"] == "hpp":
        g["reference"].update(length=600_000, leading_n=50_000)
        g.update(haplotypes=3, min_contig=20_000, sv_every=60_000)
        spec.config["params"]["segment_size"] = 20_000
    else:
        g.update(genomes=60, warmup_genomes=10)
    return spec


@pytest.fixture
def tiny_cell():
    return tiny
