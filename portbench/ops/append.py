"""Appends back to back: set-up creates the archive of the reference and
every sample; each operation appends the further samples to it, writing a
new archive, through the program's ``append_archive``. The splitters come
from the archive, so no discovery runs."""

from __future__ import annotations

import os


def extra_samples(traffic: dict) -> int:
    return traffic["append_samples"]


def setup(cell) -> None:
    base = os.path.join(cell.workdir, "base.agc")
    files = [cell.inputs.reference, *cell.inputs.samples]
    cell.program.create_archive(base, [s.path for s in files], cell.params(),
                                device=cell.device)
    cell.state["base"] = base
    # one append, so the window's first append finds its paths warm
    cell.program.append_archive(base, os.path.join(cell.workdir, "warmup.agc"),
                                [s.path for s in cell.inputs.extra], cell.params(),
                                device=cell.device)


def run(cell, i: int) -> dict:
    base = cell.state["base"]
    out = os.path.join(cell.workdir, f"append{i}.agc")
    cell.program.append_archive(base, out, [s.path for s in cell.inputs.extra],
                                cell.params(), device=cell.device)
    added = sum(s.symbols for s in cell.inputs.extra)
    return {"path": out,
            "expected": [cell.inputs.reference, *cell.inputs.samples, *cell.inputs.extra],
            "symbols": added, "bytes": os.path.getsize(out) - os.path.getsize(base),
            "timers": None, "discovery": False, "sample_bases": added}
