"""Whole creates back to back: ``agc create`` of the reference and every
sample, through the program's ``create_archive``."""

from __future__ import annotations

import os


def extra_samples(traffic: dict) -> int:
    return 0


def setup(cell) -> None:
    """One create of the reference and the warm-up samples, so the window's
    first create finds every kernel built and every pool started."""
    files = [cell.inputs.reference, *cell.inputs.warmup]
    cell.program.create_archive(os.path.join(cell.workdir, "warmup.agc"),
                                 [s.path for s in files], cell.params(),
                                 device=cell.device)


def run(cell, i: int) -> dict:
    files = [cell.inputs.reference, *cell.inputs.samples]
    out = os.path.join(cell.workdir, f"create{i}.agc")
    timers = cell.program.create_archive(out, [s.path for s in files],
                                         cell.params(), device=cell.device)
    return {"path": out, "expected": files, "symbols": sum(s.symbols for s in files),
            "bytes": os.path.getsize(out), "timers": dict(timers.times),
            "discovery": True, "sample_bases": sum(s.symbols for s in files[1:])}
