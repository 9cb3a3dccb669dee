"""Whole runs of tiny cells on the CPU: the harness without its look for
a card. A sound run is correct; the control and each fault the cells can
have, planted under the timed path, come out not correct."""

from __future__ import annotations

import shutil

import pytest

from portbench import harness
from portbench.reference import judge

from .conftest import tiny

SEED = 2**31 + 99


def run(name: str, **kw) -> dict:
    return harness.run_cell(tiny(name), SEED, 1, False, device="cpu", **kw)


@pytest.fixture
def prog():
    harness.scrub_env({})
    return harness.program()


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "sars-cov-2-1k.create",
                                  "hpp-chr21x10.append"])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "sars-cov-2-1k.create",
                                  "hpp-chr21x10.append"])
def test_control_is_not_correct(name):
    """The control: a store of two bits a base, which keeps N as A."""
    r = run(name, control=True)
    assert not r["correct"] and r["checks"]["samples_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "sars-cov-2-1k.create"])
def test_half_the_samples_left_out(name, prog, monkeypatch):
    real = prog.create_archive

    def half(out, files, *a, **kw):
        keep = files[:1] + files[1:][: max(1, len(files[1:]) // 2)]
        if len(files) == 2:  # one multi-FASTA (-c): half of its genomes
            with open(files[1]) as f:
                records = f.read().split(">")[1:]
            cut = out + ".half.fa"
            with open(cut, "w") as f:
                f.write("".join(">" + r for r in records[: len(records) // 2]))
            keep = [files[0], cut]
        return real(out, keep, *a, **kw)

    monkeypatch.setattr(prog, "create_archive", half)
    r = run(name)
    assert not r["correct"] and r["checks"]["samples_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "sars-cov-2-1k.create",
                                  "hpp-chr21x10.append"])
def test_symbol_altered_where_produced(name, prog, monkeypatch):
    """One base of one contig changed as the engine segments it."""
    real = prog.Compressor._process_contig

    def altered(self, sample, contig, codes, *a, **kw):
        if len(codes) > 1000 and not getattr(self, "_altered", False):
            self._altered = True
            codes = codes.copy()
            codes[500] = (codes[500] + 1) % 4
        return real(self, sample, contig, codes, *a, **kw)

    monkeypatch.setattr(prog.Compressor, "_process_contig", altered)
    r = run(name)
    assert not r["correct"] and r["checks"]["samples_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "hpp-chr21x10.append"])
def test_state_returned_unchanged(name, prog, monkeypatch):
    """An operation that leaves its archive as it found it: an append that
    writes its input again, a create that writes the set-up's archive."""
    if name.endswith("append"):
        monkeypatch.setattr(prog, "append_archive",
                            lambda src, out, *a, **kw: shutil.copy(src, out))
    else:
        real, seen = prog.create_archive, []

        def stale(out, files, *a, **kw):
            if seen:
                shutil.copy(seen[0], out)
                return prog.StageTimers()
            seen.append(out)
            return real(out, files, *a, **kw)

        monkeypatch.setattr(prog, "create_archive", stale)
    r = run(name)
    assert not r["correct"] and r["checks"]["samples_wrong"]["value"] > 0


def test_failed_operation_is_not_correct(prog, monkeypatch):
    calls = []
    real = prog.create_archive

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(prog, "create_archive", flaky)
    r = run("sars-cov-2-1k.create")
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_limits_are_exact():
    assert judge.LIMITS == dict.fromkeys(
        ["samples_wrong", "splitters_wrong", "cuts_wrong", "bytes_unaccounted"], 0)
