"""The plain reference against toy archives that the program writes on
the CPU: it reads every sample back, finds the program's splitters and
cuts sound, and counts what is broken when something is."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from portbench import harness
from portbench.reference import discovery, judge
from portbench.reference.archive import Archive, Container, lz_decode

from .conftest import tiny


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A tiny hpp create, written by the program on the CPU."""
    d = str(tmp_path_factory.mktemp("toy"))
    spec = tiny("hpp-chr21x10.create")
    harness.scrub_env({})
    prog = harness.program()
    inputs = harness.load("gen", "hpp").make(spec.config["generator_params"], 17, d, 0)
    files = [inputs.reference, *inputs.samples]
    path = os.path.join(d, "toy.agc")
    prog.create_archive(path, [s.path for s in files],
                        prog.CompressorParams(**spec.config["params"]), device="cpu")
    p = spec.config["params"]
    ref = discovery.discover([c for _, c in inputs.reference.contigs],
                             p["kmer_length"], p["segment_size"])
    return path, files, ref, p


def test_reads_every_sample(toy):
    path, files, _, _ = toy
    arc = Archive(path)
    layout = arc.sample_layout()
    assert list(layout) == [s.name for s in files]
    for s in files:
        got = layout[s.name]
        assert [h for h, _ in got] == [h for h, _ in s.contigs]
        for (_, segs), (_, codes) in zip(got, s.contigs):
            assert np.array_equal(arc.contig(segs), codes)
    assert arc.c.unaccounted() == 0


def test_discovery_and_cuts_agree_with_the_program(toy):
    path, files, ref, p = toy
    arc = Archive(path)
    assert np.array_equal(arc.splitters(), ref.splitters)
    assert ref.pool < ref.positions and 0 < ref.singletons <= ref.pool
    layout = arc.sample_layout()
    n_segments = 0
    for s in files:
        for (_, segs), (_, codes) in zip(layout[s.name], s.contigs):
            n_segments += len(segs)
            assert discovery.cut_faults(codes, [g[3] for g in segs], arc.k, ref.splitters,
                                        ref.splitters, False, False) == 0
    assert n_segments > 3 * len(files)
    want = judge.expected_samples(files, False)
    assert judge.judge(path, want, ref, p, lambda _: True) == dict.fromkeys(judge.LIMITS, 0)


def test_moved_cut_and_missing_splitter_counted(toy):
    path, files, ref, p = toy
    arc = Archive(path)
    s = files[1]
    segs = arc.sample_layout()[s.name][0][1]
    lengths = [g[3] for g in segs]
    lengths[0] += 7
    lengths[1] -= 7
    assert discovery.cut_faults(s.contigs[0][1], lengths, arc.k, ref.splitters,
                                ref.splitters, False, False) > 0
    fewer = discovery.Discovery(**{**ref.__dict__, "splitters": ref.splitters[1:]})
    got = judge.judge(path, judge.expected_samples(files, False), fewer, p, lambda _: False)
    assert got["splitters_wrong"] == 1 and got["samples_wrong"] == 0


def test_stray_bytes_and_missing_sample_counted(toy, tmp_path):
    path, files, ref, p = toy
    c = Container(path)
    with open(path, "rb") as f:
        data = f.read()
    padded = str(tmp_path / "padded.agc")
    with open(padded, "wb") as f:  # 5 bytes between the parts and the footer
        f.write(data[: c.body_end] + b"\0" * 5 + data[c.body_end:])
    assert Container(padded).unaccounted() == 5
    want = judge.expected_samples(files + files[1:2], False)
    want[-1] = ("extra", want[-1][1])
    assert judge.judge(path, want, ref, p, lambda _: False)["samples_wrong"] == 1
    broken = str(tmp_path / "broken.agc")
    shutil.copy(path, broken)
    with open(broken, "r+b") as f:
        f.truncate(len(data) // 2)
    assert judge.judge(broken, judge.expected_samples(files, False), ref, p,
                       lambda _: False)["samples_wrong"] == len(files)


def test_lz_decode_matches_the_encoder():
    """The frozen LZ decoder replays what the program's encoder writes."""
    harness.scrub_env({})
    harness.program()
    from agc_tpu_torch.core.lz import LZDiff

    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 20_000).astype(np.uint8)
    for trial in range(6):
        seq = ref.copy()
        seq[rng.integers(0, len(seq), 40)] = rng.integers(0, 4, 40)
        seq[5000:5300] = 4  # an N run
        seq = np.concatenate([seq[:9000], rng.integers(0, 4, 500).astype(np.uint8),
                              seq[9100:]])[trial * 100:]
        lz = LZDiff(20)
        lz.prepare(ref.tobytes())
        enc = lz.encode(seq.tobytes())
        assert lz_decode(ref.tobytes(), enc, 20) == seq.tobytes()


def test_kmers_match_a_direct_count():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[100:140] = 4
    for k in (1, 17, 25, 31, 32):
        canon, valid = discovery.kmers(codes, k)
        for p in rng.integers(0, len(codes), 200).tolist():
            window = codes[p - k + 1 : p + 1] if p >= k - 1 else None
            ok = window is not None and (window < 4).all()
            assert valid[p] == ok
            if ok:
                fwd = int("".join(map(str, window)), 4)
                rev = int("".join(str(3 - x) for x in window[::-1]), 4)
                assert canon[p] == min(fwd, rev) << (64 - 2 * k)


def test_occurrences_match_every_kmer():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    codes[rng.integers(0, len(codes), 300)] = 4
    for k in (17, 25, 31, 32):
        canon, valid = discovery.kmers(codes, k)
        table = np.unique(canon[valid][rng.integers(0, valid.sum(), 40)])
        want = np.flatnonzero(valid & discovery.member(canon, table))
        assert np.array_equal(discovery.occurrences(codes, k, table), want)
