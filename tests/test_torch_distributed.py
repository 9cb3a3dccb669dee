"""The port's sharded create (agc_tpu_torch/parallel/distributed.py) on the
CPU (device="cpu", the kernels' plain versions) against agc_tpu's
create_archive_sharded on the same inputs: archives equal stream for
stream and part for part, at every shard count, for thread and spawned
process shards, -c, -a and -f, and through the CLI; agc_tpu's guards
(-c with -a or -f raises, the delta-hint hash check, the 2% growth bound)
hold in the port. agc_tpu runs with AGC_TPU_DEVICE_MATCH=0 and
AGC_TPU_DISC=device.
"""

import os
import random

import numpy as np
import pytest

from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.parallel.distributed import create_archive_sharded as tpu_sharded
from agc_tpu_torch.core.compressor import CompressorParams, create_archive
from agc_tpu_torch.parallel import distributed as pd
from agc_tpu_torch.parallel.distributed import create_archive_sharded

from test_torch_create import _tpu_params, assert_extracts, assert_same_archive
from util import make_collection, mutate, random_seq, write_fa

PARAMS = dict(kmer_length=17, segment_size=1000, pack_cardinality=2, min_match_len=15)


@pytest.fixture(autouse=True)
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    monkeypatch.setenv("AGC_TPU_DISC", "device")


def _both(tmp_path, paths, params, n, worker="thread", tag=""):
    """The port's and agc_tpu's sharded creates of ``paths``: (port, tpu)."""
    ours, ref = str(tmp_path / f"port{tag}{n}.agc"), str(tmp_path / f"tpu{tag}{n}.agc")
    create_archive_sharded(ours, paths, params, n_shards=n, worker=worker, device="cpu")
    tpu_sharded(ref, paths, _tpu_params(params), n_shards=n)
    return ours, ref


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_create_matches_agc_tpu(tmp_path, n_shards):
    files = make_collection(tmp_path, n_samples=4, contig_lens=(30000, 12000))
    ours, ref = _both(tmp_path, [p for _, p in files], CompressorParams(**PARAMS), n_shards)
    assert_same_archive(ours, ref)
    assert_extracts(ours, files, ["c1", "c2"])


def _adaptive_fixture(tmp_path):
    """Reference + two samples each carrying a contig with no reference
    k-mers (adaptive promotion required); s1's novel contig is a lightly
    mutated copy of s0's (agc_tpu's tests/test_distributed.py fixture)."""
    rng = random.Random(77)
    base = random_seq(rng, 24000)
    novel = random_seq(rng, 8000)
    ref = str(tmp_path / "aref.fa")
    write_fa(ref, [("c1", base)])
    s0 = str(tmp_path / "as0.fa")
    write_fa(s0, [("c1", mutate(rng, base, 30, 3)), ("nv", novel)])
    s1 = str(tmp_path / "as1.fa")
    write_fa(s1, [("c1", mutate(rng, base, 25, 2)), ("nv", mutate(rng, novel, subs=8))])
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=10,
                              min_match_len=15, adaptive_compression=True)
    return [ref, s0, s1], params


@pytest.mark.parametrize("mode", ["default", "-a"])
def test_process_shards_match_agc_tpu(tmp_path, mode):
    """worker="process": spawned workers, each opening device="cpu"
    itself, results shipped by value; equal to agc_tpu's sharded create
    (whose thread and process shards agree, tests/test_distributed.py)."""
    if mode == "-a":
        paths, params = _adaptive_fixture(tmp_path)
    else:
        files = make_collection(tmp_path, n_samples=3, contig_lens=(12000,))
        paths, params = [p for _, p in files], CompressorParams(**PARAMS)
    ours, ref = _both(tmp_path, paths, params, 2, worker="process")
    assert_same_archive(ours, ref)
    thr = str(tmp_path / "thr.agc")
    create_archive_sharded(thr, paths, params, n_shards=2, device="cpu")
    assert_same_archive(ours, thr)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_adaptive_matches_agc_tpu(tmp_path, n_shards):
    """-a: shard-local splitter growth, the candidate tables handed to
    every shard; one shard equals the plain -a create."""
    paths, params = _adaptive_fixture(tmp_path)
    ours, ref = _both(tmp_path, paths, params, n_shards)
    assert_same_archive(ours, ref)
    if n_shards == 1:
        plain = str(tmp_path / "plain.agc")
        create_archive(plain, paths, params, device="cpu")
        assert_same_archive(ours, plain)
    names = ("aref", "as0", "as1")
    assert_extracts(ours, list(zip(names[:1], paths[:1])), ["c1"])
    assert_extracts(ours, list(zip(names[1:], paths[1:])), ["c1", "nv"])


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_fallback_matches_agc_tpu(tmp_path, n_shards):
    """-f: the boot discovery's fallback records reach every shard with
    plain-create timing; one shard equals the plain -f create."""
    rng = random.Random(5)
    base = random_seq(rng, 30000)
    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", base)])
    s0 = str(tmp_path / "s0.fa")
    write_fa(s0, [("c1", mutate(rng, base[5000:25000], 50, 5))])
    s1 = str(tmp_path / "s1.fa")
    write_fa(s1, [("c1", mutate(rng, base[3000:28000], 60, 6))])
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=10,
                              min_match_len=15, fallback_frac=0.05)
    ours, tpu = _both(tmp_path, [ref, s0, s1], params, n_shards)
    assert_same_archive(ours, tpu)
    if n_shards == 1:
        plain = str(tmp_path / "plain.agc")
        create_archive(plain, [ref, s0, s1], params, device="cpu")
        assert_same_archive(ours, plain)
    assert_extracts(ours, [("r", ref), ("s0", s0), ("s1", s1)], ["c1"])


def _concat_files(tmp_path):
    """5 files of 2 contigs, names unique across files (-c: every contig is
    a sample); with pack_cardinality 3 the contig blocks span files."""
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 30000, dtype=np.uint8)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    for i in range(5):
        seq = base.copy()
        idx = rng.choice(len(seq), 60, replace=False)
        seq[idx] = (seq[idx] + 1 + rng.integers(0, 3, 60)) % 4
        txt = alpha[seq].tobytes().decode()
        p = str(tmp_path / f"g{i}.fa")
        write_fa(p, [(f"ctg{i}a", txt[:18000]), (f"ctg{i}b", txt[18000:])])
        files.append(p)
    return files


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_concatenated_matches_agc_tpu(tmp_path, n_shards):
    """-c: the merge replays the global contig stream with the plain
    create's contig-block schedule, so every shard count equals the plain
    -c create (and agc_tpu's sharded -c)."""
    files = _concat_files(tmp_path)
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=3,
                              min_match_len=15, concatenated_genomes=True)
    ours, ref = _both(tmp_path, files, params, n_shards)
    assert_same_archive(ours, ref)
    plain = str(tmp_path / "plain.agc")
    create_archive(plain, files, params, device="cpu")
    assert_same_archive(ours, plain)


def test_sharded_concatenated_duplicate_basenames(tmp_path):
    """-c with inputs sharing a basename (d1/x.fa, d2/x.fa): captures are
    keyed by file path, so every file's contigs reach the archive."""
    from agc_tpu.core.decompressor import Decompressor

    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    for i, sub in enumerate(("d1", "d2", "d3")):
        (tmp_path / sub).mkdir()
        p = str(tmp_path / sub / "x.fa")
        write_fa(p, [(f"uctg{i}", alpha[rng.integers(0, 4, 20000)].tobytes().decode())])
        files.append(p)
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=2,
                              min_match_len=15, concatenated_genomes=True)
    ours, ref = _both(tmp_path, files, params, 2)
    assert_same_archive(ours, ref)
    d = Decompressor(ours)
    try:
        assert sorted(d.list_samples()) == ["uctg0", "uctg1", "uctg2"]
    finally:
        d.close()


@pytest.mark.parametrize("flag", ["adaptive_compression", "fallback_frac"])
def test_sharded_concatenated_rejects_adaptive_and_fallback(tmp_path, flag):
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=2,
                              min_match_len=15, concatenated_genomes=True,
                              **{flag: True if flag == "adaptive_compression" else 0.05})
    files = make_collection(tmp_path, n_samples=2, contig_lens=(4000,))
    with pytest.raises(NotImplementedError):
        create_archive_sharded(str(tmp_path / "x.agc"), [p for _, p in files], params,
                               n_shards=2, device="cpu")


def test_delta_hint_hash_verification(tmp_path):
    """The port's SegmentWriter.add ignores a shipped delta whose ref_hash
    is not its group reference's, and takes an honest one unchanged."""
    import hashlib

    from agc_tpu_torch.core.archive import ArchiveWriter
    from agc_tpu_torch.core.lz import LZDiff
    from agc_tpu_torch.core.segment import SegmentWriter

    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, 5000, dtype=np.uint8).tobytes()
    mem = bytearray(ref)
    for p in rng.choice(5000, 12, replace=False):
        mem[p] = (mem[p] + 1) % 4
    mem = bytes(mem)

    def build(hint):
        w = ArchiveWriter(str(tmp_path / "t.agc"))
        sw = SegmentWriter("xAA", w, 50, 20, 3000)
        sw.add(ref)
        gid = sw.add(mem, delta_hint=hint)
        packed = list(sw.v_lzp)
        w.close()
        return gid, packed

    base = build(None)
    lz = LZDiff(20)
    lz.prepare(ref)
    good = lz.encode(mem)
    good_hash = hashlib.blake2b(ref, digest_size=16).digest()
    assert build((good, good_hash)) == base
    assert build((b"\x00garbage", b"x" * 16)) == base
    assert build((good, hashlib.blake2b(b"other", digest_size=16).digest())) == base


def test_wrong_inventory_hashes_leave_the_archive_unchanged(tmp_path, monkeypatch):
    """Every shipped delta and precompressed reference blob carrying a
    wrong hash: the writer re-encodes, and the archive is agc_tpu's."""
    files = make_collection(tmp_path, n_samples=3, contig_lens=(30000,))
    paths = [p for _, p in files]
    real = pd._inventory

    def corrupted(*args):
        inventory, blobs = real(*args)
        assert inventory and blobs
        bad = b"x" * 16
        return ({pk: (b[0], bad) for pk, b in inventory.items()},
                {pk: (b[0], b[1], bad) for pk, b in blobs.items()})

    monkeypatch.setattr(pd, "_inventory", corrupted)
    ours, ref = _both(tmp_path, paths, CompressorParams(**PARAMS), 2)
    assert_same_archive(ours, ref)


@pytest.fixture(scope="module")
def growth(tmp_path_factory):
    """8 samples and the port's 1-shard archive size."""
    tmp = tmp_path_factory.mktemp("growth")
    files = make_collection(tmp, n_samples=8, contig_lens=(30000, 12000))
    one = str(tmp / "g1.agc")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AGC_TPU_DEVICE_MATCH", "0")
        create_archive_sharded(one, [p for _, p in files], CompressorParams(**PARAMS),
                               n_shards=1, device="cpu")
    return files, os.path.getsize(one)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_count_archive_growth_bounded(growth, tmp_path, n_shards):
    """N-shard archives stay within 2% of the 1-shard size (the merge
    replays matching against the global inventory) and equal agc_tpu's
    at the same shard count."""
    files, one = growth
    ours, ref = _both(tmp_path, [p for _, p in files], CompressorParams(**PARAMS), n_shards)
    assert os.path.getsize(ours) <= one * 1.02, (n_shards, os.path.getsize(ours), one)
    assert_same_archive(ours, ref)
    assert_extracts(ours, files[-1:], ["c1", "c2"])


def test_cli_create_shards(tmp_path):
    """The port's CLI: create --shards 2 (thread workers, --device cpu)
    equals agc_tpu's CLI create --shards 2."""
    from agc_tpu.cli.main import main as tpu_main
    from agc_tpu_torch.cli.main import main

    files = make_collection(tmp_path, n_samples=3, contig_lens=(15000,))
    paths = [p for _, p in files]
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    assert main(["create", "--device", "cpu", "-o", ours, *paths, "--shards", "2",
                 "-s", "1000"]) == 0
    assert tpu_main(["create", "-o", ref, *paths, "--shards", "2", "-s", "1000"]) == 0
    assert_same_archive(ours, ref)
    assert_extracts(ours, files, ["c1"])


def test_tpu_rans_profile_sharded(tmp_path):
    """The tpu-rans profile through the merge (its entropy sink is made
    with the merge's writers): equal to agc_tpu's."""
    files = make_collection(tmp_path, n_samples=3, contig_lens=(20000,))
    params = CompressorParams(profile="tpu-rans", **PARAMS)
    ours, ref = _both(tmp_path, [p for _, p in files], params, 2)
    assert_same_archive(ours, ref)


def test_one_shard_equals_plain_create(tmp_path):
    """The port's 1-shard create equals agc_tpu's plain create: the shard
    path adds nothing to a single-shard archive."""
    files = make_collection(tmp_path, n_samples=2, contig_lens=(20000,))
    paths = [p for _, p in files]
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive_sharded(ours, paths, CompressorParams(**PARAMS), n_shards=1, device="cpu")
    tpu_create(ref, paths, _tpu_params(CompressorParams(**PARAMS)))
    assert_same_archive(ours, ref)
