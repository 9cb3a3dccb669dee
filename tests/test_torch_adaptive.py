"""Adaptive mode (-a) of agc_tpu_torch against agc_tpu, on the CPU.

The candidate tables and singleton filter against agc_tpu's jitted
functions; the port's singleton walk over the full pool against agc_tpu's
membership walk over the singleton table (the equality the port's
discovery relies on); the device-style new-splitter path against
agc_tpu's; whole creates and appends with -a, archives equal stream for
stream and part for part. agc_tpu runs with AGC_TPU_DEVICE_MATCH=0, and
with AGC_TPU_DISC=device where its routing matters.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agc_tpu.core import compressor as tpu_comp
from agc_tpu.core.compressor import append_archive as tpu_append
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.ops import kmers as jk
from agc_tpu_torch.core.compressor import (
    Compressor,
    CompressorParams,
    append_archive,
    create_archive,
)
from agc_tpu_torch.ops import kmers as tk
from agc_tpu_torch.ops import u64

from test_torch_create import _tpu_params, assert_extracts, assert_same_archive
from util import make_collection, mutate, random_seq, write_fa

jax.config.update("jax_enable_x64", True)

STRESS = dict(kmer_length=17, min_match_len=15, segment_size=1000, pack_cardinality=50000)


@pytest.fixture
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    monkeypatch.setenv("AGC_TPU_DISC", "device")


def _pool(kind: str) -> np.ndarray:
    """Unsorted u64 pools: duplicates, SENTINEL tails, bit-63 values."""
    rng = np.random.default_rng(len(kind))
    vals = rng.integers(0, 1 << 63, 3000, dtype=np.int64).astype(np.uint64)
    if kind == "bit 63":
        vals[::2] |= np.uint64(1 << 63)
    pool = np.concatenate([vals, vals[::7], vals[::11], vals[::7]])
    if kind == "sentinels":
        pool = np.concatenate([pool, np.full(500, jk.SENTINEL)])
    if kind == "all duplicated":
        pool = np.concatenate([vals, vals])
    rng.shuffle(pool)
    return pool


@pytest.mark.parametrize("kind", ["duplicates", "sentinels", "bit 63", "all duplicated"])
def test_candidate_tables_match_agc_tpu(kind):
    pool = _pool(kind)
    singles, dups = tk.candidate_tables(tk.sort_kmers(u64.from_u64(pool)))
    js, jns, jd, jnd = jk.candidate_tables(jnp.asarray(pool))
    np.testing.assert_array_equal(u64.to_u64(singles), np.asarray(js)[: int(jns)])
    np.testing.assert_array_equal(u64.to_u64(dups), np.asarray(jd)[: int(jnd)])
    assert len(dups) > 0
    # the singleton filter's two masks on the sorted pool (sentinels are
    # values there, as in agc_tpu's)
    srt = np.sort(pool)
    single, first = tk.singleton_filter(tk.sort_kmers(u64.from_u64(pool)))
    jsingle, jfirst = jk.singleton_filter(jnp.asarray(srt))
    np.testing.assert_array_equal(single.numpy(), np.asarray(jsingle))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))


def test_singleton_filter_edges():
    for vals in ([], [5], [5, 5], [1, 2, 2, 3]):
        s, f = tk.singleton_filter(torch.tensor(vals, dtype=torch.int64))
        js, jf = jk.singleton_filter(jnp.asarray(np.array(vals, np.uint64)))
        assert s.tolist() == np.asarray(js).tolist()
        assert f.tolist() == np.asarray(jf).tolist()


def _repeat_reference(seed: int, lens) -> list:
    """Contigs with repeat families, so the pool has many duplicates."""
    rng = np.random.default_rng(seed)
    units = [rng.integers(0, 4, int(rng.integers(200, 3000))).astype(np.uint8) for _ in range(12)]
    out = []
    for n in lens:
        parts, tot = [], 0
        while tot < n:
            part = units[int(rng.integers(12))].copy() if rng.random() < 0.4 else \
                rng.integers(0, 4, int(rng.integers(500, 4000))).astype(np.uint8)
            parts.append(part)
            tot += len(part)
        c = np.concatenate(parts)[:n]
        c[rng.integers(0, n, n // 500)] = 4
        out.append(c)
    return out


@pytest.mark.parametrize("k,seg", [(17, 1000), (21, 300), (31, 5000), (32, 64)])
def test_full_pool_singleton_walk_equals_membership_walk(k, seg):
    """The port's discovery: the singleton walk over the whole sorted pool
    (greedy_walk's plain version) emits what agc_tpu's -a discovery emits,
    the membership walk over the singleton table of candidate_tables."""
    contigs = _repeat_reference(k + seg, (60000, 9000, 25000, 40))
    canon, placements = tk.collect_kmers_device_packed(contigs, k, "cpu")
    pool = tk.sort_kmers(canon)
    got = tk.find_splitter_emissions_packed(canon, placements, k, pool, seg)
    jcanon, jplace = jk.collect_kmers_device_packed(contigs, k)
    b = 1 << 14
    while b < jcanon.shape[0]:
        b <<= 1
    jpool = jnp.concatenate([jcanon, jnp.full(b - jcanon.shape[0], jk.SENTINEL, jnp.uint64)])
    singles = jk.candidate_tables(jpool)[0]
    want = jk.find_splitter_emissions_packed(jcanon, jplace, k, singles, seg, singleton=False)
    n_emit = 0
    for (gp, gk, gt, gtk), (wp, wk, wt, wtk) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gk, wk)
        assert gt == wt and (gt is None or gtk == wtk)
        n_emit += len(gp)
    assert n_emit > 5


def _adaptive_compressors(tmp_path, ref, params, monkeypatch):
    """The two packages' compressors after create-time discovery on
    ``ref`` (candidate tables built)."""
    ours = Compressor(str(tmp_path / "p.agc"), params, reference_file=ref, device="cpu")
    theirs = tpu_comp.Compressor(str(tmp_path / "t.agc"), _tpu_params(params),
                                 reference_file=ref)
    assert ours.splitter_set_snapshot() == theirs.splitter_set_snapshot()
    return ours, theirs


@pytest.mark.parametrize("fallback", [0.0, 0.05])
def test_new_splitters_device_path_matches_agc_tpu(tmp_path, device_match_off,
                                                   monkeypatch, fallback):
    """_find_new_splitters over a lowered _HOST_NEW_SPLITTERS_MAX (the
    port's kmer_canon + sort + singleton_filter + searchsorted exclusion +
    walk_index + greedy_walk path) and under the default (host) threshold,
    against agc_tpu's, on a contig with reference pieces, a repeat and a
    novel stretch."""
    rng = random.Random(4)
    base = random_seq(rng, 40000)
    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", base)])
    novel = random_seq(rng, 30000)
    contig = novel[:12000] + base[3000:9000] + novel[12000:] + novel[2000:4000]
    codes = np.frombuffer(contig.encode().translate(bytes.maketrans(b"ACGT", b"\0\1\2\3")),
                          np.uint8).copy()
    params = CompressorParams(adaptive_compression=True, fallback_frac=fallback,
                              kmer_length=21, segment_size=2000)
    ours, theirs = _adaptive_compressors(tmp_path, ref, params, monkeypatch)
    try:
        for limit in (1 << 12, 1 << 20):
            monkeypatch.setattr(Compressor, "_HOST_NEW_SPLITTERS_MAX", limit)
            monkeypatch.setattr(tpu_comp.Compressor, "_HOST_NEW_SPLITTERS_MAX", limit)
            for c in (ours, theirs):
                c._pending_new_splitters, c._pending_fallback = [], []
            ours._find_new_splitters(codes)
            theirs._find_new_splitters(codes)
            assert ours._pending_new_splitters == theirs._pending_new_splitters
            assert ours._pending_fallback == theirs._pending_fallback
            assert len(ours._pending_new_splitters) >= 10
    finally:
        ours.abort()
        theirs.abort()


def _adaptive_collection(tmp_path, seed=9, novel_len=15000):
    """Reference + samples: sample 1 adds novel contigs the reference lacks
    (one without any reference splitter, one short), later samples carry
    mutated copies of them first, so their speculative scans ran against
    the older table and the delta scans must find the new splitters."""
    rng = random.Random(seed)
    base = [random_seq(rng, n) for n in (30000, 12000)]
    novel = [random_seq(rng, novel_len), random_seq(rng, 4000), random_seq(rng, 900)]
    files = []
    p = str(tmp_path / "ref.fa")
    write_fa(p, [(f"c{i}", s) for i, s in enumerate(base)])
    files.append(("ref", p))
    p = str(tmp_path / "s0.fa")
    write_fa(p, [(f"c{i}", mutate(rng, s, 60, 6)) for i, s in enumerate(base)]
             + [(f"n{i}", s) for i, s in enumerate(novel)])
    files.append(("s0", p))
    for si in (1, 2):
        p = str(tmp_path / f"s{si}.fa")
        write_fa(p, [(f"n{i}", mutate(rng, s, 20, 2)) for i, s in enumerate(novel)]
                 + [(f"c{i}", mutate(rng, s, 60, 6)) for i, s in enumerate(base)])
        files.append((f"s{si}", p))
    return files


@pytest.mark.parametrize(
    "label,params",
    [
        ("-a segment 1000", dict(adaptive_compression=True, segment_size=1000)),
        ("-a stress", dict(adaptive_compression=True, **STRESS)),
        ("-a -c", dict(adaptive_compression=True, concatenated_genomes=True,
                       segment_size=1500, pack_cardinality=4)),
        ("-a tpu-rans", dict(adaptive_compression=True, segment_size=2000, profile="tpu-rans")),
    ],
)
def test_adaptive_create_matches_agc_tpu(tmp_path, device_match_off, label, params):
    files = _adaptive_collection(tmp_path)
    paths = [p for _, p in files]
    p = CompressorParams(**params)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    timers = create_archive(ours, paths, p, device="cpu")
    tpu_create(ref, paths, _tpu_params(p))
    assert_same_archive(ours, ref)
    if not p.concatenated_genomes:
        assert_extracts(ours, files, ["c0"])
        assert_extracts(ours, files[1:], ["n0", "n2"])
        # the later samples' novel copies were scanned against the older
        # table: only the delta scans found their splitters
        assert timers.units["delta_hits"] > 0


def test_adaptive_table_crosses_compare_all_max(tmp_path, device_match_off, monkeypatch):
    """New splitters grow the table past _COMPARE_ALL_MAX (lowered in both
    packages): the scans move from scan_fused to the join mid-run."""
    monkeypatch.setattr(tk, "_COMPARE_ALL_MAX", 40)
    monkeypatch.setattr(jk, "_COMPARE_ALL_MAX", 40)
    files = _adaptive_collection(tmp_path, seed=12)
    paths = [p for _, p in files]
    p = CompressorParams(adaptive_compression=True, segment_size=1200)
    comp = Compressor(str(tmp_path / "x.agc"), p, reference_file=paths[0], device="cpu")
    n_disc = len(comp.splitter_set_snapshot())
    comp.abort()
    assert n_disc <= 40
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, p, device="cpu")
    tpu_create(ref, paths, _tpu_params(p))
    assert_same_archive(ours, ref)
    from agc_tpu.core.archive import ArchiveReader

    r = ArchiveReader(ours)
    assert r.get_part("splitters", 0)[1] > 40
    r.close()


@pytest.mark.parametrize("which", ["_POOL_DEVICE_MAX", "_POOL_CARD_MAX"])
def test_adaptive_large_reference_routes(tmp_path, device_match_off, monkeypatch, which):
    """A reference over a lowered _POOL_DEVICE_MAX: agc_tpu takes its host
    full pool, the port its full pool on the device (never the sampled
    pool); over a lowered _POOL_CARD_MAX the port takes its host full pool
    too."""
    files = _adaptive_collection(tmp_path, seed=10)
    paths = [p for _, p in files]
    monkeypatch.setattr(tpu_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 14)
    monkeypatch.setattr(Compressor, which, 1 << 14)
    p = CompressorParams(adaptive_compression=True, **STRESS)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, p, device="cpu")
    tpu_create(ref, paths, _tpu_params(p))
    assert_same_archive(ours, ref)


def test_adaptive_append_matches_agc_tpu(tmp_path, device_match_off):
    """tests/test_modes.py's adaptive append: an alien sample admits new
    splitters (tables re-counted from the archive's reference sample), a
    mutated second alien reuses its groups."""
    rng = random.Random(9)
    files = make_collection(tmp_path, rng=rng, n_samples=1, contig_lens=(30000,))
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=10,
                              min_match_len=15, adaptive_compression=True)
    paths = [p for _, p in files]
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, params, device="cpu")
    tpu_create(ref, paths, _tpu_params(params))
    assert_same_archive(ours, ref)
    alien = str(tmp_path / "alien.fa")
    alien_seq = random_seq(rng, 20000)
    write_fa(alien, [("z", alien_seq)])
    alien2 = str(tmp_path / "alien2.fa")
    write_fa(alien2, [("z", mutate(rng, alien_seq, 30, 3))])
    for src_o, src_r, extra, tag in ((ours, ref, alien, "1"), (None, None, alien2, "2")):
        src_o = src_o or str(tmp_path / "port1.agc")
        src_r = src_r or str(tmp_path / "tpu1.agc")
        out_o, out_r = str(tmp_path / f"port{tag}.agc"), str(tmp_path / f"tpu{tag}.agc")
        append_archive(src_o, out_o, [extra], params, device="cpu")
        tpu_append(src_r, out_r, [extra], _tpu_params(params))
        assert_same_archive(out_o, out_r)
    assert_extracts(str(tmp_path / "port2.agc"), [("alien", alien), ("alien2", alien2)], ["z"])
