"""Fallback minimizers (-f) of agc_tpu_torch against agc_tpu, on the CPU.

The dense scan's kernel (``kmer_dir_rc``, plain version here) against
agc_tpu's ``contig_kmers_dir_rc`` / ``_with_membership`` and the Pallas
``kmer_core_via_pallas`` in interpret mode; ``scan_contig``; the fallback
walk, filter and re-rank copies; and whole creates with -f and -a -f,
archives equal stream for stream and part for part. Both packages run with
AGC_TPU_DEVICE_MATCH=0 here; -f's device shortlist is held against agc_tpu
in test_torch_device_match.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agc_tpu.core import compressor as tpu_comp
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.ops import kmers as jk
from agc_tpu.ops.pallas_kmers import kmer_core_via_pallas
from agc_tpu_torch.core import compressor as port_comp
from agc_tpu_torch.core.compressor import Compressor, CompressorParams, create_archive
from agc_tpu_torch.ops import cuda_kmers as ck
from agc_tpu_torch.ops import kmers as tk
from agc_tpu_torch.ops import u64

from test_torch_create import _tpu_params, assert_extracts, assert_same_archive
from util import mutate, random_seq, write_fa

jax.config.update("jax_enable_x64", True)

STRESS = dict(kmer_length=17, min_match_len=15, segment_size=1000, pack_cardinality=50000)


@pytest.fixture
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


def _codes(seed: int, n: int, invalid_every: int = 37) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.integers(0, n, max(1, n // invalid_every))] = 4
    codes[n // 2 : n // 2 + 300] = codes[100:400]  # a repeat
    return codes


def _dir_rc(codes, k, index=None):
    packed = torch.from_numpy(tk.pack4_np(codes)[None, :])
    udir, urc, valid, member = ck.kmer_dir_rc(packed, k, index)
    n = len(codes)
    return (u64.to_u64(udir[0, :n]), u64.to_u64(urc[0, :n]), valid[0, :n].numpy(),
            None if member is None else member[0, :n].numpy())


@pytest.mark.parametrize("k", [17, 21, 31, 32])
def test_kmer_dir_rc_plain_matches_agc_tpu(k):
    """Every position, invalid windows and the row's first k-1 included."""
    codes = _codes(k, 8192)
    udir, urc, valid, member = _dir_rc(codes, k)
    assert member is None
    jd, jr, jv = jk.contig_kmers_dir_rc(jnp.asarray(codes), k)
    np.testing.assert_array_equal(udir, np.asarray(jd))
    np.testing.assert_array_equal(urc, np.asarray(jr))
    np.testing.assert_array_equal(valid, np.asarray(jv))
    pd, pr, pv = kmer_core_via_pallas(jnp.asarray(codes), k, True)
    np.testing.assert_array_equal(udir, np.asarray(pd))
    np.testing.assert_array_equal(urc, np.asarray(pr))
    np.testing.assert_array_equal(valid, np.asarray(pv))


@pytest.mark.parametrize("k", [17, 21, 31, 32])
def test_kmer_dir_rc_membership_matches_agc_tpu(k):
    """Membership through the set's table (each value once; bit-63 values,
    values the contig lacks), against agc_tpu's searchsorted."""
    codes = _codes(100 + k, 8192)
    jd, jr, jv = (np.asarray(x) for x in jk.contig_kmers_dir_rc(jnp.asarray(codes), k))
    canon = np.unique(np.minimum(jd, jr)[jv])
    extra = np.array([1 << 63, (1 << 63) + (1 << 40), 5 << (64 - 2 * k)], np.uint64)
    table = np.unique(np.concatenate([canon[::3], extra]))
    assert (table >= np.uint64(1 << 63)).any()
    index = ck.set_table(u64.from_u64(table))
    _, _, _, member = _dir_rc(codes, k, index)
    _, _, _, jm = jk.contig_kmers_dir_rc_with_membership(
        jnp.asarray(codes), k, jnp.asarray(jk._padded_table(table))
    )
    np.testing.assert_array_equal(member, np.asarray(jm))
    assert member.sum() > 100
    _, _, _, none = _dir_rc(codes, k, ck.set_table(u64.from_u64(table[:0])))
    assert not none.any()


@pytest.mark.parametrize("with_set", [False, True])
def test_scan_contig_matches_agc_tpu(with_set):
    k = 21
    codes = _codes(7, 5000)
    table = np.empty(0, np.uint64)
    if with_set:
        jd, jr, jv = (np.asarray(x) for x in jk.contig_kmers_dir_rc(jnp.asarray(codes), k))
        table = np.unique(np.minimum(jd, jr)[jv])[::5]
    index = ck.set_table(u64.from_u64(table)) if with_set else None
    got = tk.scan_contig(codes, k, index, "cpu")
    want = jk.scan_contig(codes, k, table)
    for g, w, name in zip(got, want, ("canon", "udir", "urc", "valid", "member")):
        v = want[3]
        if name == "canon":  # agc_tpu's canon is min(dir, rc) at valid windows
            g, w = g[v], w[v]
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_greedy_splitter_walk_and_filter_match_agc_tpu():
    rng = np.random.default_rng(3)
    n, k, seg = 20000, 17, 700
    codes = _codes(9, n)
    ud, ur, valid = jk.dir_rc_kmers_np(codes, k)
    canon = np.minimum(ud, ur)
    hits = np.flatnonzero(valid & (rng.random(n) < 0.02))
    for frac in (0.01, 0.05):
        got = port_comp.greedy_splitter_walk(
            n, k, seg, hits, canon[hits],
            (valid, canon, ud, ur, port_comp._FallbackFilter(frac)))
        want = tpu_comp.greedy_splitter_walk(
            n, k, seg, hits, canon[hits],
            (valid, canon, ud, ur, tpu_comp._FallbackFilter(frac)))
        assert got == want
        assert len(got[0]) > 10 and len(got[1]) > 10
    assert not port_comp._FallbackFilter(0.0)
    scored = [(1000, 1, (1, 2)), (1005, 8, (3, 4)), (1500, 20, (5, 6)), (1000, 2, (0, 9))]
    assert port_comp.rerank_near_ties(scored) == tpu_comp.rerank_near_ties(scored)


def _fallback_collection(tmp_path, seed=5):
    """test_modes.py's fallback input: a sample whose contig shares sequence
    with the reference but no splitter alignment at its ends, plus a second
    sample of reversed pieces and a novel contig."""
    rng = random.Random(seed)
    base = random_seq(rng, 30000)
    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", base), ("c2", random_seq(rng, 8000))])
    s0 = str(tmp_path / "s.fa")
    write_fa(s0, [("c1", mutate(rng, base[5000:25000], 50, 5))])
    s1 = str(tmp_path / "t.fa")
    comp = base[::-1].translate(str.maketrans("ACGT", "TGCA"))
    write_fa(s1, [("c1", mutate(rng, comp[2000:26000], 40, 4)),
                  ("c3", mutate(rng, base[12000:16000], 5, 1) + random_seq(rng, 3000))]
             # short pieces without a splitter: placed by fallback votes
             + [(f"p{i}", base[s : s + 400]) for i, s in enumerate(range(1000, 29000, 3500))])
    return [("r", ref), ("s", s0), ("t", s1)]


@pytest.mark.parametrize(
    "label,params",
    [
        ("-f 0.05", dict(fallback_frac=0.05, kmer_length=17, segment_size=1000,
                         pack_cardinality=10, min_match_len=15)),
        ("-a -f 0.01", dict(adaptive_compression=True, fallback_frac=0.01, **STRESS)),
        ("-f 0.05 stress", dict(fallback_frac=0.05, **STRESS)),
        ("-f 0.02 default segment", dict(fallback_frac=0.02)),
    ],
)
def test_fallback_create_matches_agc_tpu(tmp_path, device_match_off, label, params):
    files = _fallback_collection(tmp_path)
    paths = [p for _, p in files]
    p = CompressorParams(**params)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, p, device="cpu")
    tpu_create(ref, paths, _tpu_params(p))
    assert_same_archive(ours, ref)
    assert_extracts(ours, files, ["c1"])


def test_fallback_records_are_used(tmp_path, device_match_off, monkeypatch):
    """The -f run collects fallback records at discovery, and segments
    without a splitter pair are placed through them."""
    files = _fallback_collection(tmp_path, seed=8)
    paths = [p for _, p in files]
    params = CompressorParams(fallback_frac=0.05, kmer_length=17, segment_size=1000,
                              min_match_len=15)
    comp = Compressor(str(tmp_path / "x.agc"), params, reference_file=paths[0], device="cpu")
    comp.splitter_set_snapshot()
    assert len(comp._pending_fallback) > 100
    comp.abort()
    found = []
    real = Compressor._find_cand_fallback

    def spy(self, segment, max_val):
        pk, rc = real(self, segment, max_val)
        found.append(pk != port_comp.PK_EMPTY)
        return pk, rc

    monkeypatch.setattr(Compressor, "_find_cand_fallback", spy)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, params, device="cpu")
    assert sum(found) >= 3
    tpu_create(ref, paths, _tpu_params(params))
    assert_same_archive(ours, ref)


@pytest.mark.parametrize("which", ["_POOL_DEVICE_MAX", "_POOL_CARD_MAX"])
def test_fallback_large_reference_routes(tmp_path, device_match_off, monkeypatch, which):
    """A reference over a lowered _POOL_DEVICE_MAX (agc_tpu: host candidate
    tables; the port: the full pool on the device) and over a lowered
    _POOL_CARD_MAX (the port: host candidate tables too)."""
    files = _fallback_collection(tmp_path, seed=11)
    paths = [p for _, p in files]
    monkeypatch.setattr(tpu_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 12)
    monkeypatch.setenv("AGC_TPU_DISC", "device")
    if which == "_POOL_DEVICE_MAX":
        monkeypatch.setattr(Compressor, "_POOL_DEVICE_MAX", 1 << 12)
    else:
        monkeypatch.setattr(Compressor, "_POOL_CARD_MAX", 1 << 12)
    p = CompressorParams(adaptive_compression=True, fallback_frac=0.05, **STRESS)
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, p, device="cpu")
    tpu_create(ref, paths, _tpu_params(p))
    assert_same_archive(ours, ref)
