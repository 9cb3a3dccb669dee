"""Value-sampled discovery of the port (device='cpu', the kernels' plain
versions) against agc_tpu's, for references over _POOL_DEVICE_MAX:

- the sample hash and the per-chunk truncation against agc_tpu's
  sample_compact_kmers over collect_kmers_device's chunk records, with
  values that have bit 63 set and a chunk whose bucket overflows;
- the port's whole-contig greedy walk against agc_tpu's walk in
  MAX_WHOLE_CONTIG groups carrying t0;
- creates with _POOL_DEVICE_MAX lowered on both Compressor classes, once
  with a compare-all table and once with _COMPARE_ALL_MAX = 64 in both
  packages (the join): equal splitter sets, archives equal part for part.

Integer outputs must be equal: no tolerance. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agc_tpu.core import compressor as tpu_comp
from agc_tpu.ops import kmers as JK
from agc_tpu_torch.core import compressor as port_comp
from agc_tpu_torch.ops import cuda_kmers as CK
from agc_tpu_torch.ops import kmers as TK
from agc_tpu_torch.ops import u64

from test_torch_create import _splitters, assert_same_archive
from util import write_fa

SMALL_CHUNK = 4096


@pytest.fixture
def small_chunks(monkeypatch):
    """CHUNK windows of 4096 symbols in both packages, so that a contig of
    a few kilobases spans several chunk records."""
    monkeypatch.setattr(JK, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(TK, "CHUNK", SMALL_CHUNK)


def _contig(seed: int, n: int) -> np.ndarray:
    """Random bases with a poly-A run of 900 (its k-mer hashes to 0 and is
    always sampled), a satellite repeat and N runs."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=n, dtype=np.uint8)
    c[5000:5900] = 0
    unit = rng.integers(0, 4, size=47, dtype=np.uint8)
    c[9000:9000 + 47 * 40] = np.tile(unit, 40)
    c[3000:3030] = 4
    c[rng.integers(0, n, 8)] = 4
    return c


def _canon(codes: np.ndarray, k: int) -> torch.Tensor:
    packed = torch.from_numpy(TK.pack4_np(codes))[None, :]
    return CK.kmer_canon(packed, k)[0]


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("frac_bits", [1, 2, 3])
def test_sample_kmers_match_sample_compact_kmers(small_chunks, k, frac_bits):
    codes = _contig(k + frac_bits, 6 * SMALL_CHUNK + 123)
    recs = JK.collect_kmers_device(codes, k)
    parts = TK.sample_kmers(_canon(codes, k), len(codes), k, frac_bits)
    assert len(parts) == len(recs) == len(TK.chunk_slices(len(codes), k))
    overflowed = high_bit = 0
    for (arr, kf, real, start), part, (s, e) in zip(
        recs, parts, TK.chunk_slices(len(codes), k)
    ):
        assert (s, e) == (start, start + real - kf)
        bucket = TK.sample_bucket(real - kf, frac_bits)
        want = np.asarray(JK.sample_compact_kmers(arr[kf:real], frac_bits, bucket))
        want = want[want != np.uint64(2**64 - 1)]
        got = np.sort(u64.to_u64(part))
        assert np.array_equal(got, want)
        n_kept = int(TK.sample_keep(_canon(codes, k)[s:e], frac_bits).sum())
        overflowed += n_kept > bucket
        high_bit += int((got >> np.uint64(63)).sum())
    assert high_bit > 0
    if frac_bits == 3:
        assert overflowed == 1  # the chunk with the poly-A run


@pytest.mark.parametrize("k", [17, 31])
def test_whole_contig_walk_matches_grouped_walk(small_chunks, monkeypatch, k):
    """agc_tpu walks a contig in MAX_WHOLE_CONTIG groups carrying t0; the
    port walks it whole in one greedy_walk launch. Same emissions."""
    monkeypatch.setattr(JK, "MAX_WHOLE_CONTIG", 3 * SMALL_CHUNK)
    codes = _contig(40 + k, 9 * SMALL_CHUNK + 77)
    frac_bits, seg = 2, 900
    recs = JK.collect_kmers_device(codes, k)
    tpu_parts = [
        JK.sample_compact_kmers(arr[kf:real], frac_bits, TK.sample_bucket(real - kf, frac_bits))
        for arr, kf, real, _ in recs
    ]
    pool = JK.sort_kmers(jnp.concatenate(tpu_parts))
    want = JK.find_splitter_emissions_from_chunks(recs, len(codes), k, pool, seg)
    canon = _canon(codes, k)
    port_pool = TK.sort_kmers(torch.cat(TK.sample_kmers(canon, len(codes), k, frac_bits)))
    got = TK.find_splitter_emissions_packed(canon, [(0, len(codes))], k, port_pool, seg)[0]
    assert len(want[0]) > 20
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(np.asarray(got[1], np.uint64), np.asarray(want[1], np.uint64))
    assert got[2] == want[2] and np.uint64(got[3]) == np.uint64(want[3])


@pytest.fixture
def sampled(monkeypatch):
    """_POOL_DEVICE_MAX lowered on both Compressor classes (as
    tests/test_kmer_ops.py does). For agc_tpu: AGC_TPU_DEVICE_MATCH=0, and
    AGC_TPU_DISC=device, since its link probe may otherwise send discovery
    to the host (full-pool) engine."""
    monkeypatch.setattr(tpu_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 15)
    monkeypatch.setattr(port_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 15)
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    monkeypatch.setenv("AGC_TPU_DISC", "device")


@pytest.mark.parametrize("table", ["cmp", "join"])
def test_sampled_create_matches_agc_tpu(tmp_path, sampled, small_chunks,
                                        monkeypatch, table):
    rng = np.random.default_rng(17)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = [_contig(3, 30000), rng.integers(0, 4, 12000, dtype=np.uint8),
           rng.integers(0, 4, 20, dtype=np.uint8)]
    paths = [str(tmp_path / "ref.fa")]
    write_fa(paths[0], [(f"c{i}", alpha[np.minimum(c, 3)].tobytes().decode())
                        for i, c in enumerate(ref)])
    for si in range(2):
        mut = [c.copy() for c in ref]
        for c in mut:
            pos = rng.integers(0, len(c), max(1, len(c) // 500))
            c[pos] = (c[pos] + 1) % 4
        paths.append(str(tmp_path / f"s{si}.fa"))
        write_fa(paths[-1], [(f"c{i}", alpha[np.minimum(c, 3)].tobytes().decode())
                             for i, c in enumerate(mut)])
    if table == "join":
        monkeypatch.setattr(JK, "_COMPARE_ALL_MAX", 64)
        monkeypatch.setattr(TK, "_COMPARE_ALL_MAX", 64)
        seg = 400
    else:
        seg = 5000
    calls = []
    for cls, name in ((port_comp.Compressor, "_sampled_emissions"),
                      (tpu_comp.Compressor, "_determine_splitters_sampled")):
        orig = getattr(cls, name)

        def spy(self, *a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(self, *a)

        monkeypatch.setattr(cls, name, spy)
    ours, theirs = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    port_comp.create_archive(ours, paths, port_comp.CompressorParams(segment_size=seg),
                             device="cpu")
    tpu_comp.create_archive(theirs, paths, tpu_comp.CompressorParams(segment_size=seg))
    assert calls == ["_sampled_emissions", "_determine_splitters_sampled"]
    got = _splitters(ours)
    assert got == _splitters(theirs)
    assert (len(got) > 64) == (table == "join") and len(got) > 3
    assert_same_archive(ours, theirs)
