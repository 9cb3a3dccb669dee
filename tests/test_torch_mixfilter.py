"""The membership test of the port's scan_fused and member_mix kernels
(csrc/kmer_common.cuh, MixSet), through its plain model in
agc_tpu_torch.ops.cuda_kmers:

- the 2^20-bit filter (mix_filter_plain) has no false negative on hard
  tables: one entry, padding, a join table from make_scan_table, 0 and
  0xFFFFFFFF and bit 31, 16384 and 32768 entries, shared top or low bits;
- the filter, then the search of one directory bucket (mix_set_plain),
  equals member_mix_plain on mixes drawn from the tables, their +-1
  neighbours and random words;
- member_mix_plain equals agc_tpu's member_mix_pallas (interpret mode) on
  the same mixes;
- the filter's false-positive rate at the whole-genome join table's
  22,979 distinct values is within 2x of (1 - e^(-2n / 2^20))^2.
Inputs are made with numpy from a seed; outputs must be equal.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agc_tpu.ops.pallas_kmers import member_mix_pallas
from agc_tpu_torch.ops import cuda_kmers as CK
from agc_tpu_torch.ops import kmers as TK
from agc_tpu_torch.ops import u64

PAD = 0xDEADBEEF


def _padded(values, size):
    out = np.full(size, PAD, dtype=np.uint32)
    out[: len(values)] = values
    return np.sort(out)


def _join_table(rng):
    """A 'join' table as the engine builds it: over 8192 splitters, both
    orientations' mixes, padded with 0xDEADBEEF pairs to a power of two."""
    codes = rng.integers(0, 4, 30_000, dtype=np.uint8)
    ud, ur, v = TK.dir_rc_kmers_np(codes, 31)
    canon = np.unique(np.minimum(ud, ur)[v])
    pick = np.sort(rng.choice(canon, 8500, replace=False))
    table = TK.make_scan_table(pick, 31, "cpu")
    assert table.kind == "join"
    return u64.to_u32(table.tmix)


def _table(name: str) -> np.ndarray:
    """A sorted u32 mix table that is hard for the filter or the
    directory."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rand = lambda n: rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)  # noqa: E731
    if name == "one entry":
        return np.array([0x12345678], dtype=np.uint32)
    if name == "128 with pads":
        return _padded(np.unique(rand(40)), 128)
    if name == "join table":
        return _join_table(rng)
    if name == "0, 0xFFFFFFFF, bit 31":
        vals = np.concatenate([[0, 0xFFFFFFFF, 1 << 31, (1 << 31) - 1],
                               rand(60) | np.uint32(1 << 31)])
        return _padded(np.unique(vals.astype(np.uint32)), 128)
    if name == "16384 entries":
        return np.sort(rand(16384))
    if name == "32768 entries":
        return np.sort(rand(32768))
    if name == "shared top bits":  # one directory bucket holds them all
        return _padded(np.unique(np.uint32(0xABC00000) | (rand(3000) & np.uint32(0xFFFFF))), 4096)
    if name == "shared low bits":
        return _padded(np.unique((rand(3000) & np.uint32(0xFFF00000)) | np.uint32(0x5A5A5)), 4096)
    raise KeyError(name)


TABLES = ["one entry", "128 with pads", "join table", "0, 0xFFFFFFFF, bit 31",
          "16384 entries", "32768 entries", "shared top bits", "shared low bits"]


def _mixes(table: np.ndarray, seed: int) -> np.ndarray:
    """Every table value, its +-1 neighbours (wrapping), 0, 0xFFFFFFFF and
    random words."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        table, table + np.uint32(1), table - np.uint32(1),
        np.array([0, 0xFFFFFFFF, PAD], dtype=np.uint32),
        rng.integers(0, 1 << 32, 20_000, dtype=np.int64).astype(np.uint32),
    ])


@pytest.mark.parametrize("name", TABLES)
def test_filter_has_no_false_negative(name):
    table = _table(name)
    words = CK.mix_filter_plain(u64.from_u32(table))
    assert words.shape == (1 << 15,) and words.dtype == torch.int32
    assert bool(CK.mix_filter_pass(words, u64.from_u32(table)).all())
    # two bits an entry at most, one at least
    n_set = int(np.unpackbits(u64.to_u32(words).view(np.uint8)).sum())
    distinct = len(np.unique(table))
    assert distinct <= n_set <= 2 * distinct


@pytest.mark.parametrize("name", TABLES)
def test_filter_then_bucket_search_equals_member_mix_plain(name):
    table = u64.from_u32(_table(name))
    mix = u64.from_u32(_mixes(u64.to_u32(table), 1))
    want = CK.member_mix_plain(mix, table)
    assert torch.equal(CK.mix_set_plain(mix, table), want)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(CK.member_mix(mix, table), want)
    assert int(want.sum()) >= table.unique().numel()
    # the directory: bucket b opens at the first value with top bits >= b
    dirs = CK.mix_dir_plain(table).to(torch.int64)
    d = CK.mix_dir_bits(table.numel())
    v = table.to(torch.int64) & u64.M32
    assert dirs.numel() == (1 << d) + 1 and int(dirs[-1]) == table.numel()
    assert bool((dirs[1:] >= dirs[:-1]).all())
    at = dirs[v >> (32 - d)]
    assert bool((at <= torch.arange(table.numel())).all())


@pytest.mark.parametrize("name", ["one entry", "128 with pads", "0, 0xFFFFFFFF, bit 31",
                                  "shared low bits"])
def test_member_mix_plain_matches_pallas_on_hard_mixes(name):
    """member_mix_plain against agc_tpu's member_mix_pallas in interpret
    mode, as tests/test_pallas_kmers.py runs it."""
    table = _table(name)
    mix = _mixes(table, 2)[: 3 * len(table) + 3 + 1024]
    n = -(-len(mix) // 1024) * 1024  # the Pallas kernel takes whole tiles
    mix = np.concatenate([mix, np.full(n - len(mix), 0x13579BDF, dtype=np.uint32)])
    want = np.asarray(member_mix_pallas(jnp.asarray(mix), jnp.asarray(table), True))
    got = CK.member_mix_plain(u64.from_u32(mix), u64.from_u32(table)).numpy()
    assert np.array_equal(got, want)
    assert got[: len(table)].all()


def test_filter_false_positive_rate():
    """At the whole-genome join table's 22,979 distinct values (PERF.md)
    the rate of random non-members passing is within 2x of
    (1 - e^(-2n / 2^20))^2 = 0.184%."""
    rng = np.random.default_rng(11)
    n = 22_979
    draw = np.unique(rng.integers(0, 1 << 32, 2 * n, dtype=np.int64).astype(np.uint32))
    table = rng.permutation(draw)[:n]
    assert len(table) == n
    words = CK.mix_filter_plain(u64.from_u32(np.sort(table)))
    probe = rng.integers(0, 1 << 32, 1 << 21, dtype=np.int64).astype(np.uint32)
    probe = probe[~np.isin(probe, table)]
    rate = float(CK.mix_filter_pass(words, u64.from_u32(probe)).float().mean())
    expect = (1 - math.exp(-2 * n / (1 << 20))) ** 2
    assert abs(expect - 0.00184) < 5e-5
    assert expect / 2 <= rate <= 2 * expect
