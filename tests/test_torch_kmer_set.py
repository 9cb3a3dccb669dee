"""The set form of ``kmer_dir_rc`` on the CPU: the plain model of its
sector-bucket tables (``set_table_plain``, ``set_lookup_plain``) against
agc_tpu's ``contig_kmers_dir_rc_with_membership`` (JAX on the CPU) and
``isin_sorted``, on seeded inputs: k = 15, 17, 31, 32, an empty set, a
one-value set, bit-63 values, a set crafted so that buckets of both tables
overflow, and a contig's own singletons as -f builds them. A Python model
of the build kernel's reads and atomicMin chains, run in shuffled and
interleaved orders, gives the plain table, which is what makes the card's
table comparable with it exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agc_tpu.ops import kmers as jk
from agc_tpu_torch.ops import cuda_kmers as ck
from agc_tpu_torch.ops import kmers as tk
from agc_tpu_torch.ops import u64

jax.config.update("jax_enable_x64", True)

M64 = (1 << 64) - 1
SENTINEL = (1 << 63) - 1


def _codes(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.integers(0, n, n // 41)] = 4
    codes[n // 2 : n // 2 + 500] = codes[200:700]  # a repeat: codes held twice
    return codes


def _canon(codes: np.ndarray, k: int) -> np.ndarray:
    """agc_tpu's canonical codes (unsigned) at the valid windows."""
    jd, jr, jv = (np.asarray(x) for x in jk.contig_kmers_dir_rc(jnp.asarray(codes), k))
    return np.minimum(jd, jr)[jv]


def _bucket_py(v: int, bits: int, mult: int) -> int:
    """The kernel's set_bucket on one flipped code, in Python integers."""
    x = v & M64
    return (((x ^ (x >> 32)) * mult) & M64) >> (64 - bits)


def _colliding(rng, n: int, rules) -> torch.Tensor:
    """n flipped codes (not SENTINEL) in the given buckets: rules of
    (bits, multiplier, bucket)."""
    found = []
    while len(found) < n:
        cand = torch.from_numpy(rng.integers(-(1 << 63), SENTINEL - 1, 1 << 20, dtype=np.int64))
        ok = torch.ones(cand.numel(), dtype=torch.bool)
        for bits, mult, bucket in rules:
            ok &= ck.set_bucket(cand, bits, mult) == bucket
        found += cand[ok].tolist()
    return torch.tensor(found[:n], dtype=torch.int64)


def _crowded(rng, base: torch.Tensor) -> torch.Tensor:
    """A sorted set of the codes ``base`` whose buckets overflow: 40 more codes in each of three of their first-table buckets,
    and 12 in the first of those and in one second-table bucket (the top
    10 bits of its hash: one bucket for any second table of up to 2^10),
    so both tables spill."""
    bits = ck.set_bits(base.numel() + 3 * 40 + 12)
    h0, h1 = ck.SET_HASH
    third = base.numel() // 3
    picks = ck.set_bucket(base[[0, third, 2 * third]], bits, h0).tolist()
    extra = [_colliding(rng, 40, [(bits, h0, b)]) for b in picks]
    extra.append(_colliding(rng, 12, [(bits, h0, picks[0]), (10, h1, 5)]))
    out = torch.unique(torch.cat([base, *extra]))
    assert ck.set_bits(out.numel()) == bits
    return out


def _sets(k: int, codes: np.ndarray) -> dict:
    """The cases' sets, unsigned sorted unique."""
    canon = np.unique(_canon(codes, k))
    values, counts = np.unique(_canon(codes, k), return_counts=True)
    crowded = _crowded(np.random.default_rng(1000 + k), u64.from_u64(canon[::7][:300]))
    return {
        "a third of the codes": canon[::3],
        "empty": canon[:0],
        "one value": canon[len(canon) // 2 : len(canon) // 2 + 1],
        "bit-63 values": canon[canon >= np.uint64(1 << 63)],
        "singletons": values[counts == 1],
        "overflowing buckets": np.sort(u64.to_u64(crowded)),
    }


@pytest.mark.parametrize("k", [15, 17, 31, 32])
def test_set_lookup_matches_agc_tpu(k):
    """kmer_dir_rc's membership through the set's tables, and the lookup's
    plain model on every code, against agc_tpu's searchsorted and
    isin_sorted."""
    codes = _codes(k, 12_000)
    packed = torch.from_numpy(tk.pack4_np(codes)[None, :])
    n = len(codes)
    for name, table in _sets(k, codes).items():
        values = u64.from_u64(table)
        st = ck.set_table(values)
        udir, urc, valid, member = ck.kmer_dir_rc(packed, k, st)
        _, _, _, jm = jk.contig_kmers_dir_rc_with_membership(
            jnp.asarray(codes), k, jnp.asarray(jk._padded_table(table)))
        np.testing.assert_array_equal(member[0, :n].numpy(), np.asarray(jm), err_msg=name)
        canon = torch.minimum(udir, urc)[0]
        model = ck.set_lookup_plain(st, canon) & valid[0]
        np.testing.assert_array_equal(model.numpy(), member[0].numpy(), err_msg=name)
        # every code, invalid windows' included, and the set's own values
        probe = torch.cat([canon, values, values + 1, values - 1])
        want = ck.isin_sorted(probe, values) & (probe != u64.SENTINEL)
        assert torch.equal(ck.set_lookup_plain(st, probe), want), name
        if name == "empty":
            assert not member.any()
        elif name != "one value":
            assert int(member.sum()) > 10, name


def _check_level(level: ck.SetLevel, values: torch.Tensor, spill: torch.Tensor) -> None:
    """Each bucket holds its four smallest values in order, then SENTINEL;
    the spill is sorted, holds exactly the rest, each above the last slot
    of its full bucket."""
    rows = level.buckets.view(-1, ck.SET_SLOTS)
    filled = rows != u64.SENTINEL
    assert torch.equal(filled, filled.cummin(dim=1).values)  # filled slots first
    assert bool(((rows[:, 1:] > rows[:, :-1]) | ~filled[:, 1:]).all())  # ascending
    keep = torch.sort(values[values != u64.SENTINEL]).values
    held = torch.cat([rows[filled], spill])
    assert torch.equal(torch.sort(held).values, keep)
    assert torch.equal(spill, torch.sort(spill).values)
    if spill.numel():
        ob = ck.set_bucket(spill, level.bits, level.hash)
        assert bool(filled[ob, -1].all()) and bool((spill > rows[ob, -1]).all())


def _check_structure(st: ck.SetTable) -> None:
    spill = st.second.buckets[st.second.buckets != u64.SENTINEL]
    spill = torch.sort(torch.cat([spill, st.tail])).values
    _check_level(st.first, st.values, spill)
    _check_level(st.second, spill, st.tail)
    assert st.first.bits == ck.set_bits(st.values.numel())
    assert st.second.bits == ck.set_bits(spill.numel()) + 1
    assert (st.first.hash, st.second.hash) == ck.SET_HASH
    assert st.n_spilled == spill.numel()


@pytest.mark.parametrize("k", [15, 17, 31, 32])
def test_set_table_plain_structure(k):
    for name, table in _sets(k, _codes(50 + k, 12_000)).items():
        st = ck.set_table_plain(u64.from_u64(table))
        assert st.first.buckets.numel() == ck.SET_SLOTS << st.first.bits, name
        _check_structure(st)
        if name == "overflowing buckets":
            assert st.n_spilled >= 3 * 36, "the crowded buckets did not spill"
            assert st.tail.numel() > 0, "the second table did not spill"


def test_set_bucket_matches_integer_arithmetic():
    rng = np.random.default_rng(7)
    v = rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)
    v[:3] = [-(1 << 63), (1 << 63) - 1, 0]
    for mult in ck.SET_HASH:
        for bits in (1, 9, 25, 31):
            got = ck.set_bucket(torch.from_numpy(v), bits, mult).tolist()
            assert got == [_bucket_py(int(x), bits, mult) for x in v]


@pytest.mark.parametrize("n", [0, 1, 4, 5, 1000, 1 << 12, (1 << 12) + 1, 55_643_623])
def test_set_bits_bounds_the_table(n):
    """1 to 2 values a four-slot bucket, and the table at most twice the
    walk index of the same set; a set of up to four values takes the
    least table, two buckets."""
    bits = ck.set_bits(n)
    if n <= 4:
        assert bits == 1
        return
    assert (1 << bits) < n <= 2 << bits
    walk = 8 * n + 4 * ((1 << ck.index_bits(n)) + 1)
    assert 32 << bits <= 2 * walk


def _insert_model(values: np.ndarray, bits: int, mult: int, rng) -> tuple[np.ndarray, list]:
    """The insert kernel as Python: each value reads its bucket, skips the
    slots already below it, then walks the rest by atomicMin (keep the
    smaller, carry the larger, stop at an empty slot); a value carried out
    of the last slot spills. Reads and atomic steps of all values are
    interleaved at random."""
    slots = np.full((1 << bits) * 4, SENTINEL, dtype=object)
    live = [[int(v), 4 * _bucket_py(int(v), bits, mult), None] for v in values if v != SENTINEL]
    spill = []
    while live:
        i = int(rng.integers(0, len(live)))
        v, base, j = live[i]
        if j is None:  # the read ahead: the first slot not already below v
            j = 0
            while j < 4 and slots[base + j] < v:
                j += 1
        else:
            old = slots[base + j]
            slots[base + j] = min(old, v)
            if old == SENTINEL:
                live.pop(i)
                continue
            v, j = max(old, v), j + 1
        live[i] = [v, base, j]
        if j == 4:
            spill.append(live.pop(i)[0])
    return slots.astype(np.int64), spill


@pytest.mark.parametrize("seed", range(3))
def test_build_kernel_model_matches_plain_in_any_order(seed):
    """Whatever the order of the card's threads, the inserts end in
    set_table_plain's first table, and the spill holds its values (the
    second table is built from it in any order, the tail sorted)."""
    rng = np.random.default_rng(seed)
    table = _sets(31, _codes(200 + seed, 3000))["overflowing buckets"]
    values = u64.from_u64(table).numpy()
    values = np.concatenate([values, values[:5], [SENTINEL]])  # held twice, SENTINEL
    rng.shuffle(values)
    st = ck.set_table_plain(torch.from_numpy(np.sort(values)))
    slots, spill = _insert_model(values, st.first.bits, st.first.hash, rng)
    np.testing.assert_array_equal(slots, st.first.buckets.numpy())
    second = st.second.buckets[st.second.buckets != u64.SENTINEL]
    assert sorted(spill) == sorted(second.tolist() + st.tail.tolist())
    assert len(spill) > 100


def test_singleton_set_spill_share():
    """A contig's own singletons, as -f builds its set: a small share of
    the set spills, a smaller one reaches the tail, and lookups of every
    position agree with isin_sorted."""
    codes = _codes(5, 200_000)
    canon = ck.kmer_canon_plain(torch.from_numpy(tk.pack4_np(codes)[None, :]), 17)[0]
    pool = tk.sort_kmers(canon)
    singles, _dups = tk.candidate_tables(pool)
    st = ck.set_table(singles)
    _check_structure(st)
    share = st.n_spilled / singles.numel()
    assert 0 < share < 0.06, share
    assert st.tail.numel() < 0.002 * singles.numel()
    hit = ck.set_lookup_plain(st, canon)
    assert torch.equal(hit, ck.isin_sorted(canon, singles) & (canon != u64.SENTINEL))
    assert float(hit.float().mean()) > 0.5
