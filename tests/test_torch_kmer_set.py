"""The set form of ``kmer_dir_rc`` on the CPU: the plain model of its
sector-bucket tables (``set_table_plain``, ``set_lookup_plain``) against
agc_tpu's ``contig_kmers_dir_rc_with_membership`` (JAX on the CPU) and
``isin_sorted``, on seeded inputs: k = 15, 17, 31, 32, an empty set, a
one-value set, bit-63 values, a set crafted so that buckets of both tables
overflow, and a contig's own singletons as -f builds them. A Python model
of the build (the partition levels, then a block a slice: its sort by
bucket in shared memory or, past that room, its atomicMin chains, and its
spill), run with random partitions, thread orders and slice sizes, gives
the plain tables, which is what makes the card's tables comparable with
them exactly.
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


def _partition_model(values: list, bits: int, mult: int, widths, pieces, rng):
    """The partition levels as Python: each level counts each piece's
    values by bin (bits [shift, shift + width) of the bucket), takes the
    exclusive sums of the counts in (segment, bin, piece) order, and moves
    each piece's values to its bins' places in a random order (the scatter's
    shared atomics). Returns the moved values and each slice's [lo, hi)."""
    n = len(values)
    src, segs, shift = list(values), [(0, n)], bits
    for width, q in zip(widths, pieces):
        shift -= width

        def bin_of(v, shift=shift, width=width):
            return (_bucket_py(v, bits, mult) >> shift) & ((1 << width) - 1)

        def piece(a, j, q=q):
            s, e = segs[a]
            per = -(-(e - s) // q)
            lo = min(e, s + j * per)
            return lo, min(e, lo + per)

        counts = np.zeros((len(segs) << width) * q, dtype=np.int64)
        for a in range(len(segs)):
            for j in range(q):
                lo, hi = piece(a, j)
                for v in src[lo:hi]:
                    counts[((a << width) + bin_of(v)) * q + j] += 1
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out = [None] * n
        for a in range(len(segs)):
            for j in range(q):
                lo, hi = piece(a, j)
                for c in range(1 << width):
                    run = [v for v in src[lo:hi] if bin_of(v) == c]
                    rng.shuffle(run)
                    at = int(offsets[((a << width) + c) * q + j])
                    out[at : at + len(run)] = run
        assert None not in out
        src = out
        segs = [(int(offsets[t * q]), int(offsets[(t + 1) * q]))
                for t in range(len(segs) << width)]
    return src, segs


def _sorted_model(mine: list, bits: int, sbits: int, mult: int, rng):
    """slice_sorted as Python: the slice's values counted a bucket, moved to
    their bucket's place in a random order (the shared atomics'), then each
    bucket's kept as its four smallest in order, the rest spilled in the
    order its thread meets them. Returns (image, spill)."""
    mask = (1 << sbits) - 1
    by_bucket = [[] for _ in range(1 << sbits)]
    for k in rng.permutation(len(mine)):
        by_bucket[_bucket_py(mine[k], bits, mult) & mask].append(mine[k])
    img, spill = [], []
    for placed in by_bucket:
        keep = []
        for x in placed:
            keep = sorted(keep + [x])
            if len(keep) > 4:
                spill.append(keep.pop())
        img += keep + [SENTINEL] * (4 - len(keep))
    return img, spill


def _slice_model(src: list, lo: int, hi: int, t: int, bits: int, sbits: int, mult: int, rng,
                 cap=None):
    """set_slice_kernel's block for slice t as Python. A slice of a
    partitioned set of at most ``cap`` values: ``_sorted_model``. Any
    other: the image all SENTINEL; the slice's values (of src[lo:hi]) into
    their buckets by chains of atomicMin, the reads and atomic steps of all
    values interleaved at random, each chain skipping the slots it reads
    below its value; then the values in another random order, each past its
    full bucket's fourth slot spilled (equal to the last slot: only beyond
    the copies the slots hold, counted a bucket). Returns (image, spill)."""
    mask = (1 << sbits) - 1
    img = [SENTINEL] * (4 << sbits)
    mine = [v for v in src[lo:hi]
            if v != SENTINEL and _bucket_py(v, bits, mult) >> sbits == t]
    if cap is not None and hi - lo <= cap:
        assert len(mine) == len([v for v in src[lo:hi] if v != SENTINEL])
        return _sorted_model(mine, bits, sbits, mult, rng)
    live = [[v, 4 * (_bucket_py(v, bits, mult) & mask), None] for v in mine]
    passed = 0
    while live:
        i = int(rng.integers(0, len(live)))
        v, base, j = live[i]
        if j is None:  # the read: the first slot not already below v
            j = 0
            while j < 4 and img[base + j] < v:
                j += 1
        else:
            old = img[base + j]
            img[base + j] = min(old, v)
            if old == SENTINEL:
                live.pop(i)
                continue
            v, j = max(old, v), j + 1
        live[i] = [v, base, j]
        if j == 4:
            live.pop(i)
            passed += 1
    ties = [0] * (1 << sbits)
    spill = []
    for k in rng.permutation(len(mine)):
        v = mine[k]
        b = _bucket_py(v, bits, mult) & mask
        slots = img[4 * b : 4 * b + 4]
        if slots[3] == SENTINEL:
            continue
        if v > slots[3]:
            spill.append(v)
        elif v == slots[3]:
            if ties[b] >= slots.count(v):
                spill.append(v)
            ties[b] += 1
    assert len(spill) == passed  # the count the look-back sums
    return img, spill


def _build_model(values: list, bits: int, mult: int, rng, sbits: int, widths=(), pieces=(),
                 cap=None):
    """set_table's build of one table as Python: the partition levels (none:
    each slice's block reads every value), then every slice's block (the
    sorted path for a partitioned slice of at most ``cap`` values), the
    slices' spills at the offsets the look-back gives (their exclusive
    sums). Returns (buckets, spill, the slices that took the sorted path)."""
    t = bits - min(bits, sbits)
    sbits = min(bits, sbits)
    if widths:
        src, segs = _partition_model(values, bits, mult, widths, pieces, rng)
        assert sum(widths) == t
    else:
        src, segs, cap = list(values), [(0, len(values))] * (1 << t), None
    buckets, spill = [], []
    for s, (lo, hi) in enumerate(segs):
        img, sp = _slice_model(src, lo, hi, s, bits, sbits, mult, rng, cap)
        buckets += img
        spill += sp
    n_sorted = sum(hi - lo <= cap for lo, hi in segs) if cap is not None else 0
    return np.array(buckets, dtype=np.int64), spill, (n_sorted, len(segs) - n_sorted)


def _model_set(seed: int) -> list:
    """An overflowing set with values held twice and three times (the
    smallest of its most crowded bucket, so that copies of a bucket's last
    slot spill) and SENTINELs, shuffled."""
    rng = np.random.default_rng(seed)
    table = _sets(31, _codes(200 + seed, 3000))["overflowing buckets"]
    values = u64.from_u64(table).numpy()
    b = ck.set_bucket(torch.from_numpy(values), ck.set_bits(len(values)), ck.SET_HASH[0]).numpy()
    crowded = np.sort(values[b == np.bincount(b).argmax()])[:3]
    values = np.concatenate([values, values[:5], values[40:43], crowded, crowded,
                             [SENTINEL] * 3])
    rng.shuffle(values)
    return [int(v) for v in values]


def _check_model(values: list, rng, sbits: int, plan, cap=None) -> int:
    """Both tables and the tail of the model's build against
    set_table_plain; plan(bits) gives the partition (widths, pieces).
    Returns how many slices took the sorted path and how many the
    chains."""
    st = ck.set_table_plain(torch.tensor(sorted(values), dtype=torch.int64))
    first, spill, n1 = _build_model(values, st.first.bits, st.first.hash, rng, sbits,
                                    *plan(st.first.bits), cap)
    np.testing.assert_array_equal(first, st.first.buckets.numpy())
    second_held = st.second.buckets[st.second.buckets != u64.SENTINEL]
    assert sorted(spill) == sorted(second_held.tolist() + st.tail.tolist())
    second, tail, n2 = _build_model(spill, st.second.bits, st.second.hash, rng, sbits,
                                    *plan(st.second.bits), cap)
    np.testing.assert_array_equal(second, st.second.buckets.numpy())
    assert sorted(tail) == st.tail.tolist()
    assert len(spill) > 100 and len(tail) > 0
    return n1[0] + n2[0], n1[1] + n2[1]


@pytest.mark.parametrize("seed", range(4))
def test_slice_build_model_matches_plain(seed):
    """Whatever the partitions (one level or two, any number of pieces, any
    order inside a bin), the order of the threads, the slice size and which
    slices outgrow the sorted path's room, the slice build gives
    set_table_plain's tables: an overflowing set with values held twice and
    SENTINELs."""
    rng = np.random.default_rng(seed)
    sbits = int(rng.integers(2, 6))
    cap = 2 << sbits  # 2 values a bucket: the crowded buckets' slices outgrow it

    def plan(bits):
        t = bits - min(bits, sbits)
        if t <= 2:
            return (), ()
        cut = int(rng.integers(1, t)) if rng.random() < 0.7 else t
        widths = (cut, t - cut) if cut < t else (t,)
        return widths, tuple(int(rng.integers(1, 6)) for _ in widths)

    n_sorted, n_chains = _check_model(_model_set(seed), rng, sbits, plan, cap)
    assert n_sorted > 0 and n_chains > 0


@pytest.mark.parametrize("sbits", [9, 6])
def test_slice_build_model_unpartitioned(sbits):
    """A set of one slice (the whole table in one block) and of four (each
    block reads every value and keeps its slice's): no partition level."""
    rng = np.random.default_rng(sbits)
    values = _model_set(10 + sbits)
    bits = ck.set_bits(len(values))
    assert bits - min(bits, sbits) == (0 if sbits == 9 else 2)
    assert _check_model(values, rng, sbits, lambda bits: ((), ()))[0] == 0


@pytest.mark.parametrize("n, second, widths", [
    (0, False, []), (1_120, False, []), (4_096, False, []), (11_489, False, []),
    (16_384, False, []), (16_385, False, [3]), (1_212_664, True, [10]),
    (55_643_623, False, [7, 7]), (890_297_968, False, [9, 9])])
def test_set_partition_plan(n, second, widths):
    """The partition levels of -f's and the splitter tables' sets: none up
    to four slices (entry()'s 4,096 splitters, the mesh create's 1,120,
    whole-genome discovery's 11,489), one level for the second table of the
    55.6 M set's spill, two of at most 2^10 bins at -f's 55.6 M set and
    _POOL_CARD_MAX's; the pieces about SET_PART_CHUNK values, the counts
    under a value each."""
    bits = ck.set_bits(n) + second
    plan = ck.set_partition_plan(n, bits)
    assert [p for p, *_ in plan] == widths
    shift = bits
    segs = 1
    for p, sh, sg, q in plan:
        shift -= p
        assert (sh, sg) == (shift, segs) and 1 <= p <= ck.SET_PART_MAX_BITS
        assert -(-n // (sg * q)) <= ck.SET_PART_CHUNK < 2 * -(-n // (sg * q)) or q == 1
        assert (sg << p) * q <= n // 4 + (1 << 20)
        segs <<= p
    if plan:
        assert shift == min(bits, ck.SET_SLICE_BITS)


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
