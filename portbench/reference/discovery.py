"""AGC's splitter discovery and contig segmentation, in plain NumPy.

The semantics are AGC's (src/core/agc_compressor.cpp: the reference's
canonical k-mers, its singletons, the greedy walk of
``find_splitters_in_contig`` with its rightmost-candidate tail, and the
cuts of ``compress_contig``), written afresh from those rules: nothing of
the program under test is imported or reused.

A k-mer is identified by the position of its last symbol. Codes are
2 bits a symbol, the oldest symbol highest, left-aligned in 64 bits; the
canonical code is the smaller of the direct and reverse-complement codes.
A k-mer that covers an N (or any code above 3) is not valid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CHUNK = 1 << 22


def _combine(older, newer, a: int, b: int, rc: bool):
    """Codes of a+b symbols ending at each position, from the codes of the
    ``a`` symbols before the last ``b`` and of the last ``b``."""
    prev = np.zeros_like(older)
    prev[b:] = older[:-b]
    if rc:
        return (newer << np.uint64(2 * a)) | prev
    return newer | (prev << np.uint64(2 * b))


def _codes(sym: np.ndarray, k: int, rc: bool) -> np.ndarray:
    powers, m = {1: sym}, 1
    while 2 * m <= k:
        powers[2 * m] = _combine(powers[m], powers[m], m, m, rc)
        m *= 2
    acc, have, bit = powers[m], m, m // 2
    while have < k:
        if k - have >= bit:
            acc = _combine(acc, powers[bit], have, bit, rc)
            have += bit
        bit //= 2
    return acc


def kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical code, valid) of the k-mer ending at each position."""
    n = len(codes)
    canon = np.zeros(n, np.uint64)
    valid = np.zeros(n, bool)
    shift = np.uint64(64 - 2 * k)
    for lo in range(0, n, CHUNK):
        a = max(0, lo - (k - 1))
        part = codes[a : lo + CHUNK]
        ok = part < 4
        sym = np.where(ok, part, 0).astype(np.uint64)
        fwd = _codes(sym, k, rc=False) << shift
        rev = _codes(np.uint64(3) - sym, k, rc=True) << shift
        bad = np.cumsum(~ok, dtype=np.int64)
        before = np.zeros_like(bad)
        before[k:] = bad[:-k]
        good = (bad - before) == 0
        good[: k - 1] = False
        skip = lo - a
        canon[lo : lo + CHUNK] = np.minimum(fwd, rev)[skip:]
        valid[lo : lo + CHUNK] = good[skip:]
    return canon, valid


def member(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``values`` that ``table`` (sorted, unique) holds."""
    if not len(table):
        return np.zeros(len(values), bool)
    i = np.minimum(np.searchsorted(table, values), len(table) - 1)
    return table[i] == values


def _rc(code: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (code & 3))
        code >>= 2
    return out


def occurrences(codes: np.ndarray, k: int, table: np.ndarray) -> np.ndarray:
    """Sorted positions of the valid k-mers of ``codes`` whose canonical
    code ``table`` (sorted, unique, small) holds. The last m symbols of each
    position pick candidates from the table's k-mers in both orientations;
    each candidate's whole k-mer is then compared."""
    if not len(table) or len(codes) < k:
        return np.empty(0, np.int64)
    m = min(k, 12)
    mask = (1 << 2 * m) - 1
    words = [int(v) >> (64 - 2 * k) for v in table.tolist()]
    tails = np.zeros(1 << 2 * m, bool)
    tails[[w & mask for w in words] + [_rc(w, k) & mask for w in words]] = True
    sym = np.where(codes < 4, codes, 0).astype(np.uint32)
    last = _codes(sym, m, rc=False)
    cand = np.flatnonzero(tails[last])
    cand = cand[cand >= k - 1]
    win = codes[cand[:, None] + np.arange(1 - k, 1)]
    ok = (win < 4).all(axis=1)
    cand, win = cand[ok], win[ok].astype(np.uint64)
    fwd = np.zeros(len(cand), np.uint64)
    rev = np.zeros(len(cand), np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | win[:, j]
        rev = (rev << np.uint64(2)) | (np.uint64(3) - win[:, k - 1 - j])
    canon = np.minimum(fwd, rev) << np.uint64(64 - 2 * k)
    return cand[member(canon, table)]


@dataclass
class Discovery:
    splitters: np.ndarray  # sorted, unique
    kmers: np.ndarray  # every distinct valid k-mer of the reference, sorted
    positions: int  # reference positions (symbols)
    pool: int  # valid k-mers of the reference
    singletons: int
    walk_positions: int  # positions the greedy walks probe
    emissions: int


def walk(hits: np.ndarray, n: int, k: int, seg: int) -> tuple[list, int]:
    """AGC's greedy splitter walk over a contig's candidate ``hits``
    (sorted positions): the first hit, then each first hit at least
    ``seg`` past the last emitted one; then the rightmost hit at least k
    past the last emission (the tail). Returns (emitted positions, the
    positions a walk probes to find them)."""
    out = greedy(hits, seg)
    starts = [0] + [p + seg for p in out[:-1]]
    probed = sum(p - s + 1 for p, s in zip(out, starts))
    probed += max(0, n - (out[-1] + seg if out else 0))
    floor = out[-1] + k if out else 0
    if len(hits) and hits[-1] >= floor:
        out.append(int(hits[-1]))
        probed += n - int(hits[-1])
    else:
        probed += n
    return out, probed


def greedy(hits: np.ndarray, gap: int) -> list:
    """The first of ``hits`` (sorted), then each first hit at least ``gap``
    past the last one taken."""
    out, i = [], 0
    while i < len(hits):
        out.append(int(hits[i]))
        i = int(np.searchsorted(hits, hits[i] + gap))
    return out


def discover(contigs: list, k: int, segment_size: int) -> Discovery:
    """Splitters of a reference given as a list of code arrays."""
    seg = max(1, segment_size, k)
    per = [kmers(c, k) for c in contigs]
    pool = np.concatenate([c[v] for c, v in per]) if per else np.empty(0, np.uint64)
    uniq, inverse, counts = np.unique(pool, return_inverse=True, return_counts=True)
    single = counts[inverse] == 1
    found, probed, emitted, at = [], 0, 0, 0
    for codes, (canon, valid) in zip(contigs, per):
        where = np.flatnonzero(valid)
        hits = where[single[at : at + len(where)]]
        at += len(where)
        if len(codes) < k:
            continue
        pos, steps = walk(hits, len(codes), k, seg)
        found.extend(int(canon[p]) for p in pos)
        probed += steps
        emitted += len(pos)
    singles = int((counts == 1).sum())
    return Discovery(np.unique(np.array(found, np.uint64)), uniq,
                     sum(len(c) for c in contigs), len(pool), singles, probed, emitted)


def cut_faults(codes: np.ndarray, lengths: list, k: int, splitters: np.ndarray,
               required: np.ndarray, adaptive: bool, concatenated: bool) -> int:
    """Faults in one contig's cuts as an archive records them.

    ``lengths``: the raw lengths of its segments (k symbols of overlap).
    A cut is the position of a segment's last symbol. AGC cuts at the
    hits of its splitter table, skipping a hit less than k past the last
    cut; outside ``-c`` a segment between two splitters may be split once
    more (the missing-middle split), at a point its matcher chooses.

    Without ``-a`` the table is ``splitters`` throughout, so the cuts at
    hits are exactly the greedy cuts over its hits. Under ``-a`` the table
    grows between contigs, so each cut at a hit is checked to lie at a
    hit of the final table (``splitters``), at least k after the last one,
    and every hit of the reference's own splitters (``required``) to be
    cut or to lie less than k after a cut. Returns 0 for a sound contig."""
    n = len(codes)
    ends = np.cumsum(np.asarray(lengths, np.int64)) - k * np.arange(len(lengths))
    if not len(lengths) or ends[-1] != n:
        return 1
    cuts = ends[:-1] - 1
    if np.any(cuts < 0) or np.any(cuts >= n):
        return 1
    if n < k:
        return int(len(cuts) > 0)
    hits = occurrences(codes, k, splitters)
    on_hit = np.intersect1d(cuts, hits)
    extra = np.setdiff1d(cuts, on_hit)
    faults = 0
    if adaptive:
        faults += int(np.sum(np.diff(on_hit) < k))
        need = occurrences(codes, k, required)
        if len(on_hit):
            j = np.searchsorted(on_hit, need, side="right") - 1
            covered = (j >= 0) & (need - on_hit[np.maximum(j, 0)] < k)
            faults += int(np.sum(~covered))
        else:
            faults += len(need)
    else:
        faults += int(not np.array_equal(on_hit, np.array(greedy(hits, k), np.int64)))
    if len(extra):
        if concatenated:
            return faults + len(extra)
        # a split segment lies between two cuts at hits, and its cut lies
        # within half a k-mer of that stretch; one split a segment at most
        if len(on_hit) < 2:
            return faults + len(extra)
        inside = (extra > on_hit[0] - k) & (extra < on_hit[-1] + k)
        faults += int(np.sum(~inside)) + max(0, len(extra) - (len(on_hit) - 1))
    return faults
