"""Rolling canonical k-mer ops of the port (counterpart of
``agc_tpu/ops/kmers.py``).

``agc_tpu/ops/kmers.py`` imports jax at module level, so its host twins
are copied here unchanged: ``_revcomp_np``, ``dir_rc_kmers_np``,
``canon_kmers_np``, ``pack4_np``, the scan-vector decoders,
``ScanTable`` / ``make_scan_table``, ``scan_members_host`` and
``DaemonPool``. The device programs are PyTorch: the membership scans
(compare-all and large-table join), discovery (full pool and
value-sampled), the candidate tables of -a and -f, and the dense scan of
-f go through the CUDA kernels of ``cuda_kmers`` on CUDA tensors and
through their plain versions on CPU tensors.

K-mer value convention (the reference's, so splitter sets are
interchangeable with reference archives): the canonical code is
min(dir, rc) with

    dir = (sum_j w[j] * 4^(k-1-j)) << (64 - 2k)
    rc  = (sum_j (3-w[j]) * 4^j)   << (64 - 2k)

for window w[0..k-1]; host arrays hold it as np.uint64, device tensors
in the flipped int64 convention of ``ops/u64.py``.
"""

from __future__ import annotations

import atexit
import threading
import time

import numpy as np
import torch

from ..native import get_lib

from ..utils.profiling import span
from . import u64
from .cuda_kmers import (
    dir_mix,
    greedy_walk,
    kmer_canon,
    kmer_dir_rc,
    member_mix,
    scan_fused,
)


def _shift_for(k: int) -> int:
    return 64 - 2 * k


def _revcomp_np(dir_u: np.ndarray, k: int) -> np.ndarray:
    """Host rc code from an UNSHIFTED dir code (numpy):
    rc = (4^k - 1) - bitpair_reverse(dir)."""
    x = dir_u.astype(np.uint64)
    for bits, mask in (
        (32, 0xFFFFFFFF00000000),
        (16, 0xFFFF0000FFFF0000),
        (8, 0xFF00FF00FF00FF00),
        (4, 0xF0F0F0F0F0F0F0F0),
        (2, 0xCCCCCCCCCCCCCCCC),
    ):
        m = np.uint64(mask)
        x = ((x & m) >> np.uint64(bits)) | ((x & ~m) << np.uint64(bits))
    x >>= np.uint64(64 - 2 * k)
    full = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(2**64 - 1)
    return full - x


def dir_rc_kmers_np(codes: np.ndarray, k: int):
    """Host (numpy) per-position k-mer codes, both orientations:
    (udir, urc, valid), left-aligned u64."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, bool)
    sym = np.where(codes > 3, 0, codes).astype(np.uint64)

    def shift_index(arr, p):
        out = np.zeros_like(arr)
        out[p:] = arr[: len(arr) - p]
        return out

    powers = {1: sym}
    m = 1
    while 2 * m <= k:
        d = powers[m]
        powers[2 * m] = d | (shift_index(d, m) << np.uint64(2 * m))
        m *= 2
    res = powers[m]
    acc = m
    rem = k - m
    b = 1
    while rem:
        if rem & b:
            res = res | (shift_index(powers[b], acc) << np.uint64(2 * acc))
            acc += b
            rem &= ~b
        b <<= 1
    rc = _revcomp_np(res, k)
    shift = np.uint64(_shift_for(k))
    inv = (codes > 3).astype(np.int32)
    csum = np.cumsum(inv)
    csum_shift = np.zeros(n, np.int32)
    csum_shift[k:] = csum[:-k]
    valid = ((csum - csum_shift) == 0) & (np.arange(n) >= k - 1)
    return res << shift, rc << shift, valid


def canon_kmers_np(codes: np.ndarray, k: int):
    """Host canonical k-mers: (canon, valid), left-aligned u64. Native
    one-pass rolling kernel when the toolchain is available, numpy
    otherwise. Used by host splitter discovery and adaptive new-splitter
    discovery."""
    n = len(codes)
    if n < k:  # numpy twin returns empty arrays below one window
        z = np.zeros(0, np.uint64)
        return z, np.zeros(0, bool)
    lib = get_lib()
    if lib is not None and n:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        c = np.ascontiguousarray(codes)
        canon = np.empty(n, dtype=np.uint64)
        valid = np.empty(n, dtype=np.uint8)
        lib.kmer_canon_all(
            c.ctypes.data_as(u8p), n, k,
            canon.ctypes.data_as(u64p), valid.ctypes.data_as(u8p),
        )
        return canon, valid.astype(bool)
    udir, urc, valid = dir_rc_kmers_np(codes, k)
    return np.minimum(udir, urc), valid


def pack4_np(codes: np.ndarray) -> np.ndarray:
    """Host pack: u8[n] -> u8[(n+1)//2], low nibble first; >3 -> 15.
    Uses the GIL-free C++ packer when available."""
    n = len(codes)
    out = np.empty((n + 1) // 2, dtype=np.uint8)
    lib = get_lib()
    if lib is not None and n:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pack_nibbles(
            np.ascontiguousarray(codes).ctypes.data_as(u8p),
            n,
            out.ctypes.data_as(u8p),
        )
        return out
    c = np.where(codes > 3, 15, codes).astype(np.uint8)
    if n % 2:
        c = np.concatenate([c, np.full(1, 15, np.uint8)])
    return (c[0::2] | (c[1::2] << 4)).astype(np.uint8)


# ---------------------------------------------------------------------------
# membership tables and scan-vector decoding
# ---------------------------------------------------------------------------


def _decode_scan_vec(vec: np.ndarray, cap: int, table: "ScanTable"):
    """Host decode + exact verification of a u32 scan vector ->
    (count, pos i64[H], udir u64[H], urc u64[H]). ``count`` is the
    device's candidate count (drives the cap-overflow retry); the hits
    are exact (prefilter false positives removed by a binary search in
    the canonical table)."""
    k = table.k
    count = int(vec[0])
    cnt = min(count, cap)
    sl = slice(cap - cnt, cap)
    pos = vec[1 : 1 + cap][sl].astype(np.int64)
    dlo = vec[1 + cap : 1 + 2 * cap][sl].astype(np.uint64)
    dhi = vec[1 + 2 * cap : 1 + 3 * cap][sl].astype(np.uint64)
    dir_u = (dhi << np.uint64(32)) | dlo
    rc_u = _revcomp_np(dir_u, k)
    shift = np.uint64(_shift_for(k))
    canon = np.minimum(dir_u, rc_u) << shift
    tbl = table.canon_np
    ix = np.searchsorted(tbl, canon)
    ok = (ix < tbl.size) & (tbl[np.minimum(ix, tbl.size - 1)] == canon)
    return count, pos[ok], (dir_u << shift)[ok], (rc_u << shift)[ok]


def _decode_scan_vec_global(vec: np.ndarray, cap: int, table: "ScanTable",
                            n_per_row: int):
    """Decode + verify a global join vector -> (count, rows, pos, udir,
    urc) with rows/pos split out of the global positions."""
    count, gpos, udir, urc = _decode_scan_vec(vec, cap, table)
    return count, gpos // n_per_row, gpos % n_per_row, udir, urc


# tables with more entries than this are 'join' tables
_COMPARE_ALL_MAX = 8192


class ScanTable:
    """Membership table for the scan programs, resident on ``device``.

    kind 'cmp': unique XOR-mixes of both orientations' halves, padded to
    a power of two (min 128), for the fused scan kernel.
    kind 'join': the XOR-mixes ``hi ^ lo`` of agc_tpu's (hi, lo) half
    pairs of both orientations (large splitter sets), power-of-two padded
    (min 16384), for the join's member_mix.
    Both are SORTED by unsigned value (``tmix``, int32 bit patterns) for
    the kernels' binary search.
    canon_np: the sorted host canonical array, for exact verification.
    """

    __slots__ = ("kind", "k", "canon_np", "tmix")

    def __init__(self, kind, k, canon_np, tmix):
        self.kind = kind
        self.k = k
        self.canon_np = canon_np
        self.tmix = tmix


def make_scan_table(sorted_u64, k: int, device="cpu"):
    """Build the membership table from sorted left-aligned u64 canonical
    splitter codes. Returns a ScanTable or None for an empty set."""
    arr = np.asarray(sorted_u64, dtype=np.uint64)
    if arr.size == 0:
        return None
    shift = np.uint64(_shift_for(k))
    u = arr >> shift
    rc = _revcomp_np(u, k)
    low = np.uint64(0xFFFFFFFF)
    if arr.size <= _COMPARE_ALL_MAX:
        mixes = np.unique(
            np.concatenate(
                [(u & low) ^ (u >> np.uint64(32)), (rc & low) ^ (rc >> np.uint64(32))]
            )
        ).astype(np.uint32)
        b = 128
        while b < mixes.size:
            b <<= 1
        # pad value: arbitrary constant; a padding match is just another
        # prefilter false positive, removed by host verification
        tmix = np.full(b, 0xDEADBEEF, dtype=np.uint32)
        tmix[: mixes.size] = mixes
        return ScanTable("cmp", k, arr, u64.from_u32(np.sort(tmix), device))
    both = np.unique(np.concatenate([u, rc]))
    b = 1 << 14
    while b < both.size:
        b <<= 1
    # pad pairs: a fake table row (matches are false positives removed by
    # host verification), NOT an equal pair: the join keys on tlo ^ thi,
    # and an equal pair would mix to 0, the poly-A dir mix
    thi = np.full(b, 0xDEADBEEF, dtype=np.uint32)
    tlo = np.zeros(b, dtype=np.uint32)
    thi[: both.size] = (both >> np.uint64(32)).astype(np.uint32)
    tlo[: both.size] = (both & low).astype(np.uint32)
    return ScanTable("join", k, arr, u64.from_u32(np.sort(thi ^ tlo), device))


def scan_members_host(codes: np.ndarray, k: int, table):
    """Exact host membership scan: rolling canonical k-mer + one probe per
    window (native C++; numpy twin without a toolchain). Same result
    contract as ScanBatcher.collect: (pos, udir, urc) with ascending
    end-of-window positions and left-aligned u64 codes."""
    n = len(codes)
    empty = (
        np.empty(0, dtype=np.int64),
        np.empty(0, dtype=np.uint64),
        np.empty(0, dtype=np.uint64),
    )
    if table is None or n < k:
        return empty
    tbl = table.canon_np
    lib = get_lib()
    if lib is not None:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c = np.ascontiguousarray(codes)
        t = np.ascontiguousarray(tbl)
        cap = max(4096, n // 4096)
        while True:
            pos = np.empty(cap, dtype=np.int64)
            ud = np.empty(cap, dtype=np.uint64)
            ur = np.empty(cap, dtype=np.uint64)
            cnt = lib.kmer_scan_members(
                c.ctypes.data_as(u8p), n, k,
                t.ctypes.data_as(u64p), len(t),
                pos.ctypes.data_as(i64p), ud.ctypes.data_as(u64p),
                ur.ctypes.data_as(u64p), cap,
            )
            if cnt <= cap:
                return pos[:cnt], ud[:cnt], ur[:cnt]
            cap = cnt
    udir, urc, valid = dir_rc_kmers_np(codes, k)
    canon = np.minimum(udir, urc)
    ix = np.searchsorted(tbl, canon)
    ok = valid & (tbl[np.minimum(ix, tbl.size - 1)] == canon) & (ix < tbl.size)
    pos = np.nonzero(ok)[0].astype(np.int64)
    return pos, udir[pos], urc[pos]


# ---------------------------------------------------------------------------
# device scan programs
# ---------------------------------------------------------------------------

# Positions per scan row: contigs are cut into <= CHUNK pieces (k-1
# overlap) and bin-packed into CHUNK-wide rows.
CHUNK = 4 << 20
_MIN_BUCKET = 1 << 12
_SEAM = 32  # invalid symbols between packed parts (> max k - 1, even)
_SCAN_CAP = 256  # per-row hit cap for single-part rows
_PACK_CAP = 2048  # per-row hit cap for multi-part rows
_BATCH_SYMBOL_BUDGET = 32 << 20  # max symbols per batched dispatch
_FLUSH_SYMBOLS = 8 << 20  # buffered symbols that trigger a flush


def _bucket_size(n: int) -> int:
    """Power-of-two row width for a lone short row (at most CHUNK)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, CHUNK)


def scan_batch_compact_p4(packed2d: torch.Tensor, k: int, tmix: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """Batched scan against a compare-all ('cmp') table: packed2d
    uint8[B, n/2] nibble-packed rows -> int32[B, 1 + 3 * cap] hit
    vectors ([count, pos[cap], dlo[cap], dhi[cap]] per row). One launch
    of the fused-scan kernel on CUDA."""
    return scan_fused(packed2d, k, tmix, cap)


def scan_batch_join_global_p4(packed2d: torch.Tensor, k: int,
                              tmix: torch.Tensor, cap_total: int) -> torch.Tensor:
    """Batched large-table membership ('join' tables), the function of
    agc_tpu's sort-merge join: member = valid & (dlo ^ dhi) in the table's
    mixes. One dir_mix launch gives every position's halves, one
    member_mix launch tests the mixes against the sorted table; the
    compaction is torch ops.

    Returns ONE int32 vector over the whole batch:
        [count, gpos[cap_total] (ascending; fills lead), dlo[...], dhi[...]]
    where gpos = row * n + pos (see _decode_scan_vec_global); the last
    cap_total members are kept when count > cap_total, and fills are
    gpos = -1 with the dlo / dhi of flat position 0, as in agc_tpu."""
    b, half = packed2d.shape
    flat = b * 2 * half
    dlo, dhi, valid = dir_mix(packed2d, k)
    dlo = dlo.reshape(flat)
    dhi = dhi.reshape(flat)
    # collisions of the 32-bit mix are prefilter false positives, removed
    # by the host's exact verification
    member = member_mix(dlo ^ dhi, tmix) & valid.reshape(flat)
    hits = torch.nonzero(member).flatten()
    kept = hits[max(0, hits.numel() - cap_total):]
    gpos = torch.full((cap_total,), -1, dtype=torch.int64, device=packed2d.device)
    gpos[cap_total - kept.numel():] = kept
    safe = gpos.clamp(min=0)
    count = torch.tensor([hits.numel()], dtype=torch.int32, device=packed2d.device)
    return torch.cat([count, gpos.to(torch.int32), dlo[safe], dhi[safe]])


def _cap_total_for(rows: int, b: int) -> int:
    """Global hit cap for one join dispatch: pow2 of ~32 hits/row."""
    c = 2048
    want = min(rows * 32, 131072)
    while c < want:
        c <<= 1
    return min(c, rows * b)


def _dispatch_scan_batch(mat: np.ndarray, table: ScanTable, cap: int):
    """Upload a packed row matrix and scan it; returns (result np.uint32,
    is_global): 'cmp' tables give per-row vectors, 'join' tables one
    global-join vector for the whole dispatch."""
    with span("scan_upload"):
        packed = torch.from_numpy(mat).to(table.tmix.device)
    with span("scan_launch"):
        if table.kind == "cmp":
            out = scan_batch_compact_p4(packed, table.k, table.tmix, cap)
        else:
            rows, half = mat.shape
            out = scan_batch_join_global_p4(packed, table.k, table.tmix,
                                            _cap_total_for(rows, half * 2))
    with span("scan_download"):
        return u64.to_u32(out), table.kind != "cmp"


# ---------------------------------------------------------------------------
# splitter discovery
# ---------------------------------------------------------------------------


def collect_kmers_device_packed(contigs: list, k: int, device):
    """Canonical k-mers of all contigs in ONE kernel launch: contigs are
    laid out in one nibble-packed row at even offsets with _SEAM invalid
    symbols between them (windows touching a seam come out SENTINEL), and
    the row is canonized whole. Returns (canon_flat int64[L] on
    ``device``, placements) with placements[i] = (flat_start, n). The flat
    array doubles as the k-mer pool: sentinels sort to the end."""
    placements = []
    off = 0
    for c in contigs:
        placements.append((off, len(c)))
        off = (off + len(c) + _SEAM + 1) & ~1
    row = np.full(max(1, off // 2), 0xFF, dtype=np.uint8)
    for (start, _n), c in zip(placements, contigs):
        pk = pack4_np(np.ascontiguousarray(c))
        row[start // 2 : start // 2 + len(pk)] = pk
    packed = torch.from_numpy(row).to(device)
    return kmer_canon(packed[None, :], k)[0], placements


def sort_kmers(kmers: torch.Tensor) -> torch.Tensor:
    """Sort a flipped int64 k-mer pool (unsigned order; sentinels last)."""
    return torch.sort(kmers).values


def singleton_filter(sorted_kmers: torch.Tensor):
    """(singleton, first_of_dup) masks of a sorted array: values that
    occur exactly once, and the first value of each run of two or more
    (agc_tpu's singleton_filter; reference: remove_non_singletons,
    agc_compressor.cpp:664-705)."""
    x = sorted_kmers
    n = x.numel()
    ne_prev = torch.ones(n, dtype=torch.bool, device=x.device)
    if n > 1:
        ne_prev[1:] = x[1:] != x[:-1]
    ne_next = torch.ones(n, dtype=torch.bool, device=x.device)
    ne_next[:-1] = ne_prev[1:]
    return ne_prev & ne_next, ne_prev & ~ne_next


def candidate_tables(pool: torch.Tensor):
    """The candidate tables of a sorted flipped k-mer pool: (singletons,
    duplicated), the values that occur once and one of each value that
    occurs more often, both sorted, SENTINEL left out (agc_tpu's
    candidate_tables without its sentinel tails and counts)."""
    single, first_dup = singleton_filter(pool)
    live = pool != u64.SENTINEL
    return pool[single & live], pool[first_dup & live]


def _packed_row(codes: np.ndarray, device) -> torch.Tensor:
    """One contig as one nibble-packed row, uint8[1, ceil(n / 2)], on
    ``device``."""
    row = pack4_np(np.ascontiguousarray(codes))
    return torch.from_numpy(row).to(device)[None, :]


def contig_canon(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """Canonical code per position of one contig, int64[n] (SENTINEL where
    the window is not valid), in one kmer_canon launch."""
    return kmer_canon(_packed_row(codes, device), k)[0, : len(codes)]


def collect_kmers(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """All valid canonical k-mers of a contig, unsorted, on ``device``
    (agc_tpu's collect_kmers / contig_kmers: the same set of values; the
    contig goes whole through one kmer_canon launch, not in CHUNKs)."""
    if len(codes) < k:
        return torch.empty(0, dtype=torch.int64, device=device)
    canon = contig_canon(codes, k, device)
    return canon[canon != u64.SENTINEL]


def scan_contig(codes: np.ndarray, k: int, index, device):
    """The dense scan of a whole contig (agc_tpu's scan_contig): per
    position (canon, udir, urc, valid, member) as host numpy arrays, codes
    left-aligned u64. ``index``: the ``set_table`` of a set, or None for
    no set. One kmer_dir_rc launch."""
    n = len(codes)
    if n == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), z.copy(), np.zeros(0, bool), np.zeros(0, bool)
    udir, urc, valid, member = kmer_dir_rc(_packed_row(codes, device), k, index)
    udir = u64.to_u64(udir[0, :n])
    urc = u64.to_u64(urc[0, :n])
    valid = valid[0, :n].cpu().numpy()
    member = np.zeros(n, bool) if member is None else member[0, :n].cpu().numpy()
    return np.minimum(udir, urc), udir, urc, valid, member


# ---------------------------------------------------------------------------
# value-sampled discovery (references over Compressor._POOL_DEVICE_MAX)
# ---------------------------------------------------------------------------

_MURMUR_C1 = 0xFF51AFD7ED558CCD - (1 << 64)  # as int64
_MURMUR_C2 = 0xC4CEB9FE1A85EC53 - (1 << 64)


def sample_keep(canon: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """The value sample of agc_tpu's sample_compact_kmers: True where
    ``canon`` (flipped int64) is a k-mer, not SENTINEL, whose murmur64
    finalizer hash has its top ``frac_bits`` bits 0. The hash keys on the
    value, so every occurrence of a k-mer is kept or dropped together.

    The hash runs on the raw unsigned value (the flip undone). torch's
    int64 multiply returns the low 64 bits of the two's-complement
    product, and those are the unsigned product modulo 2^64, so the
    finalizer's multiplies are exact; its right shifts are logical
    (``u64.lsr``)."""
    if not 1 <= frac_bits <= 63:
        raise ValueError(f"frac_bits must be in [1, 63], got {frac_bits}")
    h = u64.flip(canon)
    h = h ^ u64.lsr(h, 33)
    h = h * _MURMUR_C1
    h = h ^ u64.lsr(h, 33)
    h = h * _MURMUR_C2
    h = h ^ u64.lsr(h, 33)
    return (u64.lsr(h, 64 - frac_bits) == 0) & (canon != u64.SENTINEL)


def chunk_slices(n: int, k: int) -> list[tuple[int, int]]:
    """The [keep_from, real) slices of agc_tpu's collect_kmers_device
    plan in contig coordinates: windows of CHUNK symbols with k-1
    overlap, so the slices tile [0, n) without overlap."""
    out = []
    start = 0
    while n >= k and start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + CHUNK, n)
        out.append((start, end))
        start = end
    return out


def sample_bucket(n: int, frac_bits: int) -> int:
    """Sampled values kept of an n-position chunk: the pow2 >= 1.25 x the
    expected count, at least 1024 (agc_tpu's out_bucket)."""
    want = max(1024, (n >> frac_bits) + (n >> (frac_bits + 2)))
    b = 1024
    while b < want:
        b <<= 1
    return b


def sample_kmers(canon: torch.Tensor, n: int, k: int, frac_bits: int) -> list:
    """Value-sampled k-mers of one contig, per CHUNK slice: the values
    ``sample_keep`` keeps, and where a slice keeps more than its
    ``sample_bucket``, only its smallest that many (agc_tpu's per-chunk
    sort and truncation). ``canon``: the whole contig's canonical codes
    from one kmer_canon launch (a chunk's windows are the whole contig's
    windows, so the slices equal agc_tpu's chunk records). Returns
    unsorted int64 tensors, one per slice."""
    slices = chunk_slices(n, k)
    if not slices:
        return []
    canon = canon[:n]
    keep = sample_keep(canon, frac_bits)
    counts = torch.stack([keep[s:e].sum() for s, e in slices]).tolist()
    vals = canon[keep]  # position order: each slice's values are contiguous
    parts, off = [], 0
    for (s, e), c in zip(slices, counts):
        v = vals[off : off + c]
        off += c
        cap = sample_bucket(e - s, frac_bits)
        if c > cap:  # a repeat that hashes in overflows this slice
            v = torch.sort(v).values[:cap]
        parts.append(v)
    return parts


def find_splitter_emissions_packed(canon_flat: torch.Tensor, placements,
                                   k: int, pool: torch.Tensor, seg_size: int,
                                   index=None):
    """Greedy singleton emissions for every placed contig in ONE launch of
    the greedy-walk kernel. Returns per contig (pos i64[E], kmers u64[E],
    tail_pos or None, tail_kmer), like agc_tpu's
    find_splitter_emissions_packed. ``index``: the pool's walk_index, when
    the caller has built it. Over a pool that holds each value once the
    singleton walk is the membership walk of agc_tpu's
    find_splitter_emissions over that table."""
    # the host walk enforces >= seg_size and >= k spacing (the reference
    # resets its rolling k-mer at each cut); 1 covers format-1.x archives
    seg = max(1, seg_size, k)
    empty = (np.empty(0, np.int64), np.empty(0, np.uint64), None, 0)
    results: list = [empty] * len(placements)
    idx = [i for i, (_s, n) in enumerate(placements) if n >= k]
    if not idx:
        return results
    cap = max(placements[i][1] // seg + 2 for i in idx)
    dev = canon_flat.device
    starts = torch.tensor([placements[i][0] for i in idx], dtype=torch.int64, device=dev)
    reals = torch.tensor([placements[i][1] for i in idx], dtype=torch.int64, device=dev)
    vecs = greedy_walk(canon_flat, starts, reals, pool, seg, cap, index=index).cpu()
    for row, i in enumerate(idx):
        vec = vecs[row]
        count = int(vec[0])
        pos = vec[1 : 1 + count].numpy().astype(np.int64)
        kms = u64.to_u64(vec[1 + cap : 1 + cap + count])
        t_tail = int(vec[1 + 2 * cap])
        if t_tail < placements[i][1]:
            results[i] = (pos, kms, t_tail, u64.to_u64(vec[2 + 2 * cap : 3 + 2 * cap])[0])
        else:
            results[i] = (pos, kms, None, 0)
    return results


# ---------------------------------------------------------------------------
# the batched scan pipeline
# ---------------------------------------------------------------------------

# every DaemonPool registers here; an atexit hook stops them (bounded)
# so workers leave their loops before interpreter finalization
_ALL_POOLS: list = []


def _stop_all_pools():
    for p in list(_ALL_POOLS):
        p.stop(timeout=10.0)


atexit.register(_stop_all_pools)


class DaemonPool:
    """Minimal executor over DAEMON threads (submit -> Future): a job
    still running at interpreter exit does not hold the process."""

    def __init__(self, n: int, name: str):
        import queue
        import threading as _th

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads = []
        for i in range(n):
            t = _th.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            t.start()
            self._threads.append(t)
        _ALL_POOLS.append(self)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:  # stop sentinel
                return
            fut, fn, args, kw = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kw))
            except BaseException as e:  # noqa: BLE001 - mirrored to Future
                fut.set_exception(e)

    def stop(self, timeout: float = 10.0) -> None:
        """Send stop sentinels and join (bounded), then deregister."""
        for _ in self._threads:
            self._q.put(None)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        try:
            _ALL_POOLS.remove(self)
        except ValueError:
            pass

    def submit(self, fn, *args, **kw):
        from concurrent.futures import Future

        fut = Future()
        self._q.put((fut, fn, args, kw))
        return fut


_XFER_POOL = None
_XFER_LOCK = threading.Lock()


def _xfer_pool():
    """One daemon worker for pack + upload + scan + download, so the
    matcher thread keeps working while a batch is on the device. Shared
    by every engine of the process (thread shards of a sharded create
    too), so it is made under a lock."""
    global _XFER_POOL
    with _XFER_LOCK:
        if _XFER_POOL is None:
            _XFER_POOL = DaemonPool(1, "agc-xfer")
        return _XFER_POOL


class ScanBatcher:
    """Groups contig scans into batched multi-row dispatches.

    add() splits each contig into <= CHUNK pieces (k-1 overlap) and
    buffers them; flush() bin-packs the pieces into CHUNK-wide rows
    (first-fit decreasing, _SEAM invalid symbols between parts) and hands
    each batch of rows (<= _BATCH_SYMBOL_BUDGET symbols) to the transfer
    worker, which packs, uploads, scans and downloads the compact result.
    collect() resolves a token's pieces from their rows, retrying a row
    (or a join dispatch) whose hit count overflowed its cap.

    ``table`` is a make_scan_table() ScanTable (or None for no
    splitters); it lives on the device the scans run on. ``timers``, a
    StageTimers, counts the dispatches, their rows, and the symbols
    against the rows' capacity (the fill).
    """

    def __init__(self, k: int, table, timers=None):
        self.k = k
        self.table = table
        self.timers = timers
        self._buf: list[dict] = []
        self._pending_syms = 0
        self._dl_cache: dict = {}
        # per-dispatch cache of cap-overflow re-runs (see collect)
        self._retry_cache: dict = {}

    def add(self, codes: np.ndarray):
        """Returns a token dict resolved at flush/collect time."""
        n = len(codes)
        token = {"kind": "parts", "n": n, "parts": [], "codes": codes}
        if n < self.k or self.table is None:
            token["kind"] = "empty"
            return token
        start = 0
        while start < n:
            lo = max(0, start - (self.k - 1))
            end = min(lo + CHUNK, n)
            part = {
                "start": start,
                "lo": lo,
                "real": end - lo,
                "codes": np.ascontiguousarray(codes[lo:end]),
            }
            token["parts"].append(part)
            self._buf.append(part)
            self._pending_syms += end - lo
            start = end
        if self._pending_syms >= _FLUSH_SYMBOLS:
            self.flush()
        return token

    def flush(self) -> None:
        """Bin-pack the buffered parts into CHUNK-wide rows and dispatch
        them; a small last row gets its own pow2-width dispatch."""
        if not self._buf:
            return
        parts = self._buf
        self._buf = []
        self._pending_syms = 0
        parts.sort(key=lambda p: -len(p["codes"]))
        rows: list[list] = []  # each: list of (part, offset)
        used: list[int] = []
        for part in parts:
            n = len(part["codes"])
            placed = False
            for r, u in enumerate(used):
                off = (u + _SEAM + 1) & ~1  # even offset (nibble packing)
                if off + n <= CHUNK:
                    rows[r].append((part, off))
                    used[r] = off + n
                    placed = True
                    break
            if not placed:
                rows.append([(part, 0)])
                used.append(n)

        tail = None
        if rows and used[-1] <= CHUNK // 2:
            tail = (rows.pop(), used.pop())

        max_rows = max(1, _BATCH_SYMBOL_BUDGET // CHUNK)
        for s in range(0, len(rows), max_rows):
            group = rows[s : s + max_rows]
            multi = any(len(r) > 1 for r in group)
            self._submit(group, CHUNK, min(_PACK_CAP if multi else _SCAN_CAP, CHUNK))
        if tail is not None:
            row, u = tail
            width = _bucket_size(u)
            cap = min(_PACK_CAP if len(row) > 1 else _SCAN_CAP, width)
            self._submit([row], width, cap)

    def _submit(self, group_rows, width: int, cap: int) -> None:
        table = self.table
        if self.timers is not None:
            self.timers.count("scan_dispatches")
            self.timers.count("scan_rows", len(group_rows))
            self.timers.count("scan_symbols", sum(len(part["codes"]) for row in group_rows
                                                  for part, _ in row))
            self.timers.count("scan_capacity", len(group_rows) * width)

        def job():
            with span("scan_pack"):
                mat = np.full((len(group_rows), width // 2), 0xFF, dtype=np.uint8)
                for r, row in enumerate(group_rows):
                    for part, off in row:
                        pk = pack4_np(part.pop("codes"))
                        mat[r, off // 2 : off // 2 + len(pk)] = pk
            return _dispatch_scan_batch(mat, table, cap), mat

        fut = _xfer_pool().submit(job)
        for r, row in enumerate(group_rows):
            for part, off in row:
                part["out"] = fut
                part["row"] = r
                part["offset"] = off
                part["cap"] = cap
                part["rows"] = len(group_rows)
                part["bucket"] = width

    def _resolve(self, fut):
        """(result, is_global, packed_mat) of a dispatch, cached briefly.
        Keyed by the future OBJECT (a strong reference), so recycled ids
        never alias."""
        hit = self._dl_cache.get(fut)
        if hit is None:
            (res, is_global), mat = fut.result()
            hit = (res, is_global, mat)
            if len(self._dl_cache) >= 8:
                self._dl_cache.pop(next(iter(self._dl_cache)))
            self._dl_cache[fut] = hit
        return hit

    def _device(self):
        return self.table.tmix.device

    def collect(self, token):
        """Resolve a token to (pos, udir, urc)."""
        if token["kind"] == "precomputed":
            # hits known without a scan (the discovery reference's own
            # contigs: splitters are singletons at recorded positions)
            return token["hits"]
        if token["kind"] == "empty":
            return (
                np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.uint64),
                np.empty(0, dtype=np.uint64),
            )
        all_pos, all_dir, all_rc = [], [], []
        for part in token["parts"]:
            if "out" not in part:
                self.flush()
            res, is_global, packed_mat = self._resolve(part["out"])
            cap = part["cap"]
            if is_global:
                b = part["bucket"]
                cap_total = _cap_total_for(part["rows"], b)
                count, rows_arr, pos, udir, urc = _decode_scan_vec_global(
                    res, cap_total, self.table, b
                )
                if count > cap_total and cap_total < part["rows"] * b:
                    # rare cap overflow: one re-run per DISPATCH (all its
                    # parts share the future), cached on it
                    retry = self._retry_cache.get(part["out"])
                    if retry is None:
                        cap_total = min(
                            1 << int(np.ceil(np.log2(count))), part["rows"] * b
                        )
                        packed = torch.from_numpy(packed_mat).to(self._device())
                        vec = u64.to_u32(
                            scan_batch_join_global_p4(
                                packed, self.table.k, self.table.tmix, cap_total
                            )
                        )
                        if len(self._retry_cache) >= 8:
                            self._retry_cache.pop(next(iter(self._retry_cache)))
                        self._retry_cache[part["out"]] = (vec, cap_total)
                    else:
                        vec, cap_total = retry
                    count, rows_arr, pos, udir, urc = _decode_scan_vec_global(
                        vec, cap_total, self.table, b
                    )
                m = rows_arr == part["row"]
                pos, udir, urc = pos[m], udir[m], urc[m]
            else:
                vec = res[part["row"]]
                count, pos, udir, urc = _decode_scan_vec(vec, cap, self.table)
                if count > cap and cap < part["bucket"]:
                    # rare cap overflow: re-scan the row at the next power
                    # of two >= count
                    cap = min(1 << int(np.ceil(np.log2(count))), part["bucket"])
                    row = torch.from_numpy(
                        np.ascontiguousarray(packed_mat[part["row"] : part["row"] + 1])
                    ).to(self._device())
                    vec = u64.to_u32(
                        scan_batch_compact_p4(row, self.table.k, self.table.tmix, cap)
                    )[0]
                    count, pos, udir, urc = _decode_scan_vec(vec, cap, self.table)
            part.pop("out", None)
            off = part.get("offset", 0)  # row-packed parts sit at an offset
            keep_from = part["start"] - part["lo"]
            m = (pos >= off + keep_from) & (pos < off + part["real"])
            all_pos.append(pos[m] - off - keep_from + part["start"])
            all_dir.append(udir[m])
            all_rc.append(urc[m])
        return (
            np.concatenate(all_pos),
            np.concatenate(all_dir),
            np.concatenate(all_rc),
        )
