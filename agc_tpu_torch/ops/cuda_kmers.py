"""The port's k-mer kernels: CUDA wrappers and their plain PyTorch versions.

Counterpart of ``agc_tpu/ops/pallas_kmers.py``. Five kernel sources in
``agc_tpu_torch/csrc``, each with a note on what it replaces, what bounds
it on the H100 and what its design does about that:

- ``scan_fused``  (csrc/scan_fused.cu): the whole ``scan_batch_compact_p4``
  (unpack, direct-code ladder, XOR-mix, table membership, hit compaction);
  replaces the Pallas ``scan_fused_pallas`` plus the XLA unpack and top_k.
- ``kmer_canon``  (csrc/kmer_canon.cu): the canonical pool fill of
  splitter discovery; replaces the Pallas ``kmer_halves_pallas`` /
  ``kmer_core_via_pallas`` plus the ``canon_rows_p4`` epilogue.
- ``kmer_dir_rc`` (csrc/kmer_canon.cu): all of ``kmer_halves_pallas``'s
  outputs, the direct and reverse-complement codes a position, with the
  valid flag and, given a set, membership in it: the dense scan of -f
  (agc_tpu's ``contig_kmers_dir_rc`` / ``_with_membership``). The set is
  looked up in a ``SetTable`` that ``set_table`` (same source) builds once
  a set: one 32-byte bucket of four slots a lookup, a second table for what
  the buckets spill, and a sorted tail (``set_table_plain`` /
  ``set_lookup_plain`` are its plain model).
- ``greedy_walk`` (csrc/greedy_walk.cu): the singleton greedy splitter
  walk; replaces the XLA ``lax.while_loop`` ``_greedy_over_canon``. Its
  lookups go through an index of the pool's singletons that
  ``walk_index`` (same source) builds once a pool.
- ``member_mix``  (csrc/member_mix.cu): membership of precomputed XOR-mixes
  in a sorted mix table; replaces the Pallas ``member_mix_pallas``, and is
  the membership stage of the large-table join.
- ``dir_mix``     (csrc/dir_mix.cu): the direct code's 32-bit halves and
  the valid flag per position, which the large-table join reads; replaces
  the XLA ``_dir_halves`` ladder of ``scan_batch_join_global_p4``.

``scan_fused`` and ``member_mix`` test a mix the same way
(csrc/kmer_common.cuh, ``MixSet``): a 2^20-bit filter in shared memory
rejects most non-members with two loads, and only the mixes that pass are
searched, in one bucket of a directory of the table's top bits.
``mix_filter_plain`` and ``mix_dir_plain`` are the plain model of both
structures, ``mix_set_plain`` of the test, and ``mix_set_built`` returns
the structures a block of the card holds.

A wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel, or raises: nothing falls back. Each
wrapper counts its kernel launches in ``LAUNCHES`` (reset with
``reset_launches``), so a run can show it went through the kernels.

Conventions (``ops/u64.py``): k-mer codes are int64 with bit 63 flipped
(``SENTINEL`` = INT64_MAX); 32-bit words are int32 bit patterns.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from . import u64

_MAX_TABLE = 16384  # scan_fused's table limit: the largest 'cmp' table

# csrc/kmer_common.cuh's MixSet: filter bits, hash multipliers, directory
MIX_FILTER_LOG2 = 20
MIX_C1 = 0x9E3779B1
MIX_C2 = 0x85EBCA77
_MIX_DIR_MAX_BITS = 14

LAUNCHES = {"scan_fused": 0, "kmer_canon": 0, "kmer_dir_rc": 0, "set_table": 0,
            "walk_index": 0,
            "greedy_walk": 0, "member_mix": 0, "dir_mix": 0,
            # counted by ops/cuda_match.py and ops/device_rans.py
            "match_estimate": 0, "rans_tables": 0, "rans_encode": 0, "rans_layout": 0,
            "rans_write": 0, "rans_decode": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        _require(t.is_cuda, f"{name}: every tensor must be on the same CUDA device")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        _require(t.device == tensors[0].device, f"{name}: mixed devices")


# ---------------------------------------------------------------------------
# shared plain building blocks
# ---------------------------------------------------------------------------


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Nibble unpack: u8[..., m] -> u8[..., 2m] symbols (15 = invalid)."""
    lo = packed & 15
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def rolling_codes(codes: torch.Tensor, k: int, with_rc: bool):
    """Unshifted per-position codes of the window ending at each position,
    as int64 bit patterns: dir = sum_t sym[i-t] * 4^t and (optionally)
    rc = sum_t (3 - sym[i-t]) * 4^(k-1-t). Invalid symbols, and symbols
    before the row's start, count as 0 in dir and as 3 in rc, so rc is
    always dir's reverse complement (agc_tpu's ``_kmer_core``); codes at
    invalid windows are meaningless to discovery (see ``valid_windows``)."""
    n = codes.shape[-1]
    sym = torch.where(codes > 3, 0, codes).to(torch.int64)
    d = torch.zeros_like(sym)
    r = torch.zeros_like(sym) if with_rc else None
    for t in range(k):
        if t < n:
            src = sym[..., : n - t]
            d[..., t:] |= src << (2 * t)
            if with_rc:
                r[..., t:] |= (3 - src) << (2 * (k - 1 - t))
        if with_rc:
            r[..., : min(t, n)] |= torch.tensor(3, dtype=torch.int64) << (2 * (k - 1 - t))
    return d, r


def valid_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """True where the k-window ending at a position holds k valid symbols
    inside the row (the ``valid`` of agc_tpu's ``_dir_halves``)."""
    n = codes.shape[-1]
    csum = torch.cumsum((codes > 3).to(torch.int32), dim=-1)
    shifted = torch.zeros_like(csum)
    if n > k:
        shifted[..., k:] = csum[..., : n - k]
    idx = torch.arange(n, device=codes.device)
    return (csum == shifted) & (idx >= k - 1)


def dir_halves(codes: torch.Tensor, k: int):
    """(dlo, dhi, valid): the direct code's 32-bit halves as int32 bit
    patterns (lo = the 16 most recent symbols) and the valid flag."""
    d, _ = rolling_codes(codes, k, with_rc=False)
    return u64.low32(d), u64.high32(d), valid_windows(codes, k)


# ---------------------------------------------------------------------------
# scan_fused
# ---------------------------------------------------------------------------


def _hits_out(member, dlo, dhi, cap: int) -> torch.Tensor:
    """[count, pos[cap] ascending with leading fills, dlo[cap], dhi[cap]]
    per row; the last cap hits when count > cap; fills are pos = -1 and
    dlo = dhi = 0."""
    b, n = member.shape
    count = member.sum(dim=1, dtype=torch.int64)
    iota = torch.arange(n, device=member.device, dtype=torch.int64)
    keyed = torch.where(member, iota.expand(b, n), -1)
    pos = torch.topk(keyed, cap, dim=1).values.flip(1)
    safe = pos.clamp(min=0)
    fill = pos < 0
    lo = torch.where(fill, 0, dlo.gather(1, safe))
    hi = torch.where(fill, 0, dhi.gather(1, safe))
    return torch.cat(
        [count[:, None].to(torch.int32), pos.to(torch.int32), lo, hi], dim=1
    )


def scan_fused_plain(packed2d: torch.Tensor, k: int, table: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Plain version of ``scan_fused`` (agc_tpu's scan_batch_compact_p4)."""
    codes = unpack4(packed2d)
    dlo, dhi, valid = dir_halves(codes, k)
    member = valid & torch.isin(dlo ^ dhi, table)
    return _hits_out(member, dlo, dhi, cap)


def scan_fused(packed2d: torch.Tensor, k: int, table: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Batched membership scan of nibble-packed rows.

    packed2d: uint8[B, n/2]; table: int32[T] XOR-mix table, sorted by
    unsigned value (``ScanTable.tmix``), T <= 16384; returns
    int32[B, 1 + 3 * cap] hit vectors, agc_tpu's ``_scan_compact_body``
    layout."""
    _require(packed2d.dim() == 2 and packed2d.dtype == torch.uint8,
             "scan_fused: packed2d must be uint8[B, n/2]")
    _require(table.dtype == torch.int32 and table.dim() == 1,
             "scan_fused: table must be int32[T]")
    _require(1 <= k <= 32, "scan_fused: k must be in [1, 32]")
    b, half = packed2d.shape
    _require(1 <= cap <= 2 * half, "scan_fused: cap must be in [1, n]")
    if packed2d.device.type == "cpu":
        return scan_fused_plain(packed2d, k, table, cap)
    _check_cuda("scan_fused", packed2d, table)
    t = table.numel()
    _require(1 <= t <= _MAX_TABLE, f"scan_fused: table size {t} not in [1, {_MAX_TABLE}]")
    _require(2 * half < (1 << 31), "scan_fused: rows must be < 2^31 positions")
    lib = _build.lib()
    tile = lib.agc_scan_fused_tile()
    n_tiles = -(-2 * half // tile)
    # the MixSet image; per tile: its hit count, its offset in the row,
    # one hit mask a thread
    scratch = torch.empty(lib.agc_mix_set_words(t) + b * n_tiles * (2 + tile // 32),
                          dtype=torch.int32, device=packed2d.device)
    out = torch.empty((b, 1 + 3 * cap), dtype=torch.int32, device=packed2d.device)
    with torch.cuda.device(packed2d.device):
        rc = lib.agc_scan_fused(
            packed2d.data_ptr(), b, half, k, table.data_ptr(), t, cap,
            scratch.data_ptr(), out.data_ptr(), _stream(packed2d),
        )
    _build.check(rc, "scan_fused")
    _count("scan_fused")
    return out


# ---------------------------------------------------------------------------
# kmer_canon
# ---------------------------------------------------------------------------


def kmer_canon_plain(packed2d: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of ``kmer_canon``."""
    codes = unpack4(packed2d)
    d, r = rolling_codes(codes, k, with_rc=True)
    sh = 64 - 2 * k
    canon = torch.minimum(u64.flip(d << sh), u64.flip(r << sh))
    return torch.where(valid_windows(codes, k), canon, u64.SENTINEL)


def kmer_canon(packed2d: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mer per position of nibble-packed rows.

    packed2d: uint8[B, n/2]; returns int64[B, n], the flipped
    left-aligned ``min(dir, rc)`` where the window is valid and
    ``SENTINEL`` elsewhere."""
    _require(packed2d.dim() == 2 and packed2d.dtype == torch.uint8,
             "kmer_canon: packed2d must be uint8[B, n/2]")
    _require(1 <= k <= 32, "kmer_canon: k must be in [1, 32]")
    if packed2d.device.type == "cpu":
        return kmer_canon_plain(packed2d, k)
    _check_cuda("kmer_canon", packed2d)
    b, half = packed2d.shape
    out = torch.empty((b, 2 * half), dtype=torch.int64, device=packed2d.device)
    with torch.cuda.device(packed2d.device):
        rc = _build.lib().agc_kmer_canon(
            packed2d.data_ptr(), b, half, k, out.data_ptr(), _stream(packed2d)
        )
    _build.check(rc, "kmer_canon")
    _count("kmer_canon")
    return out


# ---------------------------------------------------------------------------
# kmer_dir_rc
# ---------------------------------------------------------------------------


def isin_sorted(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """values in the sorted ``table`` (both flipped int64), by
    ``searchsorted``."""
    if table.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    ix = torch.searchsorted(table, values).clamp(max=table.numel() - 1)
    return table[ix] == values


def kmer_dir_rc_plain(packed2d: torch.Tensor, k: int, index=None):
    """Plain version of ``kmer_dir_rc``: ``rolling_codes`` and
    ``valid_windows`` of the unpacked rows, membership by
    ``searchsorted`` in the set (``index.values``)."""
    codes = unpack4(packed2d)
    d, r = rolling_codes(codes, k, with_rc=True)
    sh = 64 - 2 * k
    udir, urc = u64.flip(d << sh), u64.flip(r << sh)
    valid = valid_windows(codes, k)
    member = None
    if index is not None:
        member = valid & isin_sorted(torch.minimum(udir, urc), index.values)
    return udir, urc, valid, member


def _set_args(index) -> tuple:
    """agc_kmer_dir_rc's set arguments: both tables and the tail, or
    nulls without a set."""
    if index is None:
        return (None, 1, 1, None, 1, 1, None, 0)
    return (index.first.buckets.data_ptr(), index.first.hash, index.first.bits,
            index.second.buckets.data_ptr(), index.second.hash, index.second.bits,
            index.tail.data_ptr() if index.tail.numel() else None, index.tail.numel())


def kmer_dir_rc(packed2d: torch.Tensor, k: int, index=None):
    """Both orientations' codes per position of nibble-packed rows.

    packed2d: uint8[B, n/2]; index: the ``SetTable`` of a set (``set_table``),
    or None. Returns (udir, urc, valid, member): int64[B, n] flipped
    left-aligned codes at every position (agc_tpu's ``_kmer_core``),
    bool[B, n] valid windows, and bool[B, n] ``valid & (min(udir, urc) in
    the set)``, or None without a set."""
    _require(packed2d.dim() == 2 and packed2d.dtype == torch.uint8,
             "kmer_dir_rc: packed2d must be uint8[B, n/2]")
    _require(1 <= k <= 32, "kmer_dir_rc: k must be in [1, 32]")
    _require(index is None or isinstance(index, SetTable),
             "kmer_dir_rc: index must be a SetTable (set_table)")
    if packed2d.device.type == "cpu":
        return kmer_dir_rc_plain(packed2d, k, index)
    _check_cuda("kmer_dir_rc", packed2d)
    if index is not None:
        _check_cuda("kmer_dir_rc", packed2d, index.first.buckets, index.second.buckets,
                    index.tail)
        for level in (index.first, index.second):
            _require(level.buckets.dtype == torch.int64
                     and level.buckets.numel() == SET_SLOTS << level.bits
                     and level.buckets.data_ptr() % 16 == 0 and level.hash & 1,
                     "kmer_dir_rc: index is not a set_table")
    b, half = packed2d.shape
    dev = packed2d.device
    udir = torch.empty((b, 2 * half), dtype=torch.int64, device=dev)
    urc = torch.empty((b, 2 * half), dtype=torch.int64, device=dev)
    valid = torch.empty((b, 2 * half), dtype=torch.bool, device=dev)
    member = None if index is None else torch.empty((b, 2 * half), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().agc_kmer_dir_rc(
            packed2d.data_ptr(), b, half, k, udir.data_ptr(), urc.data_ptr(),
            valid.data_ptr(), None if member is None else member.data_ptr(),
            *_set_args(index), _stream(packed2d),
        )
    _build.check(rc, "kmer_dir_rc")
    _count("kmer_dir_rc")
    return udir, urc, valid, member


# ---------------------------------------------------------------------------
# set_table: the tables kmer_dir_rc looks a set up in
# ---------------------------------------------------------------------------

SET_SLOTS = 4  # csrc/kmer_canon.cu's kSetSlots: int64 slots a bucket
# csrc/kmer_canon.cu's build: buckets of a slice (kSetSliceBits), values a
# slice's block sorts in shared memory (kSliceCap; a slice of more goes
# through the atomicMin chains), values a partition block stages at once
# (kPartChunk), bins of a partition level (kPartMaxBits); a table of up to
# SET_DIRECT_SLICES slices is not partitioned. _set_level checks them all
# against the library's (agc_set_build_constants) before a build.
SET_SLICE_BITS = 11
SET_SLICE_CAP = (28 << SET_SLICE_BITS) // 8
SET_PART_CHUNK = 4096
SET_PART_MAX_BITS = 10
SET_DIRECT_SLICES = 4
# the odd multipliers of the two tables' hashes (golden ratio, murmur3's c1)
SET_HASH = (0x9E3779B97F4A7C15, 0xFF51AFD7ED558CCD)


@dataclass(frozen=True)
class SetLevel:
    """One table of a set (csrc/kmer_canon.cu): ``buckets``
    int64[4 << bits], bucket h at [4h, 4h + 4) holding the four smallest
    values whose ``set_bucket`` is h in ascending order, then SENTINEL;
    ``hash``, the odd multiplier of its hash."""

    buckets: torch.Tensor
    bits: int
    hash: int


@dataclass(frozen=True)
class SetTable:
    """A set of flipped int64 codes as ``kmer_dir_rc`` looks it up:
    ``first``, its table; ``second``, the table of what the first's
    buckets spill; ``tail``, what the second's spill, sorted; ``values``,
    the set itself, sorted (the plain version searches it)."""

    first: SetLevel
    second: SetLevel
    tail: torch.Tensor
    values: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Bytes of the tables: buckets and the tail."""
        return 8 * (self.first.buckets.numel() + self.second.buckets.numel()
                    + self.tail.numel())

    @property
    def n_spilled(self) -> int:
        """The values past the first table's buckets."""
        return int((self.second.buckets != u64.SENTINEL).sum()) + self.tail.numel()


def set_bits(n: int) -> int:
    """Bucket bits for an n-value set: ceil(log2 n) - 1, at least 1, so 1
    to 2 values a four-slot bucket, and the table (16 to 32 bytes a value)
    at most twice a walk index of the same set (``index_bits``: 12 to 16
    bytes a value up to its 2^30-entry directory)."""
    return max(1, (n - 1).bit_length() - 1)


def set_bucket(values: torch.Tensor, bits: int, mult: int = SET_HASH[0]) -> torch.Tensor:
    """The bucket of each flipped code: the top ``bits`` bits of
    ``(v ^ (v >> 32)) * mult`` mod 2^64 (the kernel's set_bucket; int64
    products wrap as uint64 ones do)."""
    signed = mult - (1 << 64) if mult >= 1 << 63 else mult
    return u64.lsr((values ^ u64.lsr(values, 32)) * signed, 64 - bits)


def set_level_plain(values: torch.Tensor, bits: int, mult: int):
    """Plain version of one table's build: (the ``SetLevel`` of 2^bits
    buckets, the sorted values past each bucket's four). The values
    (SENTINEL dropped) sorted by (bucket, value); a value's slot is its
    rank in its bucket."""
    v = torch.sort(values[values != u64.SENTINEL]).values
    h, order = torch.sort(set_bucket(v, bits, mult), stable=True)
    v = v[order]
    rank = torch.arange(v.numel(), device=v.device) - torch.searchsorted(h, h)
    keep = rank < SET_SLOTS
    buckets = torch.full((SET_SLOTS << bits,), u64.SENTINEL, dtype=torch.int64,
                         device=values.device)
    buckets[h[keep] * SET_SLOTS + rank[keep]] = v[keep]
    return SetLevel(buckets, bits, mult), torch.sort(v[~keep]).values


def set_table_plain(values: torch.Tensor) -> SetTable:
    """Plain version of ``set_table``: the first table, the second over its
    spill (twice the buckets: 0.5-1 value a bucket), the tail."""
    first, spill = set_level_plain(values, set_bits(values.numel()), SET_HASH[0])
    second, tail = set_level_plain(spill, set_bits(spill.numel()) + 1, SET_HASH[1])
    return SetTable(first, second, tail, values)


def _level_lookup(level: SetLevel, codes: torch.Tensor):
    """(hit, spill) of codes in one table: in its bucket's four slots; or
    not, and above the last slot of a full bucket."""
    rows = level.buckets.view(-1, SET_SLOTS)[set_bucket(codes, level.bits, level.hash)]
    hit = (rows == codes[..., None]).any(dim=-1)
    last = rows[..., -1]
    return hit, ~hit & (last != u64.SENTINEL) & (codes > last)


def set_lookup_plain(table: SetTable, codes: torch.Tensor) -> torch.Tensor:
    """Plain model of the kernel's lookup: the first table's bucket; for a
    spill, the second's; for its spill, the tail. Equal to
    ``isin_sorted(codes, set)`` for codes that are not SENTINEL; SENTINEL
    is never a member."""
    hit, spill = _level_lookup(table.first, codes)
    hit2, spill2 = _level_lookup(table.second, codes)
    hit = hit | (spill & (hit2 | (spill2 & isin_sorted(codes, table.tail))))
    return hit & (codes != u64.SENTINEL)


def set_partition_plan(n: int, bits: int) -> list:
    """The partition levels that move an n-value set to the slices of a
    2^bits-bucket table before the build: [] for a table of up to
    ``SET_DIRECT_SLICES`` slices (each slice's block reads the whole set),
    else one level of at most 2^``SET_PART_MAX_BITS`` bins, or two. A level
    is (pbits, shift, segs, q): bins are bits [shift, shift + pbits) of a
    value's bucket, over ``segs`` segments (the bins of the level before)
    cut into q pieces of about ``SET_PART_CHUNK`` values each."""
    t = bits - min(bits, SET_SLICE_BITS)
    if (1 << t) <= SET_DIRECT_SLICES or n == 0:
        return []
    widths = [t] if t <= SET_PART_MAX_BITS else [(t + 1) // 2, t // 2]
    plan, segs, shift = [], 1, bits
    for p in widths:
        shift -= p
        plan.append((p, shift, segs, max(1, -(-n // (segs * SET_PART_CHUNK)))))
        segs <<= p
    return plan


def _set_level(values: torch.Tensor, bits: int, mult: int):
    """One table's build on the card, 2^bits buckets, and its spill: the
    values moved to the table's slices by ``set_partition_plan``'s levels
    (each a count, ``torch.cumsum`` of the counts and a scatter; a first of
    two levels writes into the table's memory, which the build overwrites),
    then one launch a block a slice; one host sync for the spill's size.
    The spill's room is a sixteenth of the values when the set was
    partitioned (all of them otherwise); values that need more (a crafted
    set) are built again, from the same partitions, with room for all."""
    n = values.numel()
    dev = values.device
    lib = _build.lib()
    built = (ctypes.c_int64 * 5)()
    lib.agc_set_build_constants(built)
    _require(tuple(built) == (SET_SLICE_BITS, SET_SLICE_CAP, SET_PART_CHUNK, SET_PART_MAX_BITS,
                              SET_DIRECT_SLICES),
             "set_table: the kernel library's build constants differ from cuda_kmers'")
    _require(n < 1 << 31, "set_table: a set of 2^31 values or more is over the int32 offsets")
    st = _stream(values)
    buckets = torch.empty(SET_SLOTS << bits, dtype=torch.int64, device=dev)
    src, bounds, stride = values, None, 0
    plan = set_partition_plan(n, bits)
    with torch.cuda.device(dev):
        for i, (pbits, shift, segs, q) in enumerate(plan):
            out = (torch.empty(n, dtype=torch.int64, device=dev) if i == len(plan) - 1
                   else buckets[:n])
            seg = None if bounds is None else bounds.data_ptr()
            counts = torch.empty((segs << pbits) * q, dtype=torch.int32, device=dev)
            _build.check(lib.agc_set_partition_count(src.data_ptr(), n, seg, stride, segs, q,
                                                     mult, bits, shift, pbits,
                                                     counts.data_ptr(), st), "set_table")
            offsets = torch.empty(counts.numel() + 1, dtype=torch.int32, device=dev)
            offsets[0] = 0
            torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
            del counts
            _build.check(lib.agc_set_partition_scatter(src.data_ptr(), n, seg, stride, segs, q,
                                                       mult, bits, shift, pbits,
                                                       offsets.data_ptr(), out.data_ptr(), st),
                         "set_table")
            src, bounds, stride = out, offsets, q
        cap = n if bounds is None else n // 16 + 64
        slices = 1 << (bits - min(bits, SET_SLICE_BITS))
        count = torch.empty(1, dtype=torch.int64, device=dev)
        while True:
            spill = torch.empty(cap, dtype=torch.int64, device=dev)
            status = torch.zeros(slices, dtype=torch.int64, device=dev)
            rc = lib.agc_set_slice_build(
                src.data_ptr(), n, None if bounds is None else bounds.data_ptr(), stride, mult,
                bits, buckets.data_ptr(), spill.data_ptr(), cap, status.data_ptr(),
                count.data_ptr(), st)
            _build.check(rc, "set_table")
            _count("set_table")
            m = int(count)  # the spill's size: one host sync a table
            if m <= cap:
                return SetLevel(buckets, bits, mult), spill[:m]
            cap = m


def set_table(values: torch.Tensor) -> SetTable:
    """The ``SetTable`` of a sorted set of flipped int64 codes (a value
    held twice takes two slots, SENTINEL none), built on the card: the
    first table over the set, the second over its spill, in the order the
    first's slice blocks left it; the second's spill, sorted by
    ``torch.sort``, is the tail."""
    _require(values.dim() == 1 and values.dtype == torch.int64,
             "set_table: values must be int64[n]")
    if values.device.type == "cpu":
        return set_table_plain(values)
    _check_cuda("set_table", values)
    first, spill = _set_level(values, set_bits(values.numel()), SET_HASH[0])
    second, tail = _set_level(spill, set_bits(spill.numel()) + 1, SET_HASH[1])
    return SetTable(first, second, torch.sort(tail).values, values)


# ---------------------------------------------------------------------------
# greedy_walk
# ---------------------------------------------------------------------------


def greedy_walk_plain(canon, starts, n_reals, pool, seg: int,
                      cap: int) -> torch.Tensor:
    """Plain version of ``greedy_walk``: the singleton mask of a whole
    contig by ``searchsorted``, then the greedy selection on the host."""
    c = starts.numel()
    out = torch.zeros((c, 3 + 2 * cap), dtype=torch.int64)
    p_len = pool.numel()
    starts_h = starts.cpu().tolist()
    reals_h = n_reals.cpu().tolist()
    for i in range(c):
        n = int(reals_h[i])
        v = canon[starts_h[i] : starts_h[i] + n]
        hit = torch.zeros(n, dtype=torch.bool, device=canon.device)
        if n and p_len:
            ix = torch.searchsorted(pool, v)
            at = pool[ix.clamp(max=p_len - 1)]
            nxt = pool[(ix + 1).clamp(max=p_len - 1)]
            hit = (at == v) & (v != u64.SENTINEL) & ((nxt != v) | (ix + 1 >= p_len))
        hp = torch.nonzero(hit).flatten().cpu().numpy()
        vals = v.cpu()
        pos = []
        t = 0
        while len(pos) < cap:
            j = int(np.searchsorted(hp, t))
            if j == len(hp):
                break
            pos.append(int(hp[j]))
            t = pos[-1] + seg
        out[i, 0] = len(pos)
        if pos:
            pt = torch.tensor(pos, dtype=torch.int64)
            out[i, 1 : 1 + len(pos)] = pt
            out[i, 1 + cap : 1 + cap + len(pos)] = vals[pt]
        if len(hp):
            out[i, 1 + 2 * cap] = int(hp[-1])
            out[i, 2 + 2 * cap] = vals[int(hp[-1])]
        else:
            out[i, 1 + 2 * cap] = u64.SENTINEL
    return out.to(canon.device)


def greedy_walk(canon: torch.Tensor, starts: torch.Tensor,
                n_reals: torch.Tensor, pool: torch.Tensor, seg: int,
                cap: int, index: tuple | None = None) -> torch.Tensor:
    """Greedy singleton splitter walk, one contig per (start, n_real).

    canon: int64[N] flipped canonical codes; starts, n_reals: int64[C];
    pool: sorted int64[P] (the whole k-mer pool); index: the pool's
    ``walk_index``, built here when not given; returns
    int64[C, 3 + 2 * cap] = [count, pos[cap], kmer[cap], tail_pos,
    tail_kmer] per contig (unused slots 0; tail_pos INT64_MAX when the
    contig has no singleton)."""
    for name, t in (("canon", canon), ("starts", starts),
                    ("n_reals", n_reals), ("pool", pool)):
        _require(t.dim() == 1 and t.dtype == torch.int64,
                 f"greedy_walk: {name} must be int64[...]")
    _require(starts.numel() == n_reals.numel(), "greedy_walk: starts/n_reals differ")
    _require(seg >= 1 and cap >= 1, "greedy_walk: seg and cap must be >= 1")
    if canon.device.type == "cpu":
        return greedy_walk_plain(canon, starts, n_reals, pool, seg, cap)
    singles, dirs = walk_index(pool) if index is None else index
    _check_cuda("greedy_walk", canon, starts, n_reals, pool, singles, dirs)
    bits = index_bits(singles.numel())
    _require(dirs.dtype == torch.int32 and dirs.numel() == (1 << bits) + 1,
             "greedy_walk: index is not a walk_index")
    c = starts.numel()
    out = torch.zeros((c, 3 + 2 * cap), dtype=torch.int64, device=canon.device)
    with torch.cuda.device(canon.device):
        rc = _build.lib().agc_greedy_walk(
            canon.data_ptr(), starts.data_ptr(), n_reals.data_ptr(), c,
            singles.data_ptr(), dirs.data_ptr(), bits, seg, cap, out.data_ptr(),
            _stream(canon),
        )
    _build.check(rc, "greedy_walk")
    _count("greedy_walk")
    return out


# ---------------------------------------------------------------------------
# walk_index: the index of the pool's singletons that greedy_walk looks in
# ---------------------------------------------------------------------------


def index_bits(s: int) -> int:
    """Directory bits for s singletons: ceil(log2 s), within [1, 30] (a
    4 GB directory at most), so a bucket holds under one on average."""
    return min(30, max(1, (s - 1).bit_length()))


def pool_buckets(values: torch.Tensor, bits: int) -> torch.Tensor:
    """The top ``bits`` bits of the unsigned codes of flipped int64
    values: their buckets in a walk index."""
    return (u64.flip(values) >> (64 - bits)) & ((1 << bits) - 1)


def walk_index_plain(pool: torch.Tensor):
    """Plain version of ``walk_index``: the singletons by neighbour
    compares, each bucket's first offset by ``searchsorted``."""
    keep = pool != u64.SENTINEL
    if pool.numel() > 1:
        same = pool[1:] == pool[:-1]
        keep[1:] &= ~same
        keep[:-1] &= ~same
    singles = pool[keep]
    bits = index_bits(singles.numel())
    keys = torch.arange((1 << bits) + 1, dtype=torch.int64, device=pool.device)
    return singles, torch.searchsorted(pool_buckets(singles, bits), keys).to(torch.int32)


def walk_index(pool: torch.Tensor):
    """The index of a sorted pool's singletons (values, not SENTINEL, that
    occur exactly once): (singles int64[S], sorted; dir int32[2^bits + 1],
    u32 bit patterns), bits = ``index_bits(S)``. dir[b] is the first
    offset into singles whose bucket (``pool_buckets``) is >= b, so a
    value v is a singleton iff it lies in singles[dir[b] : dir[b + 1]] for
    b = its bucket. On the card singles is a view of a buffer of the
    pool's length.

    pool: sorted int64[P]; S < 2^32 - 1."""
    _require(pool.dim() == 1 and pool.dtype == torch.int64,
             "walk_index: pool must be int64[P]")
    if pool.device.type == "cpu":
        return walk_index_plain(pool)
    _check_cuda("walk_index", pool)
    p = pool.numel()
    dev = pool.device
    lib = _build.lib()
    # S is known only after the one pass over the pool: the singletons'
    # room is the pool's length
    singles = torch.empty(p, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        s = 0
        if p:
            status = torch.zeros(-(-p // lib.agc_walk_index_tile()), dtype=torch.int64,
                                 device=dev)
            total = torch.empty(1, dtype=torch.int64, device=dev)
            _build.check(lib.agc_walk_singles(pool.data_ptr(), p, status.data_ptr(),
                                              singles.data_ptr(), total.data_ptr(),
                                              _stream(pool)), "walk_index")
            s = int(total)  # one host read, after the pass
            del status, total
        _require(s < (1 << 32) - 1, f"walk_index: {s} singletons are over the u32 offsets")
        bits = index_bits(s)
        dirs = torch.empty((1 << bits) + 1, dtype=torch.int32, device=dev)
        _build.check(lib.agc_walk_dir(singles.data_ptr(), s, bits, dirs.data_ptr(),
                                      _stream(pool)), "walk_index")
    _count("walk_index")
    return singles[:s], dirs


# ---------------------------------------------------------------------------
# MixSet: the membership test of scan_fused and member_mix
# ---------------------------------------------------------------------------


def mix_hash(v: torch.Tensor, c: int) -> torch.Tensor:
    """The filter bit of u32 values v (held in int64) for multiplier c:
    (v * c mod 2^32) >> 12. c is taken in 16-bit halves, so no int64
    product overflows."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & u64.M32) >> (32 - MIX_FILTER_LOG2)


def mix_filter_plain(table: torch.Tensor) -> torch.Tensor:
    """The filter of a mix table: int32[2^15] words of a
    2^20-bit map in which every entry v, padding and duplicates included,
    sets bits mix_hash(v, MIX_C1) and mix_hash(v, MIX_C2) (bit i is bit
    i % 32 of word i // 32)."""
    v = table.to(torch.int64) & u64.M32
    bits = torch.zeros(1 << MIX_FILTER_LOG2, dtype=torch.int64, device=table.device)
    for c in (MIX_C1, MIX_C2):
        bits[mix_hash(v, c)] = 1
    shifts = torch.arange(32, dtype=torch.int64, device=table.device)
    return u64.low32((bits.view(-1, 32) << shifts).sum(dim=1))


def mix_filter_pass(words: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """True where both filter bits of a mix are set: every member of the
    table passes, and so do a few non-members."""
    m = mix.to(torch.int64) & u64.M32
    w = words.to(torch.int64) & u64.M32
    ok = torch.ones(m.shape, dtype=torch.bool, device=mix.device)
    for c in (MIX_C1, MIX_C2):
        h = mix_hash(m, c)
        ok &= ((w[h >> 5] >> (h & 31)) & 1) == 1
    return ok


def mix_dir_bits(t: int) -> int:
    """Directory bits for a t-entry table: ceil(log2 t) - 2 within
    [1, 14] (kmer_common.cuh's mix_dir_bits)."""
    return min(_MIX_DIR_MAX_BITS, max(1, (t - 1).bit_length() - 2))


def mix_dir_plain(table: torch.Tensor) -> torch.Tensor:
    """The directory of a sorted mix table: int32[2^d + 1], entry b the
    first index whose value's top d bits are >= b (d = mix_dir_bits)."""
    d = mix_dir_bits(table.numel())
    v = table.to(torch.int64) & u64.M32
    keys = torch.arange((1 << d) + 1, dtype=torch.int64, device=table.device) << (32 - d)
    return torch.searchsorted(v, keys).to(torch.int32)


def mix_set_plain(mix: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain model of the kernels' test: the filter, then a lower bound of
    each passing mix inside its directory bucket. Equal to
    ``member_mix_plain``."""
    v = table.to(torch.int64) & u64.M32
    m = mix.to(torch.int64) & u64.M32
    d = mix_dir_bits(table.numel())
    dirs = mix_dir_plain(table).to(torch.int64)
    lo, end = dirs[m >> (32 - d)], dirs[(m >> (32 - d)) + 1]
    ix = torch.minimum(torch.maximum(torch.searchsorted(v, m), lo), end)
    found = (ix < end) & (v[ix.clamp(max=v.numel() - 1)] == m)
    return mix_filter_pass(mix_filter_plain(table), mix) & found


def mix_set_built(table: torch.Tensor):
    """(filter words int32[2^15], directory int32[2^d + 1]) of a CUDA mix
    table as the card builds them and one block loads them into shared
    memory; for comparison with ``mix_filter_plain`` / ``mix_dir_plain``."""
    _check_cuda("mix_set_built", table)
    t = table.numel()
    _require(table.dtype == torch.int32 and 1 <= t < (1 << 31),
             "mix_set_built: table must be int32[T], 1 <= T < 2^31")
    lib = _build.lib()
    _require(lib.agc_mix_dir_bits(t) == mix_dir_bits(t), "mix_set_built: directory bits differ")
    image = torch.empty(lib.agc_mix_set_words(t), dtype=torch.int32, device=table.device)
    words = torch.empty(1 << (MIX_FILTER_LOG2 - 5), dtype=torch.int32, device=table.device)
    dirs = torch.empty((1 << mix_dir_bits(t)) + 1, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        rc = lib.agc_mix_set_debug(table.data_ptr(), t, image.data_ptr(), words.data_ptr(),
                                   dirs.data_ptr(), _stream(table))
    _build.check(rc, "mix_set_built")
    return words, dirs


# ---------------------------------------------------------------------------
# member_mix
# ---------------------------------------------------------------------------


def member_mix_plain(mix: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of ``member_mix``: a binary search of the table
    (``searchsorted`` on the unsigned values widened to int64)."""
    t = table.to(torch.int64) & u64.M32
    m = mix.to(torch.int64) & u64.M32
    if t.numel() == 0:
        return torch.zeros(m.shape, dtype=torch.bool, device=mix.device)
    ix = torch.searchsorted(t, m).clamp(max=t.numel() - 1)
    return t[ix] == m


def member_mix(mix: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """member[i] = mix[i] in table.

    mix: int32[N] (u32 bit patterns); table: int32[T] sorted by unsigned
    value (``ScanTable.tmix``); returns bool[N]. Any contiguous int32
    tensor: a pointer off the 16-byte grid (a slice such as ``mix[1:]``)
    takes a scalar head."""
    _require(mix.dtype == torch.int32 and mix.dim() == 1,
             "member_mix: mix must be int32[N]")
    _require(table.dtype == torch.int32 and table.dim() == 1,
             "member_mix: table must be int32[T]")
    if mix.device.type == "cpu":
        return member_mix_plain(mix, table)
    _check_cuda("member_mix", mix, table)
    t = table.numel()
    _require(1 <= t < (1 << 31), f"member_mix: table size {t} not in [1, 2^31)")
    lib = _build.lib()
    image = torch.empty(lib.agc_mix_set_words(t), dtype=torch.int32, device=mix.device)
    out = torch.empty(mix.shape, dtype=torch.bool, device=mix.device)
    with torch.cuda.device(mix.device):
        rc = lib.agc_member_mix(
            mix.data_ptr(), mix.numel(), table.data_ptr(), t, image.data_ptr(),
            out.data_ptr(), _stream(mix),
        )
    _build.check(rc, "member_mix")
    _count("member_mix")
    return out


# ---------------------------------------------------------------------------
# dir_mix
# ---------------------------------------------------------------------------


def dir_mix_plain(packed2d: torch.Tensor, k: int):
    """Plain version of ``dir_mix``: ``dir_halves`` of the unpacked rows."""
    return dir_halves(unpack4(packed2d), k)


def dir_mix(packed2d: torch.Tensor, k: int):
    """(dlo, dhi, valid) per position of nibble-packed rows.

    packed2d: uint8[B, n/2]; returns int32[B, n] halves of the direct code
    (u32 bit patterns, lo = the 16 most recent symbols) and bool[B, n],
    equal to ``dir_halves`` at every position, invalid ones included."""
    _require(packed2d.dim() == 2 and packed2d.dtype == torch.uint8,
             "dir_mix: packed2d must be uint8[B, n/2]")
    _require(1 <= k <= 32, "dir_mix: k must be in [1, 32]")
    if packed2d.device.type == "cpu":
        return dir_mix_plain(packed2d, k)
    _check_cuda("dir_mix", packed2d)
    b, half = packed2d.shape
    dev = packed2d.device
    dlo = torch.empty((b, 2 * half), dtype=torch.int32, device=dev)
    dhi = torch.empty((b, 2 * half), dtype=torch.int32, device=dev)
    valid = torch.empty((b, 2 * half), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().agc_dir_mix(
            packed2d.data_ptr(), b, half, k, dlo.data_ptr(), dhi.data_ptr(),
            valid.data_ptr(), _stream(packed2d),
        )
    _build.check(rc, "dir_mix")
    _count("dir_mix")
    return dlo, dhi, valid
