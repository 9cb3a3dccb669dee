"""The match layer of the port: batched LZ estimates of segments against
candidate groups, the missing-middle split search and the anchor-mode
diagonal sets, over a device bank of group-reference indexes.

Counterpart of ``agc_tpu/ops/match.py``. Its host helpers and numpy twins
are copied (``probe_stride``, ``build_slot_tables_np``, ``marginal_cost_np``,
``estimate_np``, ``split_point_np``, ``shortlist``); its jitted programs are
torch ops here, except the estimate itself, which is the CUDA kernel
``match_estimate`` (``ops/cuda_match.py``):

- seed keys (``key_len = min_match_len - 3`` symbols, start-aligned,
  unshifted) come from the ``kmer_dir_rc`` kernel at ``k = key_len``, which
  gives each window's direct code and its reverse complement;
- a group reference's dual min/max hash-slot tables (``RefBank``) are two
  ``scatter_reduce`` passes (amin, amax) over its keys sampled every
  ``HASHING_STEP`` positions;
- the split search is two full-resolution marginal-cost vectors, their
  prefix sums and an argmin;
- the anchor tables are a stable sort of each text's strided keys with its
  reference's dense keys, forward cummaxes for the min / max reference
  occurrence, and a histogram of the diagonals by sort and run length.

Seed keys are raw 64-bit patterns in int64 (``-1`` is agc_tpu's all-ones
SENTINEL); see ``ops/cuda_match.py``. Every function runs on the device of
the bank or tensors it is given: CUDA kernels on ``"cuda"``, their plain
versions on ``"cpu"``. The estimates, split points and diagonal sets equal
agc_tpu's exactly; the bank's geometry (padding, table width, refusals) is
part of that, because slot collisions change the estimates.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from . import resolve_device, u64
from .cuda_kmers import kmer_dir_rc, unpack4
from .cuda_match import (
    _FP_BITS,
    _FP_MUL,
    _HASH_MUL,
    _POS_BITS,
    _POS_MASK,
    _SLOT_SENT,
    bucket_of,
    digits,
    fp_of,
    match_estimate,
    slot_bank,
)
from .kmers import pack4_np

HASHING_STEP = 4  # reference: lz_diff.h:38-42 (USE_SPARSE_HT)
_MIN_SEG_BUCKET = 1 << 12
_MIN_REF_KEY_BUCKET = 1 << 10
_ANCHOR_NDIAG = 32
_I32_MISS = -(1 << 31)
# anchor join rows a dispatch, counted in sorted elements (reference
# keys + strided text keys): a whole-genome flush is ~11.5k segments
_ANCHOR_CHUNK_ELEMS = 1 << 25

__all__ = [
    "AnchorCodeBank", "HASHING_STEP", "MatchQuery", "RefBank", "anchor_diag_sets",
    "build_slot_tables_np", "estimate_batch", "estimate_np", "marginal_cost_np",
    "probe_stride", "shortlist", "split_point_device", "split_point_np",
]


def probe_stride(key_len: int | None = None) -> int:
    """Segment-side probe stride (positions between probed seed keys):
    stride 4 probes every index-aligned position, 8/16 trade ranking
    resolution for fewer probes. Must be a multiple of HASHING_STEP and
    (when known) < key_len; a bad AGC_TPU_MATCH_STRIDE fails loudly."""
    raw = os.environ.get("AGC_TPU_MATCH_STRIDE", "4")
    try:
        stride = int(raw)
    except ValueError:
        raise ValueError(f"AGC_TPU_MATCH_STRIDE={raw!r} is not an integer")
    if stride <= 0 or stride % HASHING_STEP != 0 or (
        key_len is not None and stride >= key_len
    ):
        raise ValueError(
            f"AGC_TPU_MATCH_STRIDE={stride} invalid: must be a positive "
            f"multiple of {HASHING_STEP}"
            + (f" and < key_len={key_len}" if key_len is not None else "")
        )
    return stride


def _pow4(n: int, lo: int) -> int:
    """4x size ladder of every padded dimension (agc_tpu's bucket
    geometry, which the estimates depend on through the slot tables)."""
    b = lo
    while b < n:
        b <<= 2
    return b


def _packed_rows(arrays, b: int, device) -> torch.Tensor:
    """Numeric code arrays -> uint8[len, b/2] nibble-packed rows on
    ``device``, each padded with invalid symbols to b."""
    mat = np.full((len(arrays), b), 255, dtype=np.uint8)
    for i, a in enumerate(arrays):
        mat[i, : len(a)] = a
    packed = pack4_np(mat.reshape(-1)).reshape(len(arrays), b // 2)
    return torch.from_numpy(packed).to(device)


# ---------------------------------------------------------------------------
# seed keys and segment rows
# ---------------------------------------------------------------------------


def _seed_codes(packed: torch.Tensor, key_len: int):
    """Start-aligned unshifted seed keys of nibble-packed rows: (dkey, rkey,
    valid), each [B, b]. dkey[j] packs symbols j .. j+key_len-1, the first
    highest (the host encoder's get_code, reference lz_diff.h:58-120);
    rkey[j] is its reverse complement; valid[j] when the window holds
    key_len valid symbols inside the row. dkey is -1 where not valid."""
    udir, urc, valid_end, _ = kmer_dir_rc(packed, key_len)
    sh = 64 - 2 * key_len
    mask = -1 if key_len == 32 else (1 << (2 * key_len)) - 1
    b = packed.shape[1] * 2
    kl = key_len
    dkey = torch.full_like(udir, -1)
    rkey = torch.full_like(urc, -1)
    valid = torch.zeros_like(valid_end)
    # the window ending at j + kl - 1 starts at j
    dkey[:, : b - kl + 1] = (u64.flip(udir[:, kl - 1 :]) >> sh) & mask
    rkey[:, : b - kl + 1] = (u64.flip(urc[:, kl - 1 :]) >> sh) & mask
    valid[:, : b - kl + 1] = valid_end[:, kl - 1 :]
    return torch.where(valid, dkey, -1), rkey, valid


def _start_keys(packed: torch.Tensor, key_len: int) -> torch.Tensor:
    """agc_tpu's ``_start_keys``: the direct seed keys, -1 where invalid."""
    return _seed_codes(packed, key_len)[0]


def seg_rows(packed: torch.Tensor, lens: torch.Tensor, key_len: int):
    """[S, b/2] nibble-packed segments of true lengths ``lens`` -> (keys,
    acgt, isn), each [2S, b]: row 2i is segment i in direct orientation,
    row 2i+1 its reverse complement (agc_tpu's ``_rows_build``, with the
    same roll of the rc rows by b - 1 - n + key_len)."""
    s, half = packed.shape
    b = 2 * half
    dev = packed.device
    codes = unpack4(packed)
    keys, rkey, valid = _seed_codes(packed, key_len)
    acgt = codes <= 3
    ar = torch.arange(b, device=dev)
    lens = lens.to(dev, torch.int64)
    # nibble packing collapses every symbol > 3 to 15: all count as N
    isn = (codes > 3) & (ar[None, :] < lens[:, None])
    # rc key at start j of the rc segment = rc of the dir key at start
    # n - key_len - j: reversed, then rolled left by b - 1 - n + key_len
    src = b - 1 - (ar[None, :] + (b - 1 - lens + key_len)[:, None]) % b
    rkeys = torch.where(valid.gather(1, src), rkey.gather(1, src), -1)
    rkeys = torch.where(ar[None, :] <= (lens - key_len)[:, None], rkeys, -1)
    src = b - 1 - (ar[None, :] + (b - lens)[:, None]) % b
    racgt, risn = acgt.gather(1, src), isn.gather(1, src)
    return (torch.stack([keys, rkeys], dim=1).reshape(2 * s, b),
            torch.stack([acgt, racgt], dim=1).reshape(2 * s, b),
            torch.stack([isn, risn], dim=1).reshape(2 * s, b))


def seg_rows_strided(packed: torch.Tensor, lens: torch.Tensor, key_len: int,
                     stride: int):
    """The rows the estimate reads, on the probe grid (agc_tpu's
    ``_seg_rows_strided_kernel``): (keys_s int64[2S, T] strided seed keys;
    a_lo / a_hi int32[2S, T] ACGT counts of each block's offsets below /
    from key_len % stride, the only coverage boundary inside a block;
    nrun_tot int32[2S] total N-run token cost)."""
    keys, acgt, isn = seg_rows(packed, lens, key_len)
    q2, b = keys.shape
    t = b // stride
    keys_s = keys[:, ::stride].contiguous()
    r = key_len % stride
    blocks = acgt.reshape(q2, t, stride).to(torch.int32)
    a_lo = (blocks[:, :, :r].sum(dim=2, dtype=torch.int32) if r
            else torch.zeros((q2, t), dtype=torch.int32, device=keys.device))
    a_hi = blocks[:, :, r:].sum(dim=2, dtype=torch.int32)
    prev_n = torch.zeros_like(isn)
    prev_n[:, 1:] = isn[:, :-1]
    nrun_tot = 4 * (isn & ~prev_n).sum(dim=1, dtype=torch.int32)
    return keys_s, a_lo.contiguous(), a_hi.contiguous(), nrun_tot


def ref_slot_tables(packed: torch.Tensor, key_len: int, log2_h: int):
    """[R, b/2] nibble-packed references -> their dual min/max hash-slot
    tables, int64[R, H] each (agc_tpu's ``_ref_index_kernel``): seed keys
    sampled every HASHING_STEP positions, each slot keeping the least and
    the greatest (39-bit fingerprint << 24) | position that hashes to it."""
    keys, _rk, valid = _seed_codes(packed, key_len)
    sk = keys[:, ::HASHING_STEP]
    sv = valid[:, ::HASHING_STEP]
    pos = torch.arange(sk.shape[1], dtype=torch.int64, device=sk.device) * HASHING_STEP
    entry = torch.where(sv, (fp_of(sk) << _POS_BITS) | pos, _SLOT_SENT)
    bkt = torch.where(sv, bucket_of(sk, log2_h), 0)
    h = 1 << log2_h
    r = packed.shape[0]
    ta = torch.full((r, h), _SLOT_SENT, dtype=torch.int64, device=sk.device)
    ta.scatter_reduce_(1, bkt, entry, "amin")
    tb = torch.full((r, h), -1, dtype=torch.int64, device=sk.device)
    tb.scatter_reduce_(1, bkt, torch.where(sv, entry, -1), "amax")
    return ta, tb


# ---------------------------------------------------------------------------
# split search (torch ops)
# ---------------------------------------------------------------------------


def _pair_marginal_cost(q, a, nn, ta, tb, key_len: int) -> torch.Tensor:
    """Per-position marginal token cost of one (segment row, candidate)
    pair under the coverage model (agc_tpu's ``_pair_marginal_cost`` and
    ``_cost_given_probe``): literal = uncovered ACGT position, a covered
    run's token cost at its start, N-run cost at the N-run start. Probes
    every HASHING_STEP positions."""
    b = a.shape[0]
    dev = q.device
    log2_h = ta.shape[0].bit_length() - 1
    qs = q[::HASHING_STEP]
    t_valid = qs != -1
    bkt = torch.where(t_valid, bucket_of(qs, log2_h), 0)
    fp = fp_of(qs)
    ea, eb = ta[bkt], tb[bkt]
    hit_a = t_valid & (ea != _SLOT_SENT) & ((ea >> _POS_BITS) == fp)
    hit_b = t_valid & (eb >= 0) & ((eb >> _POS_BITS) == fp)
    hit = hit_a | hit_b
    rpos_t = torch.where(hit, torch.where(hit_a, ea & _POS_MASK, eb & _POS_MASK), 0)
    # strided coverage at full resolution: a hit at 4t covers
    # [4t, 4t + key_len)
    cum_rep = torch.cumsum(hit.to(torch.int64), 0).repeat_interleave(HASHING_STEP)[:b]
    cum_shift = torch.zeros_like(cum_rep)
    cum_shift[key_len:] = cum_rep[:-key_len]
    covered = (cum_rep - cum_shift) > 0
    prev_cov = torch.zeros_like(covered)
    prev_cov[1:] = covered[:-1]
    run_start = covered & ~prev_cov
    pos_full = torch.arange(b, dtype=torch.int64, device=dev)
    diag = rpos_t.repeat_interleave(HASHING_STEP)[:b] - (pos_full & ~(HASHING_STEP - 1))
    bias = 1 << 31
    packed = torch.where(run_start, (pos_full << 32) | (diag + bias), -1)
    last = torch.cummax(packed, 0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    prev_diag = torch.where(prev >= 0, (prev & 0xFFFFFFFF) - bias, 0)
    run_cost = digits((diag - prev_diag).abs()) + 4
    prev_n = torch.zeros_like(nn)
    prev_n[1:] = nn[:-1]
    return ((a & ~covered).to(torch.int64) + torch.where(run_start, run_cost, 0)
            + 4 * (nn & ~prev_n).to(torch.int64))


def split_point(keys, acgt, isn, n: int, ta1, tb1, ta2, tb2, key_len: int,
                o1_rc: bool, o2_rc: bool) -> int:
    """Cost-optimal split of a segment between two groups (agc_tpu's
    ``_split_point_kernel``): argmin over i in [0, n] of the cost of the
    first i direct symbols against group 1 (in its orientation) plus the
    cost of the rest against group 2. keys, acgt, isn: [2, b] rows of
    ``seg_rows`` (row 0 direct, row 1 rc)."""
    b = keys.shape[1]
    r1, r2 = int(o1_rc), int(o2_rc)
    c1 = _pair_marginal_cost(keys[r1], acgt[r1], isn[r1], ta1, tb1, key_len)
    c2 = _pair_marginal_cost(keys[r2], acgt[r2], isn[r2], ta2, tb2, key_len)
    z = c1.new_zeros(1)
    cum1 = torch.cat([z, torch.cumsum(c1, 0)])
    cum2 = torch.cat([z, torch.cumsum(c2, 0)])
    i = torch.arange(b + 1, dtype=torch.int64, device=keys.device)
    ni = (n - i).clamp(0, b)
    v1 = cum1[n] - cum1[ni] if o1_rc else cum1
    v2 = cum2[ni] if o2_rc else cum2[n] - cum2[i.clamp(max=n)]
    total = torch.where(i <= n, v1 + v2, 1 << 30)
    return int(torch.argmin(total))


# ---------------------------------------------------------------------------
# numpy twins (the spec; used by tests)
# ---------------------------------------------------------------------------


def _key_at(codes: np.ndarray, j: int, key_len: int) -> int | None:
    w = codes[j : j + key_len]
    if len(w) < key_len or np.any(w > 3):
        return None
    x = 0
    for s in w.tolist():
        x = (x << 2) | int(s)
    return x


def build_slot_tables_np(ref_codes: np.ndarray, key_len: int):
    """Numpy twin of ``ref_slot_tables``: dual min/max slot tables over
    seed keys sampled every HASHING_STEP positions, with the SAME bucket
    geometry as the device bank (ref padded to its bucket, H = 2 x
    sampled count)."""
    b = _pow4(len(ref_codes), _MIN_REF_KEY_BUCKET * 2)
    log2_h = (b // HASHING_STEP * 2).bit_length() - 1
    h = 1 << log2_h
    ta = np.full(h, _SLOT_SENT, dtype=np.int64)
    tb = np.full(h, -1, dtype=np.int64)
    for j in range(0, len(ref_codes) - key_len + 1, HASHING_STEP):
        x = _key_at(ref_codes, j, key_len)
        if x is None:
            continue
        bkt = ((x * _HASH_MUL) % (1 << 64)) >> (64 - log2_h)
        fp = ((x * _FP_MUL) % (1 << 64)) >> (64 - _FP_BITS)
        packed = (fp << _POS_BITS) | j
        ta[bkt] = min(int(ta[bkt]), packed)
        tb[bkt] = max(int(tb[bkt]), packed)
    return ta, tb, log2_h


def marginal_cost_np(
    seg_codes: np.ndarray,
    ref_codes: np.ndarray,
    key_len: int,
    stride: int = HASHING_STEP,
) -> np.ndarray:
    """Numpy twin of ``_pair_marginal_cost`` for one (segment, candidate)
    pair (direct orientation): per-position marginal token cost. The
    batched estimate's scalar equals this vector's sum at the same
    ``stride``."""
    n = len(seg_codes)
    out = np.zeros(n, dtype=np.int64)
    nmask = seg_codes > 3
    prev_n = np.concatenate([[False], nmask[:-1]])
    out += 4 * (nmask & ~prev_n)
    if n < key_len:
        out += (seg_codes <= 3).astype(np.int64)
        return out
    ta, tb, log2_h = build_slot_tables_np(ref_codes, key_len)
    t_count = (n + stride - 1) // stride
    hit = np.zeros(t_count, dtype=bool)
    rpos_t = np.zeros(t_count, dtype=np.int64)
    for t in range(t_count):
        x = _key_at(seg_codes, t * stride, key_len)
        if x is None:
            continue
        bkt = ((x * _HASH_MUL) % (1 << 64)) >> (64 - log2_h)
        fp = ((x * _FP_MUL) % (1 << 64)) >> (64 - _FP_BITS)
        ea, eb = int(ta[bkt]), int(tb[bkt])
        if ea != _SLOT_SENT and (ea >> _POS_BITS) == fp:
            hit[t] = True
            rpos_t[t] = ea & ((1 << _POS_BITS) - 1)
        elif eb >= 0 and (eb >> _POS_BITS) == fp:
            hit[t] = True
            rpos_t[t] = eb & ((1 << _POS_BITS) - 1)
    cum = np.cumsum(hit.astype(np.int64))
    cum_rep = np.repeat(cum, stride)[:n]
    cum_shift = np.concatenate([np.zeros(key_len, np.int64), cum_rep[:-key_len]])
    covered = (cum_rep - cum_shift) > 0
    prev_cov = np.concatenate([[False], covered[:-1]])
    run_start = covered & ~prev_cov
    rpos_rep = np.repeat(rpos_t, stride)[:n]
    diag = rpos_rep - (np.arange(n) // stride) * stride
    prev_diag = 0
    for i in np.flatnonzero(run_start).tolist():
        dd = abs(int(diag[i]) - prev_diag)
        out[i] += len(str(dd)) + 4
        prev_diag = int(diag[i])
    out += (seg_codes <= 3) & ~covered
    return out


def estimate_np(
    seg_codes: np.ndarray, ref_codes: np.ndarray, key_len: int
) -> int:
    """Numpy twin of one (segment, candidate) estimate (direct
    orientation)."""
    return int(
        marginal_cost_np(
            seg_codes, ref_codes, key_len, stride=probe_stride(key_len)
        ).sum()
    )


def split_point_np(
    seg_codes: np.ndarray,
    ref1: np.ndarray, o1_rc: bool,
    ref2: np.ndarray, o2_rc: bool,
    key_len: int,
) -> int:
    """Numpy twin of ``split_point`` (same V1/V2 definitions)."""
    n = len(seg_codes)
    rc = seg_codes[::-1].copy()
    m = rc <= 3
    rc[m] = 3 - rc[m]
    c1 = marginal_cost_np(rc if o1_rc else seg_codes, ref1, key_len)
    c2 = marginal_cost_np(rc if o2_rc else seg_codes, ref2, key_len)
    cum1 = np.concatenate([[0], np.cumsum(c1)])
    cum2 = np.concatenate([[0], np.cumsum(c2)])
    i = np.arange(n + 1)
    v1 = (cum1[n] - cum1[n - i]) if o1_rc else cum1[i]
    v2 = cum2[n - i] if o2_rc else (cum2[n] - cum2[i])
    return int(np.argmin(v1 + v2))


# ---------------------------------------------------------------------------
# the device bank of group-reference slot tables
# ---------------------------------------------------------------------------


def _ref_ok(codes, key_len: int) -> bool:
    """The bank indexes references of key_len + HASHING_STEP to 2^24 - 1
    symbols (the position field's width); others estimate as 0."""
    return (
        codes is not None
        and key_len + HASHING_STEP <= len(codes) < (1 << _POS_BITS)
    )


class RefBank:
    """Device-resident dictionary of group-reference seed indexes.

    One entry per group id: dual min/max hash-slot tables ``(ta, tb, h)``
    on ``device`` (``ref_slot_tables``), LRU-evicted to ``budget_bytes``
    (AGC_TPU_MATCH_BANK_BYTES, 2 GiB by default). Entries sharing a slot
    width are also kept consolidated in one (R, h, 2) matrix per width,
    each slot's min and max entries side by side (``slot_bank``), so a
    batched estimate reads candidate rows of one matrix and a probe one
    16-byte entry."""

    _GET_MANY_ROWS = 64  # references indexed a dispatch

    def __init__(self, key_len: int, budget_bytes: int | None = None, device="cuda"):
        self.key_len = key_len
        self.device = resolve_device(device)
        self.budget = budget_bytes or int(
            os.environ.get("AGC_TPU_MATCH_BANK_BYTES", str(2 << 30))
        )
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        # slot width m -> [bank (R, m, 2), row gids]
        self._built: dict[int, list] = {}
        self._row_of: dict[int, tuple[int, int]] = {}  # gid -> (m, row)
        self._bytes = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def _index(self, arrays: list, b: int):
        """Slot tables of references of one padded length b."""
        log2_h = (b // HASHING_STEP * 2).bit_length() - 1
        return ref_slot_tables(_packed_rows(arrays, b, self.device), self.key_len, log2_h)

    def get(self, gid: int, codes_provider):
        """(ta, tb, h) of group ``gid``, indexing ``codes_provider()`` on
        first use; None when the provider has no indexable codes."""
        with self._lock:
            e = self._entries.get(gid)
            if e is not None:
                self._entries.move_to_end(gid)
                return e
        codes = codes_provider()
        if not _ref_ok(codes, self.key_len):
            return None
        arr = np.frombuffer(bytes(codes), dtype=np.uint8)
        ta, tb = self._index([arr], _pow4(len(arr), _MIN_REF_KEY_BUCKET * 2))
        with self._lock:
            self._insert_locked(gid, ta[0], tb[0])
            return self._entries[gid]

    def _insert_locked(self, gid: int, ta, tb) -> None:
        """Register one built entry and run the LRU eviction; the caller
        holds the lock. An evicted entry's consolidated matrix goes too
        (rebuilt at its next use)."""
        if gid in self._entries:
            self._entries.move_to_end(gid)
            return
        self._entries[gid] = (ta, tb, int(ta.shape[0]))
        self._bytes += ta.numel() * 16
        while self._bytes > self.budget and len(self._entries) > 1:
            ogid, (ota, _otb, om) = self._entries.popitem(last=False)
            self._bytes -= ota.numel() * 16
            if self._row_of.pop(ogid, None) is not None:
                blt = self._built.pop(om, None)
                if blt is not None:
                    self._bytes -= blt[0].numel() * 8
                    for g in blt[1]:
                        self._row_of.pop(g, None)

    def get_many(self, gids, codes_provider) -> None:
        """Index every missing gid, references of one padded length
        _GET_MANY_ROWS a dispatch. Safe to call concurrently."""
        with self._lock:
            missing = sorted({g for g in gids if g not in self._entries})
        if not missing:
            return
        by_b: dict[int, list] = {}
        for g in missing:
            codes = codes_provider(g)
            if not _ref_ok(codes, self.key_len):
                continue
            arr = np.frombuffer(bytes(codes), dtype=np.uint8)
            by_b.setdefault(_pow4(len(arr), _MIN_REF_KEY_BUCKET * 2), []).append((g, arr))
        for b, items in sorted(by_b.items()):
            for lo in range(0, len(items), self._GET_MANY_ROWS):
                chunk = items[lo : lo + self._GET_MANY_ROWS]
                ta, tb = self._index([arr for _g, arr in chunk], b)
                with self._lock:
                    for j, (g, _arr) in enumerate(chunk):
                        # rows are copied so that evicting one frees it
                        self._insert_locked(g, ta[j].clone(), tb[j].clone())

    def rows_for(self, gids_entries: list):
        """Consolidated-matrix rows for each (gid, (ta, tb, h)), all of one
        slot width, with that width's (R, m, 2) bank, under one lock
        acquisition. Missing rows are written in one update; duplicate
        gids share a row."""
        with self._lock:
            seen: set[int] = set()
            missing = []
            for g, e in gids_entries:
                if g not in self._row_of and g not in seen:
                    seen.add(g)
                    missing.append((g, e))
            if missing:
                m = missing[0][1][2]
                blt = self._built.get(m)
                base = len(blt[1]) if blt is not None else 0
                need = base + len(missing)
                if blt is None:
                    cap = _pow4(need, 64)
                    blt = [self._empty_rows(cap, m), []]
                    self._built[m] = blt
                    self._bytes += cap * m * 16
                elif need > blt[0].shape[0]:
                    old_cap = blt[0].shape[0]
                    cap = _pow4(need, old_cap * 4)
                    blt[0] = torch.cat([blt[0], self._empty_rows(cap - old_cap, m)])
                    self._bytes += (cap - old_cap) * m * 16
                blt[0][base:need] = slot_bank(torch.stack([e[0] for _, e in missing]),
                                              torch.stack([e[1] for _, e in missing]))
                for i, (g, _e) in enumerate(missing):
                    self._row_of[g] = (m, base + i)
                blt[1].extend(g for g, _ in missing)
            rows = [self._row_of[g][1] for g, _ in gids_entries]
            return rows, self._built[self._row_of[gids_entries[0][0]][0]][0]

    def _empty_rows(self, n: int, m: int) -> torch.Tensor:
        """n bank rows of m empty slots: min entry _SLOT_SENT, max -1."""
        rows = torch.full((n, m, 2), -1, dtype=torch.int64, device=self.device)
        rows[..., 0] = _SLOT_SENT
        return rows


# ---------------------------------------------------------------------------
# batched estimation
# ---------------------------------------------------------------------------


class MatchQuery:
    """One segment's candidate search: ``codes`` (numeric, direct
    orientation) and ``cands`` = [(gid, use_rc), ...]. ``ests`` is
    filled by :func:`estimate_batch` in candidate order."""

    __slots__ = ("codes", "cands", "ests")

    def __init__(self, codes: np.ndarray, cands):
        self.codes = codes
        self.cands = list(cands)
        self.ests: np.ndarray | None = None


def estimate_batch(queries: list[MatchQuery], bank: RefBank, ref_codes_of) -> None:
    """Estimate every (query, candidate) pair on the bank's device; fills
    ``q.ests`` in place. Pairs whose group reference is unavailable
    (still packed from appending) estimate as 0, the host path's zero for
    packed groups (reference: CSegment::estimate, segment.cpp:83-85).
    Queries go by a 4x ladder of segment lengths, ~4 M query symbols a
    dispatch of rows; the split into dispatches changes no estimate."""
    live = [q for q in queries if q.cands]
    if not live:
        return
    by_len: dict[int, list[MatchQuery]] = {}
    for q in live:
        by_len.setdefault(_pow4(len(q.codes), _MIN_SEG_BUCKET), []).append(q)
    for seg_b, qs in by_len.items():
        rows_fixed = max(1, (4 << 20) // seg_b)
        for lo in range(0, len(qs), rows_fixed):
            _estimate_bucket(qs[lo : lo + rows_fixed], bank, ref_codes_of, seg_b)


def _estimate_bucket(live: list[MatchQuery], bank: RefBank, ref_codes_of, seg_b: int):
    key_len = bank.key_len
    dev = bank.device
    packed = _packed_rows([q.codes for q in live], seg_b, dev)
    lens = torch.tensor([len(q.codes) for q in live], dtype=torch.int64, device=dev)
    stride = probe_stride(key_len)
    keys_s, a_lo, a_hi, nrun_tot = seg_rows_strided(packed, lens, key_len, stride)

    bank.get_many([gid for q in live for gid, _rc in q.cands], ref_codes_of)
    by_width: dict[int, list] = {}
    for qi, q in enumerate(live):
        q.ests = np.zeros(len(q.cands), dtype=np.int64)
        for ci, (gid, use_rc) in enumerate(q.cands):
            entry = bank.get(gid, lambda g=gid: ref_codes_of(g))
            if entry is None:
                continue
            by_width.setdefault(entry[2], []).append(
                (qi * 2 + (1 if use_rc else 0), gid, entry, q, ci)
            )
    results = []  # (device estimates, items): one download at the end
    # pairs a dispatch: ~64 M probe-grid elements at stride 1
    p_fixed = max(64, (64 << 20) // seg_b)
    for _m, all_items in by_width.items():
        crows, slots = bank.rows_for([(gid, e) for _row, gid, e, _q, _ci in all_items])
        for lo in range(0, len(all_items), p_fixed):
            items = all_items[lo : lo + p_fixed]
            rows = torch.tensor([it[0] for it in items], dtype=torch.int32, device=dev)
            cands = torch.tensor(crows[lo : lo + len(items)], dtype=torch.int32, device=dev)
            ests = match_estimate(keys_s, a_lo, a_hi, nrun_tot, rows, cands, slots,
                                  key_len, stride)
            results.append((ests, items))
    for ests, items in results:
        ests = ests.cpu().numpy()
        for j, (_row, _gid, _e, q, ci) in enumerate(items):
            q.ests[ci] = int(ests[j])


def split_point_device(
    codes: np.ndarray,
    bank: RefBank,
    gid1: int, o1_rc: bool,
    gid2: int, o2_rc: bool,
    ref_codes_of,
) -> int | None:
    """Missing-middle split position on the bank's device (see
    ``split_point``); None when either group's reference is unavailable
    (packed from appending: the host path then applies its own packed-
    group rules, agc_compressor.cpp:1605-1608)."""
    e1 = bank.get(gid1, lambda: ref_codes_of(gid1))
    e2 = bank.get(gid2, lambda: ref_codes_of(gid2))
    if e1 is None or e2 is None:
        return None
    dev = bank.device
    packed = _packed_rows([codes], _pow4(len(codes), _MIN_SEG_BUCKET), dev)
    lens = torch.tensor([len(codes)], dtype=torch.int64, device=dev)
    keys, acgt, isn = seg_rows(packed, lens, bank.key_len)
    return split_point(keys, acgt, isn, len(codes), e1[0], e1[1], e2[0], e2[1],
                       bank.key_len, bool(o1_rc), bool(o2_rc))


def shortlist(ests: np.ndarray, margin: float, extra: int) -> list[int]:
    """Candidate indices the host must exact-estimate: everything within
    ``margin`` of the device minimum, plus the next ``extra`` best: the
    device ranks, the host decides."""
    if not len(ests):
        return []
    order = np.argsort(ests, kind="stable")
    best = int(ests[order[0]])
    cut = best * (1.0 + margin) + 32
    window = [int(i) for i in order if ests[i] <= cut]
    tail = [int(i) for i in order if ests[i] > cut][: max(0, extra)]
    return window + tail


# ---------------------------------------------------------------------------
# anchor-mode tables (the device leg of the anchor LZ encoder)
# ---------------------------------------------------------------------------


def anchor_join(tpacked: torch.Tensor, rrows: torch.Tensor, rowidx: torch.Tensor,
                key_len: int) -> torch.Tensor:
    """Sort-merge join of each text's seed keys, every HASHING_STEP
    positions, against its group reference's dense keys (agc_tpu's
    ``_anchor_join_kernel``): one stable sort a row, then forward cummaxes
    for the min and max reference occurrence of each key. Returns
    int32[S, 2 * (br + bt / 4)]: the diagonals of every (text key, min /
    max reference occurrence) pair, _I32_MISS elsewhere, unordered. C++
    twin: lz_anchor_diags."""
    rsel = rrows[rowidx.long()]
    s = tpacked.shape[0]
    dev = tpacked.device
    tk = _start_keys(tpacked, key_len)[:, ::HASHING_STEP]
    rk = _start_keys(rsel, key_len)
    bt_s, br = tk.shape[1], rk.shape[1]
    # flipped, so that agc_tpu's unsigned order holds and its all-ones
    # SENTINEL (-1 here) sorts last as INT64_MAX; references come first
    # in each row, so a stable sort by key keeps them before the texts of
    # their key run (agc_tpu sorts by (key, tag))
    keys = u64.flip(torch.cat([rk, tk], dim=1))
    tag = torch.cat([torch.zeros(br, dtype=torch.bool, device=dev),
                     torch.ones(bt_s, dtype=torch.bool, device=dev)])
    pos = torch.cat([torch.arange(br, dtype=torch.int64, device=dev),
                     torch.arange(bt_s, dtype=torch.int64, device=dev) * HASHING_STEP])
    sk, order = torch.sort(keys, dim=1, stable=True)
    stag, spos = tag[order], pos[order]
    newrun = torch.ones_like(sk, dtype=torch.bool)
    newrun[:, 1:] = sk[:, 1:] != sk[:, :-1]
    run_id = torch.cumsum(newrun.to(torch.int64), dim=1) - 1
    valid = sk != u64.SENTINEL
    is_ref = valid & ~stag
    cmx = torch.cummax(torch.where(is_ref, (run_id << _POS_BITS) | spos, -1), dim=1).values
    cmn = torch.cummax(torch.where(is_ref, (run_id << _POS_BITS) | (_POS_MASK - spos), -1),
                       dim=1).values
    is_text = valid & stag
    ok_a = is_text & (cmn >= 0) & ((cmn >> _POS_BITS) == run_id)
    ok_b = is_text & (cmx >= 0) & ((cmx >> _POS_BITS) == run_id)
    da = torch.where(ok_a, (_POS_MASK - (cmn & _POS_MASK)) - spos, _I32_MISS)
    db = torch.where(ok_b, (cmx & _POS_MASK) - spos, _I32_MISS)
    return torch.cat([da, db], dim=1).to(torch.int32).reshape(s, -1)


def anchor_select(allv: torch.Tensor) -> torch.Tensor:
    """The 32 most frequent diagonals of each row (count descending,
    diagonal ascending: the C++ twin's stable_sort order) from a
    _I32_MISS-padded int32 array (agc_tpu's ``_anchor_select_kernel``):
    sort, run lengths, a sort by a composite int64 key."""
    s, n2 = allv.shape
    imax = (1 << 31) - 1
    sv = torch.sort(torch.where(allv == _I32_MISS, imax, allv), dim=1).values
    is_max = sv == imax
    first = torch.ones_like(is_max)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    first &= ~is_max
    idx = torch.arange(n2, dtype=torch.int64, device=allv.device)[None, :]
    prev_max = torch.zeros_like(is_max)
    prev_max[:, 1:] = is_max[:, :-1]
    boundary = first | (is_max & ~prev_max)
    bpos = torch.where(boundary, idx, n2)
    # the next boundary strictly after each position
    nxt = torch.full_like(bpos, n2)
    nxt[:, :-1] = bpos[:, 1:]
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    counts = torch.where(first, nxt - idx, 0)
    rk = (1 << 31) - sv.to(torch.int64)  # diagonal ascending = rk descending
    comp = torch.where(first, (counts << 32) | rk, -1)
    top = torch.sort(comp, dim=1, descending=True).values[:, :_ANCHOR_NDIAG]
    return torch.where(top >= 0, (1 << 31) - (top & 0xFFFFFFFF), _I32_MISS).to(torch.int32)


class AnchorCodeBank:
    """Device-resident nibble-packed group-reference codes for the anchor
    join, consolidated per padded length (one (R, b/2) uint8 matrix a
    length). The join derives keys from codes each dispatch; only the
    uploads are cached."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._buckets: dict[int, list] = {}  # b -> [mat (R, b/2), gids]
        self._row_of: dict[int, tuple[int, int]] = {}  # gid -> (b, row)
        self._refused: set[int] = set()
        self._lock = threading.Lock()

    def get_many(self, gids, codes_provider, key_len: int) -> None:
        with self._lock:
            missing = sorted(
                {g for g in gids if g not in self._row_of and g not in self._refused}
            )
        if not missing:
            return
        by_b: dict[int, list] = {}
        refused = []
        for g in missing:
            codes = codes_provider(g)
            if not _ref_ok(codes, key_len):
                refused.append(g)
                continue
            arr = np.frombuffer(bytes(codes), dtype=np.uint8)
            by_b.setdefault(_pow4(len(arr), _MIN_SEG_BUCKET), []).append((g, arr))
        for b, items in sorted(by_b.items()):
            packed = _packed_rows([arr for _g, arr in items], b, self.device)
            with self._lock:
                blt = self._buckets.get(b)
                if blt is None:
                    self._buckets[b] = [packed, [g for g, _ in items]]
                else:
                    blt[0] = torch.cat([blt[0], packed])
                    blt[1].extend(g for g, _ in items)
                blt = self._buckets[b]
                base = len(blt[1]) - len(items)
                for j, (g, _arr) in enumerate(items):
                    self._row_of.setdefault(g, (b, base + j))
        with self._lock:
            self._refused.update(refused)

    def lookup(self, gid: int):
        """-> (bucket, row), or None (unavailable / out of bounds)."""
        with self._lock:
            return self._row_of.get(gid)

    def bucket_mat(self, b: int) -> torch.Tensor:
        with self._lock:
            return self._buckets[b][0]


def anchor_diag_sets(texts: list, gids: list, bank: AnchorCodeBank,
                     ref_codes_of, key_len: int) -> list:
    """Anchor diagonal sets of (text, group) pairs on the bank's device:
    uploads the texts nibble-packed, joins each with its group's cached
    reference codes (``anchor_join``) and selects each text's top 32
    (``anchor_select``). Returns per pair an int32[32] array (INT32_MIN
    padded), or None when the group's reference is unavailable or out of
    the anchor bounds: the caller then encodes with the host twin (the
    rule decides, not the engine). Rows go in dispatches of at most
    _ANCHOR_CHUNK_ELEMS sorted elements; the split changes no set."""
    out: list = [None] * len(texts)
    bank.get_many(gids, ref_codes_of, key_len)
    by: dict[tuple[int, int], list] = {}
    for i, (txt, gid) in enumerate(zip(texts, gids)):
        n = len(txt)
        if n >= (1 << _POS_BITS) or n == 0:
            continue
        loc = bank.lookup(gid)
        if loc is None:
            continue
        by.setdefault((_pow4(n, _MIN_SEG_BUCKET), loc[0]), []).append((i, txt, loc[1]))
    for (seg_b, ref_b), items in sorted(by.items()):
        rrows = bank.bucket_mat(ref_b)
        step = max(1, _ANCHOR_CHUNK_ELEMS // (ref_b + seg_b // HASHING_STEP))
        for lo in range(0, len(items), step):
            chunk = items[lo : lo + step]
            packed = _packed_rows(
                [np.frombuffer(bytes(txt), dtype=np.uint8) for _i, txt, _r in chunk],
                seg_b, bank.device)
            rows = torch.tensor([r for _i, _t, r in chunk], dtype=torch.int64,
                                device=bank.device)
            dsel = anchor_select(anchor_join(packed, rrows, rows, key_len)).cpu().numpy()
            for j, (i, _txt, _row) in enumerate(chunk):
                out[i] = dsel[j]
    return out
