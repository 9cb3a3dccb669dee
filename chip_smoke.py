#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (agc_tpu_torch) runs on a GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --rans-only   # phases 1-2, the rANS kernels' checks
                                        # and their timing on a synthetic flush
                                        # and a synthetic decode batch

Phases (any failure exits non-zero before the result line):

1. environment: torch, the card, its power limit (nvidia-smi);
2. build of the CUDA kernels from agc_tpu_torch/csrc (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, outputs compared exactly (integer
   outputs: tolerance 0), both timed with CUDA events, beside the least
   time the card could take (``bound_ms``) and, for member_mix, the one
   PyTorch call that computes the same function (torch.isin); the
   large-table join (dir_mix + member_mix) on the card against its plain
   version on the CPU; the membership test of scan_fused and member_mix
   (MixSet: a 2^20-bit filter and a directory of the table's top bits)
   as one block builds it on the card, word for word against its plain
   model, on hard tables (one entry, padding, 0 / 0xFFFFFFFF / bit 31,
   shared top bits, 16,384 and 58,111-58,113 entries, the join tables),
   and its pass rates on the main path's mixes; member_mix on mixes equal
   to every table value, their +-1 neighbours, 0, 0xFFFFFFFF and mixes
   the filter passes but the table lacks, at n = 1, a slice at offset 1
   (a pointer off the 16-byte grid), a table slice at offset 1, and
   n = 32 Mi + 7; scan_fused at k = 1, 17, 31, 32 on seam-packed rows
   (invalid symbols on the tile boundaries, a length no multiple of a
   tile), B = 1 and 8, tables of 128 and 16,384 entries, cap 16 (forced
   overflow) and 256, and a row in which every tile holds kept hits;
   kmer_canon at k = 1, 17, 31, 32 on seam-packed rows, and greedy_walk
   (with its singleton index, walk_index) on inputs that reach its edge
   branches: windows without hits, seg below the window width, cap inside
   a round, short contigs, no singleton, several contigs a launch, bit-63
   codes; kmer_dir_rc (both orientations' codes, the valid flag and
   membership in a set through its set_table) at k = 1, 17, 31, 32 on
   seam-packed rows with invalid symbols on tile boundaries, without a
   set and with a singleton table, an empty one, one of bit-63 values and
   one crafted so that buckets of both its tables overflow, each set's
   table against set_table_plain, then timed at 1 x 64 Mi symbols, k=31,
   without a set and with the chr-scale pool's 55.6 M singletons (their
   set_table built, held against its plain version and timed, its bytes
   and spill printed, and isin_sorted on the same codes timed beside the
   lookups, with torch.take's random-read rate at 16 MB and at the
   table's bytes, the lookups with the spill path cut, and set_table's
   peak device memory at the set a pool of _POOL_CARD_MAX positions
   would give); match_estimate (the match layer's
   estimate of (segment row, candidate group) pairs) at key_len 16 and 17,
   strides 4, 8 and 16, on rows of invalid keys only, hits in the first
   and last probe block, a run that starts right after the kernel's tile
   boundary, a one-row bank and a pair on the bank's last row, then at the
   dispatch shape of a whole-genome prepass (1024 pairs x 16,384 probe
   blocks, bank rows of 65,536 slots); the match layer's torch-op programs
   (segment rows, slot tables, split search, anchor join and select) timed
   at their shapes; the flush coder's four kernels, rans_tables (counts
   and quantized frequencies), rans_encode (every lane of every part),
   rans_layout (the blobs' sizes and offsets) and rans_write (the blobs),
   on hard payloads in one flush that holds all five lane tiers (agc_tpu's
   entropy cases, each tier's edges, last rows partly inactive, rare
   symbols of frequency 1, a raw escape, every symbol once, a dominant
   symbol among 255 rare ones, 300 one-lane parts, a fuzz, raw escapes
   whose sources and destinations take all 16 alignments with 1- to 4-byte
   length varints, raw and coded parts across 64 KB chunks), each against
   its plain version on the card, the tables against quantize_freqs and
   the blobs against the host native coder, the whole flush (code_flush)
   once more with any host sync before its download an error, chunk lists
   that are not _prepare's (an entry dropped, repeated, moved or cut off,
   given to the tables or to the writer alone) refused at the download
   with the flush after them still right, rans_encode without its lane
   count refused, and rans_decode (a batch of blobs a launch) on every
   coded blob of the flush and the coded forms of the cases the coder
   escapes (all five lane tiers) in one launch against its plain version
   and the inputs, each tier alone, each blob alone through
   decompress_device;
4. the main path: a chr-scale create (one 64 Mbase reference contig with
   repeat families + 2 resequenced samples, default parameters) through
   agc_tpu_torch.core.compressor.create_archive(device="cuda"), with the
   kernel launch counts of that run, two more timed creates, one create
   under torch.profiler for the device busy share of that same run and
   the device time of the scan_fused kernels,
   splitters checked against the port's plain versions run on the CPU,
   and every sample extracted byte-equal through agc_tpu_torch.AGCFile;
5. the port's CLI on the card: `create --device cuda`, then `getctg`;
6. card against CPU (each CPU create in a process of its own, beside the
   card's) on a collection of 3 files x 12 contigs (20 kbases to 2
   Mbases each): archives equal stream for stream and part for part for
   default parameters, for -c (concatenated genomes), for segment size
   1000 (over 8192 splitters: the large-table join scan) and for segment
   1000 with value-sampled discovery (_POOL_DEVICE_MAX lowered); then, on
   a collection whose samples carry novel contigs (one over 1 Mi bases,
   later files holding mutated copies first), -a, -f 0.05 and -a -f 0.01
   with the stress parameters -k 17 -l 15 -s 1000 -b 50000: archives
   equal, the -a table passing 8192 splitters during the run (scan_fused,
   then the join), delta-table scans that found hits, kmer_dir_rc
   launched by the -f runs (those on a collection half the size: their
   host walks are Python loops over every position);
7. the whole-genome path: a reference of three contigs with the lengths
   of GRCh38 chr1-chr3 (689,445,510 bases) + 2 resequenced samples,
   default parameters, so discovery is value-sampled (the reference is
   over _POOL_DEVICE_MAX) and every scan goes through the join (over 8192
   splitters): wall, Mbases/s, stage timers, splitter count, the launch
   counts of that run; the discovery again with every kmer_canon and
   greedy_walk call held against its plain version on the card at this
   path's shapes (chr1-3 rows, whole contigs over the sampled pool) and
   the plain versions' splitter set equal to the archive's; one
   kmer_canon call on the chr1 row and one walk of chr1 over the sampled
   pool timed with CUDA events (walk_index and greedy_walk apart), and
   every sample extracted byte-equal through agc_tpu_torch.AGCFile;
8. the adaptive create at full width: the phase 7
   reference with -a (k=31, segment 60000), its full k-mer pool on the
   card (over _POOL_DEVICE_MAX), and 2 samples that also carry novel
   contigs (one of 2 Mbases, over _HOST_NEW_SPLITTERS_MAX, so the card's
   new-splitter path runs, and eight of 100-500 kbases, the host path;
   the second sample holds mutated copies of them first): wall,
   Mbases/s, stage timers, peak device memory, splitters from discovery
   and added at barriers, launch counts; every kmer_canon and greedy_walk
   call of the new-splitter path kept during the timed create and held
   against its plain version on the card after it; discovery's splitters
   against the port's host full-pool path (_POOL_CARD_MAX lowered to 0)
   on the same reference; every sample extracted byte-equal; then
   candidate_tables and singleton_filter over its full pool and
   collect_kmers over the reference's contigs, timed with their bounds
   and their calls in the create;
9. the match layer at full width, the slice's main path: (a) the phase 7
   input in anchor LZ mode
   (its anchor tables computed on the card): wall, Mbases/s, stage timers
   with device_lz_tables and device_match, launch counts; up to 4096 of
   its (text, group) diagonal sets kept during the run and held after it
   against the host twin (lz_anchor_diags), the first 1024 also against
   the join and select on the CPU; every sample extracted byte-equal;
   (b) the phase 4 input in anchor mode with the tables on the card
   (AGC_TPU_DEVICE_LZ=1) and from
   the host twin (=0): archives equal part for part; (c) the forced
   prepass (AGC_TPU_DEVICE_MATCH=1) on the phase 4 input, phase 6's
   segment 1000 and -a -f 0.01 labels, and a structural collection built
   so that the estimate prepass, the split search and -f's shortlist all
   run (default segment 8000, then -f 0.2 -k 17 -l 15 -s 12000): card and
   CPU (beside it) archives equal part for part, estimate dispatches and pairs
   printed, every match_estimate call of one card run held against its
   plain version after the run;
10. the device rANS coder (AGC_TPU_RANS_DEVICE=1) at full width: the
   phase 7 input with --profile tpu-rans on the card: wall, Mbases/s,
   stage timers, flushes, parts and payload bytes, the flushes' seconds
   split into host preparation, upload, code (rans_tables + rans_encode +
   rans_layout + rans_write on the card), download and slice (the stages
   of ops/device_rans.py wrapped with timers), launch counts; every blob of
   the run against the host native coder on its payload, every part's
   tables against quantize_freqs, up to 4096 coded blobs decoded on the
   card through decompress_device (a launch each), then in one rans_decode
   launch against its plain version, timed against the 4096 launches and
   beside the sum of their bounds, each tier alone; the
   same for a synthetic batch of 4096 compressible parts of 1 to 300,000
   bytes (every lane tier; also under --rans-only); the kernels timed at
   the largest
   flush's shape (each call with CUDA events and split by torch.profiler
   into its kernels and torch ops, a call's kernel time only where every
   kernel it launches was recorded; the flush once more with any host sync
   before its download an error, its blobs equal to the create's) beside
   the host coder on the same flush, every sample extracted
   byte-equal; phase 4's input with the card's coder and with the host
   coder (archives equal part for part); phase 6's collection, create and
   then append, on the card and on the CPU (plain versions, in a process
   of its own beside the card's), archives equal part for part;
11. the sharded, mesh and distributed creates (agc_tpu_torch/parallel/):
   (a) phase 7's input with --shards 2 on thread workers
   (create_archive_sharded, device="cuda"): wall, Mbases/s, the boot /
   shards / merge split (AGC_TPU_SHARD_TIMINGS), peak device memory,
   launch counts, the archive within 2% of phase 7's, every sample
   extracted byte-equal; (b) phase 4's input with 2 process shards (each
   spawned worker opening the card) and with 2 thread shards, archives
   equal part for part; (c) the mesh create over the card's one-device
   mesh on phase 4's input, equal part for part to phase 4's plain create,
   its kmer_dir_rc calls kept and held against the plain version, one
   call timed at the mesh's row shape beside its bound; (d) the torchdist
   create: 2 processes sharing the card (gloo) on phase 4's input (the
   single create's splitters, every sample byte-equal, the thread shards'
   archive), and on phase 6's collection one process over NCCL (in this
   process) and two over gloo, both equal part for part to a CPU run of
   two processes of its own; the exchange-and-reduce at phase 4's pool in
   a world of one over NCCL, torch.sort of the pool beside it.

Each phase prints the seconds since the start when it ends. The line
before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
REF_MB = 64
N_SCAN = 4 << 20  # symbols per scan row (ops/kmers.py CHUNK)
N_SAMPLES = 2
SEED = 20260816
ALPHA = b"ACGT"
# GRCh38 chr1, chr2, chr3 (the whole-genome path's reference, phase 7)
GRCH38_CHR1_3 = (248_956_422, 242_193_529, 198_295_559)
# The least time the card could take (bound_ms): bytes over HBM's
# 3.35 TB/s, or integer operations over the int32 rate, whichever is
# larger. The H100 SXM data sheet's 67 TFLOP/s float32 counts an FMA as
# two operations on 128 lanes an SM; an SM has 64 int32 lanes, so
# 67e12 / 4 int32 instructions a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 operations of the rolling direct code a position: shift, OR and
# mask of the code, and the update of the valid-symbol run
LADDER_OPS = 4
SENTINEL = (1 << 63) - 1  # the flipped all-ones code (ops/u64.py)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for a call that must move n_bytes (each input
    read once, each output written once) and do n_ops int32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def canon_bound(n_packed: int) -> tuple[float, str]:
    """kmer_canon over n_packed bytes (2 positions each): the packed input
    read once, 8 bytes written a position, 20 int32 operations a position
    (both orientations rolled in 64 bits, the min, shift and flip)."""
    return bound(n_packed + 16 * n_packed, 40 * n_packed)


def dir_rc_bound(n_packed: int, index_bytes: int | None = None) -> tuple[float, str]:
    """kmer_dir_rc over n_packed bytes (2 positions each): 0.5 byte in and
    17 out a position (two int64 codes and the valid flag); with a set, 18
    out (the member flag) and the walk index (its singletons and directory,
    index_bytes) read once; the two orientations rolled in 64 bits, 20
    int32 operations a position."""
    if index_bytes is None:
        return bound(n_packed + 34 * n_packed, 40 * n_packed)
    return bound(n_packed + 36 * n_packed + index_bytes, 40 * n_packed)


def colliding(np, torch, ck, rng, n: int, rules, dev):
    """n flipped codes (not SENTINEL) in the given buckets: rules of
    (bits, multiplier, bucket)."""
    found, n_found = [], 0
    while n_found < n:
        cand = torch.from_numpy(rng.integers(-(1 << 63), SENTINEL - 1, 1 << 22,
                                             dtype=np.int64)).to(dev)
        ok = torch.ones(cand.numel(), dtype=torch.bool, device=dev)
        for bits, mult, bucket in rules:
            ok &= ck.set_bucket(cand, bits, mult) == bucket
        found.append(cand[ok])
        n_found += found[-1].numel()
    return torch.cat(found)[:n]


def overflowing_set(np, torch, ck, vals, rng):
    """The sorted codes `vals` with 40 more codes in each of three of their
    first-table buckets, and 12 in the first of those and in one bucket of
    the second table (the top 10 bits of its hash, one bucket for any
    second table of up to 2^10), so that both tables spill."""
    if vals.numel() < 64:
        return vals
    bits = ck.set_bits(vals.numel() + 3 * 40 + 12)
    h0, h1 = ck.SET_HASH
    third = vals.numel() // 3
    picks = ck.set_bucket(vals[[0, third, 2 * third]], bits, h0).tolist()
    extra = [colliding(np, torch, ck, rng, 40, [(bits, h0, b)], vals.device) for b in picks]
    extra.append(colliding(np, torch, ck, rng, 12, [(bits, h0, picks[0]), (10, h1, 5)],
                           vals.device))
    out = torch.unique(torch.cat([vals, *extra]))
    check(ck.set_bits(out.numel()) == bits, "the crafted set changed its bucket bits")
    return out


# set_table's kernels: the partition count and scatter (tables of more
# than 2^19 buckets), the fill, the inserts
SET_KERNELS = ("set_count_kernel", "set_scatter_kernel", "set_fill_kernel", "set_insert_kernel")


def set_table_err(torch, ck, got, want) -> int:
    """max_abs_err over set_table's buckets and tail, with its bits and
    hash multipliers checked equal."""
    for a, b in ((got.first, want.first), (got.second, want.second)):
        check((a.bits, a.hash) == (b.bits, b.hash),
              f"set_table's bits and multiplier {(a.bits, a.hash)} differ from {(b.bits, b.hash)}")
    return max(max_abs_err(torch, a, b) for a, b in (
        (got.first.buckets, want.first.buckets), (got.second.buckets, want.second.buckets),
        (got.tail, want.tail)))


def dir_rc_hard(np, torch, ck, u64, hard) -> tuple[int, int]:
    """kmer_dir_rc against its plain version at k = 1, 17, 31, 32 on the
    seam-packed rows `hard`: without a set, with a singleton table (a third
    of the rows' distinct codes), an empty one, one of bit-63 values only,
    and one whose buckets overflow; each set's table (set_table) against
    set_table_plain. Returns the largest max_abs_err of kmer_dir_rc and of
    set_table (both checked to be 0)."""
    worst = worst_table = 0
    for hk in (1, 17, 31, 32):
        canon = ck.kmer_canon_plain(hard, hk)
        vals = torch.unique(canon[canon != SENTINEL])
        high = vals[vals < 0]  # flipped: the unsigned codes with bit 63 set
        sets = {"none": None, "singletons": vals[::3].contiguous(),
                "empty": vals[:0].contiguous(), "bit 63": high.contiguous(),
                "overflowing": overflowing_set(np, torch, ck, vals[vals.numel() // 4:][::25],
                                               np.random.default_rng(SEED + 15 + hk))}
        for name, table in sets.items():
            idx = None if table is None else ck.set_table(table)
            if idx is not None:
                et = set_table_err(torch, ck, idx, ck.set_table_plain(table))
                check(et == 0, f"set_table disagrees with its plain version at k={hk}, set "
                               f"{name} ({et})")
                worst_table = max(worst_table, et)
            got = ck.kmer_dir_rc(hard, hk, idx)
            want = ck.kmer_dir_rc_plain(hard, hk, idx)
            e = max(max_abs_err(torch, a, b) for a, b in zip(got, want) if a is not None)
            members = None if got[3] is None else int(got[3].sum())
            spill = ("" if idx is None else
                     f", {idx.n_spilled} spilled, {idx.tail.numel()} to the tail")
            print(f"kmer_dir_rc hard case k={hk}, set '{name}' "
                  f"({0 if table is None else table.numel()} values{spill}): {hard.shape[0]} "
                  f"seam-packed rows x {2 * hard.shape[1]} symbols, {members} members, "
                  f"max_abs_err {e}")
            check(e == 0, f"kmer_dir_rc disagrees with its plain version at k={hk}, set {name} ({e})")
            if name in ("singletons", "bit 63", "overflowing") and table.numel():
                check(members > 0, f"kmer_dir_rc found no member of the '{name}' set")
            if name == "overflowing" and table.numel() > 64:
                check(idx.tail.numel() > 0, f"the overflowing set at k={hk} did not spill twice")
            worst = max(worst, e)
    return worst, worst_table


def walk_bound(positions: int, n_out: int) -> tuple[float, str]:
    """greedy_walk over `positions` probed positions (walk_positions): each
    reads its code and one constant-probe lookup of the pool (the entry
    and its neighbour, two compares); n_out int64 outputs written."""
    return bound(24 * positions + 8 * n_out, 2 * positions)


def index_bound(n_pool: int, singles, dirs) -> tuple[float, str]:
    """walk_index: the pool read once (8 bytes an entry), the singletons
    (8 bytes each) and the directory (4 bytes an entry) written once; two
    compares an entry."""
    return bound(8 * n_pool + 8 * singles.numel() + 4 * dirs.numel(), 2 * n_pool)


def index_err(torch, got, want) -> int:
    """max_abs_err over walk_index's (singles, dir) pair."""
    return max(max_abs_err(torch, a, b) for a, b in zip(got, want))


def max_abs_err(torch, a, b) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype, "shape/dtype mismatch")
    if a.numel() == 0:
        return 0
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    # a difference of 2^63 wraps to a negative abs(): never report 0 then
    return err if err > 0 or torch.equal(a, b) else 1 << 63


def scan_rows(np, n_rows: int, n: int, seed: int):
    """Main-path scan rows: random bases, a poly-A row, an N-run row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, size=(n_rows, n), dtype=np.uint8)
    rows[1] = rows[0]
    rows[1, ::997] = (rows[1, ::997] + 1) % 4  # a close copy: shared hits
    rows[2, 100_000:400_000] = 0  # poly-A run
    rows[3, :] = 0  # all poly-A
    for s in range(0, n, 65536):  # N runs
        rows[4, s : s + 200] = 4
    rows[5, rng.integers(0, n, n // 50)] = 4  # scattered invalid symbols
    return rows


def structured_ref(np, rng, n: int):
    """Reference with repeat families: ~45% of the draws copy one of 48
    repeat units (0.5-8 kb) at ~1% divergence, the rest is unique
    backbone (the generator of bench.py, so the shape of
    tools/bench_chr.py)."""
    lib = [rng.integers(0, 4, size=int(rng.integers(500, 8000)), dtype=np.uint8)
           for _ in range(48)]
    pieces, total = [], 0
    while total < n:
        if rng.random() < 0.45:
            copy = lib[int(rng.integers(len(lib)))].copy()
            n_sub = max(1, len(copy) // 100)
            pos = rng.integers(0, len(copy), size=n_sub)
            copy[pos] = (copy[pos] + rng.integers(1, 4, size=n_sub)) % 4
            pieces.append(copy)
            total += len(copy)
        else:
            m = int(rng.integers(2000, 20000))
            pieces.append(rng.integers(0, 4, size=m, dtype=np.uint8))
            total += m
    return np.concatenate(pieces)[:n]


def mutate(np, rng, seq):
    """A resequenced sample: ~0.1% SNPs and up to 8 short indels."""
    out = seq.copy()
    n_sub = max(1, len(seq) // 1000)
    pos = rng.integers(0, len(seq), size=n_sub)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    pieces, cur = [], 0
    for _ in range(8):
        cut = int(rng.integers(cur + 1, cur + len(seq) // 8))
        if cut >= len(out) - 1:
            break
        pieces.append(out[cur:cut])
        if rng.random() < 0.5:
            cut += int(rng.integers(1, 50))  # deletion
        else:
            pieces.append(out[cut : cut + int(rng.integers(1, 50))])  # duplication
        cur = min(cut, len(out))
    pieces.append(out[cur:])
    return np.concatenate(pieces)


def write_fasta(np, path: str, contigs) -> None:
    """Write [(name, codes)] as FASTA with 80-base lines."""
    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            full = len(seq) // 80
            lines = np.empty((full, 81), dtype=np.uint8)
            lines[:, :80] = alpha[seq[: full * 80]].reshape(full, 80)
            lines[:, 80] = ord("\n")
            f.write(lines.tobytes())
            if len(seq) % 80:
                f.write(alpha[seq[full * 80 :]].tobytes() + b"\n")


def seam_rows(np, rng, seam: int, n_rows: int = 3, length: int = 3 * 8192 + 1234):
    """Rows as discovery packs them: contigs of 1 to 9000 bases with `seam`
    invalid symbols between them, padded with invalid symbols to `length`
    (no multiple of any tile). Row r also has an invalid symbol at (r=0),
    just before (r=1) or 17 symbols before (r=2, inside the warm-up of
    the next tile) every 1024th position, so on every tile boundary."""
    rows = np.full((n_rows, length), 4, dtype=np.uint8)
    for r in range(n_rows):
        at = 0
        while True:
            n = int(rng.integers(1, 9000))
            if at + n > length:
                break
            rows[r, at : at + n] = rng.integers(0, 4, size=n, dtype=np.uint8)
            at += n + seam
        rows[r, np.arange(1024, length, 1024) - (0, 1, 17)[r % 3]] = 4
    return rows


def mix_tables(np, rng, join):
    """Sorted u32 mix tables that are hard for the MixSet: one entry,
    padding (0xDEADBEEF), 0 / 0xFFFFFFFF / bit 31, values that share their
    top 12 bits (one directory bucket), sizes that are no power of two,
    and the engine's join tables `join` ({name: table})."""
    def rand(n):
        return rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)

    def padded(v, size):
        return np.sort(np.concatenate([v, np.full(size - len(v), 0xDEADBEEF, np.uint32)]))

    edges = np.array([0, 0xFFFFFFFF, 1 << 31, (1 << 31) - 1], np.uint32)
    tables = {
        "T=1": np.array([0x12345678], np.uint32),
        "T=128, pads": padded(np.unique(rand(40)), 128),
        "0, 0xFFFFFFFF, bit 31": padded(np.unique(np.concatenate(
            [edges, rand(60) | np.uint32(1 << 31)])), 128),
        "shared top bits": padded(np.unique(np.uint32(0xABC00000) | (rand(3000) & np.uint32(0xFFFFF))),
                                  4096),
        "T=16384": np.sort(rand(16384)),
    }
    tables.update({f"T={t}": np.sort(rand(t)) for t in (58_111, 58_112, 58_113)})
    tables.update(join)
    return tables


def member_mix_hard(np, torch, ck, u64, dev, rng, tables, join_mix) -> int:
    """The card's MixSet against its plain model, and member_mix against
    member_mix_plain, on each table: mixes equal to its values, their +-1
    neighbours, 0, 0xFFFFFFFF and mixes the filter passes but the table
    lacks; n = 1, a slice at offset 1, a table slice at offset 1; on the
    join tables also the join's mixes with 7 more (n = 32 Mi + 7). Returns
    the largest max_abs_err (checked to be 0)."""
    worst = 0
    for name, tn in tables.items():
        t = u64.from_u32(tn, dev)
        words, dirs = ck.mix_set_built(t)
        e = max(max_abs_err(torch, words, ck.mix_filter_plain(t)),
                max_abs_err(torch, dirs, ck.mix_dir_plain(t)))
        check(e == 0, f"the card's MixSet differs from its plain model on '{name}' ({e})")
        probe = u64.from_u32(rng.integers(0, 1 << 32, 1 << 20, dtype=np.int64).astype(np.uint32), dev)
        false_pass = u64.to_u32(probe[ck.mix_filter_pass(ck.mix_filter_plain(t), probe)
                                      & ~ck.member_mix_plain(probe, t)])
        mix = u64.from_u32(np.concatenate([tn, tn + np.uint32(1), tn - np.uint32(1),
                                           np.array([0, 0xFFFFFFFF], np.uint32), false_pass]), dev)
        cases = [(mix, t), (mix[1:], t), (mix[:1], t)]
        if t.numel() > 1:
            cases.append((mix, t[1:]))
        if name.startswith("join"):
            big = torch.cat([join_mix, join_mix[:7]])
            cases += [(big, t), (big[1:], t)]
        errs = [max_abs_err(torch, ck.member_mix(m, tt), ck.member_mix_plain(m, tt)) for m, tt in cases]
        print(f"member_mix hard case '{name}' (T={t.numel()}): MixSet equal to its model, "
              f"{len(false_pass)} filter false passes of 2^20 random words; sizes "
              f"{[m.numel() for m, _ in cases]}, max_abs_err {max(errs)}")
        check(max(errs) == 0, f"member_mix disagrees with its plain version on '{name}' ({errs})")
        worst = max(worst, e, *errs)
    return worst


def scan_fused_hard(np, torch, ck, tk, dev, rng, tile: int) -> int:
    """scan_fused against scan_fused_plain at k = 1, 17, 31, 32 on
    seam-packed rows, B = 1 and 8, tables of 128 and 16,384 entries, cap
    16 and 256; then a row in which every tile (`tile` positions) holds
    kept hits. Returns the largest max_abs_err (checked to be 0)."""
    rows = seam_rows(np, rng, tk._SEAM, 8, 3 * 32768 + 1234)
    packed = torch.from_numpy(np.stack([tk.pack4_np(r) for r in rows])).to(dev)
    worst = 0
    for k in (1, 17, 31, 32):
        ud, ur, v = tk.dir_rc_kmers_np(rows[0], k)
        canon = np.unique(np.minimum(ud, ur)[v])
        for n_split in (40, 8192):
            table = tk.make_scan_table(np.sort(canon[:: max(1, len(canon) // n_split)][:n_split]), k, dev)
            for b in (1, 8):
                for cap in (16, 256):
                    got = ck.scan_fused(packed[:b], k, table.tmix, cap)
                    e = max_abs_err(torch, got, ck.scan_fused_plain(packed[:b], k, table.tmix, cap))
                    check(e == 0, f"scan_fused disagrees with its plain version at k={k}, "
                                  f"T={table.tmix.numel()}, B={b}, cap={cap} ({e})")
                    worst = max(worst, e)
            print(f"scan_fused hard case k={k}, T={table.tmix.numel()}: B = 1 and 8 seam-packed "
                  f"rows x {2 * packed.shape[1]} symbols, cap 16 and 256, counts "
                  f"{got[:, 0].tolist()}, max_abs_err {worst}")
            if k > 1 and n_split == 8192:
                check(int(got[0, 0]) > 16, "the forced cap overflow did not overflow")
    n = 20 * tile + 300
    row = rng.integers(0, 4, n, dtype=np.uint8)
    ud, ur, v = tk.dir_rc_kmers_np(row, 31)
    table = tk.make_scan_table(np.unique(np.minimum(ud, ur)[v])[::3], 31, dev)
    x = torch.from_numpy(tk.pack4_np(row)[None, :]).to(dev)
    got = ck.scan_fused(x, 31, table.tmix, n)
    e = max_abs_err(torch, got, ck.scan_fused_plain(x, 31, table.tmix, n))
    count = int(got[0, 0])
    pos = got[0, 1 + n - count : 1 + n].cpu().numpy()
    tiles = len(np.unique(pos // tile))
    print(f"scan_fused hard case, every tile kept: 1 row x {n} symbols, {count} hits, all kept, "
          f"in {tiles} of {-(-n // tile)} tiles of {tile}; max_abs_err {e}")
    check(e == 0 and tiles == -(-n // tile), f"the every-tile case failed ({e}, {tiles} tiles)")
    return max(worst, e)


def without_kmers(np, tk, rng, seq, known, k: int):
    """`seq` with a base changed at every k-mer window whose canonical code
    is in the array `known`, until none is: a novel contig that
    shares no k-mer with the reference cannot hit a reference splitter."""
    seq = seq.copy()
    while True:
        ud, ur, valid = tk.dir_rc_kmers_np(seq, k)
        at = np.flatnonzero(valid & np.isin(np.minimum(ud, ur), known))
        if not len(at):
            return seq
        seq[at] = (seq[at] + rng.integers(1, 4, len(at))) % 4


def adaptive_collection(np, tk, rng, tmp: str, n_ctg: int = 8, n_novel: int = 6,
                        tag: str = "a"):
    """Phase 6's input for -a and -f: a reference of 8 contigs (about 5.2
    Mbases: under 8192 splitters at segment 1000) and two samples. The
    first holds mutated copies of the reference contigs and novel contigs
    the reference lacks, one of 1.5 Mbases (over _HOST_NEW_SPLITTERS_MAX)
    and six of 350-500 kbases, about 4 Mbases in all, that share no k-mer
    (k=17) with the reference, so that no reference splitter cuts them and
    their new splitters take the table past 8192; the second holds mutated copies of the novel
    contigs first, then of the reference contigs, so its first scans run
    against the table of before the first sample's barrier and only the
    delta-table scans find the new splitters. `n_ctg` and `n_novel` scale
    it down (the -f runs: their host walks are Python loops over every
    position). Returns the three paths."""
    base = [structured_ref(np, rng, int(n)) for n in rng.integers(400_000, 900_000, n_ctg)]
    known = []
    for b in base:
        ud, ur, valid = tk.dir_rc_kmers_np(b, 17)
        known.append(np.minimum(ud, ur)[valid])
    known = np.unique(np.concatenate(known))
    novel = [without_kmers(np, tk, rng, rng.integers(0, 4, n, dtype=np.uint8), known, 17)
             for n in [1_500_000, *rng.integers(350_000, 500_000, n_novel)]]
    ctg = [(f"actg{i}", b) for i, b in enumerate(base)]
    nov = [(f"anovel{i}", c) for i, c in enumerate(novel)]
    files = [os.path.join(tmp, f"{tag}{i}.fa") for i in range(3)]
    write_fasta(np, files[0], ctg)
    write_fasta(np, files[1], [(n, mutate(np, rng, c)) for n, c in ctg] + nov)
    write_fasta(np, files[2], [(n, mutate(np, rng, c)) for n, c in nov]
                + [(n, mutate(np, rng, c)) for n, c in ctg])
    return files


def kernel_ms(by_name: dict, names) -> float:
    """Device ms of a profiled run's kernels whose names hold any of
    `names`."""
    return sum(ms for n, ms in by_name.items() if any(x in n for x in names))


def kernel_name(name: str) -> str:
    """A profiler event's kernel name without namespaces and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1].strip()


SCAN_KERNELS = ("scan_count_kernel", "scan_offsets_kernel", "scan_emit_kernel",
                "mix_set_build_kernel")


def walk_cases(np, seed: int):
    """Inputs that reach the greedy walk's edge branches: (name, canon
    int64[N] in the flipped convention, contigs [(start, n)], sorted int64
    pool, seg, cap)."""
    rng = np.random.default_rng(seed)
    sent = SENTINEL

    def fresh(n):  # distinct with high probability, both signs, never SENTINEL
        return rng.integers(-(1 << 63), sent, size=n, dtype=np.int64)

    def repeat(canon, share):  # copy values over `share` of the positions
        at = rng.random(len(canon)) < share
        canon[at] = canon[rng.integers(0, len(canon), int(at.sum()))]
        return canon

    cases = []
    n = 300_000  # 0.2% singletons: most windows hold no hit
    canon = fresh(2000)[rng.integers(0, 2000, n)]
    one = rng.random(n) < 0.002
    canon[one] = fresh(int(one.sum()))
    cases.append(("mostly duplicates", canon, [(0, n)], np.sort(canon), 1000, n // 1000 + 2))
    n = 200_000
    canon = repeat(fresh(n), 0.3)
    canon[rng.random(n) < 0.05] = sent
    pool = np.sort(canon)
    cases.append(("seg = k = 31", canon, [(0, n)], pool, 31, n // 31 + 2))
    cases.append(("cap 5, inside the first round", canon, [(0, n)], pool, 31, 5))
    cases.append(("cap 45, inside the second round", canon, [(0, n)], pool, 31, 45))
    canon = fresh(200)
    cases.append(("contigs of 40, 1, 63 and 64 positions", canon,
                  [(0, 40), (50, 1), (60, 63), (130, 64)], np.sort(canon), 31, 4))
    canon = fresh(5000)
    canon[::7] = sent
    cases.append(("no singleton", canon, [(0, 5000)],
                  np.sort(np.concatenate([canon, canon])), 100, 52))
    n = 400_000
    canon = repeat(fresh(n), 0.2)
    cases.append(("five contigs in one launch", canon,
                  [(0, 90_000), (90_100, 5), (90_200, 150_000), (240_300, 31), (240_400, 159_600)],
                  np.sort(canon), 500, n // 500 + 2))
    n, q = 100_000, 25_000
    canon = np.empty(n, np.int64)
    canon[:q] = np.iinfo(np.int64).min + rng.integers(0, 1 << 20, q)
    canon[q : 2 * q] = rng.integers(-(1 << 20), 1 << 20, q)
    canon[2 * q : 3 * q] = sent - 1 - rng.integers(0, 1 << 20, q)
    # a quarter share the top 28 bits of the unsigned code: one large bucket
    top = np.uint64(int(rng.integers(0, 1 << 28)) << 36)
    low = rng.integers(0, 1 << 36, n - 3 * q).astype(np.uint64)
    canon[3 * q :] = ((top | low) ^ np.uint64(1 << 63)).view(np.int64)
    rng.shuffle(canon)
    canon = repeat(canon, 0.3)
    cases.append(("bit 63, one skewed prefix, SENTINELs in the pool", canon, [(0, n)],
                  np.sort(np.concatenate([canon, np.full(1000, sent)])), 97, n // 97 + 2))
    return cases


def walk_positions(row, n: int, seg: int, cap: int) -> int:
    """Positions the greedy walk must probe, from its output row [count,
    pos[cap], kmer[cap], tail_pos, tail_kmer]: each step from its start
    (0, then the last emission + seg) to its hit, the final scan from the
    last start to the contig end unless cap stopped the walk, and the
    tail's backward scan from the end to the rightmost hit."""
    count = int(row[0])
    pos = [int(p) for p in row[1 : 1 + count]]
    starts = [0] + [p + seg for p in pos[:-1]]
    steps = sum(p - s + 1 for p, s in zip(pos, starts))
    if count < cap:
        steps += max(0, n - (pos[-1] + seg if count else 0))
    tail = int(row[1 + 2 * cap])
    return steps + (n - tail if tail < n else n)


def same_archive(reader_cls, a: str, b: str) -> bool:
    """Archives equal stream for stream and part for part (physical part
    order depends on the async store, so raw bytes are not compared)."""
    ra, rb = reader_cls(a), reader_cls(b)
    try:
        if sorted(ra.stream_names()) != sorted(rb.stream_names()):
            return False
        for name in ra.stream_names():
            if ra.n_parts(name) != rb.n_parts(name):
                return False
            for i in range(ra.n_parts(name)):
                if ra.get_part(name, i) != rb.get_part(name, i):
                    return False
        return True
    finally:
        ra.close()
        rb.close()


CHILDREN = []  # CPU creates running beside the card's (cpu_create)

_CPU_CREATE = (
    "import json, sys\n"
    "from agc_tpu_torch.core.compressor import Compressor, CompressorParams, append_archive, "
    "create_archive\n"
    "a = json.loads(sys.argv[1])\n"
    "if a['pool_max'] is not None:\n"
    "    Compressor._POOL_DEVICE_MAX = a['pool_max']\n"
    "if a['base'] is not None:\n"
    "    append_archive(a['base'], a['out'], a['files'], CompressorParams(**a['params']), "
    "device='cpu')\n"
    "else:\n"
    "    create_archive(a['out'], a['files'], CompressorParams(**a['params']), device='cpu')\n"
)


def cpu_create(out: str, files, params, pool_max=None, base=None):
    """Start the same create (or, given ``base``, append onto it) with the
    plain versions on the CPU, in a process of its own so that it runs
    beside the card's create (the environment, AGC_TPU_DEVICE_MATCH and
    AGC_TPU_RANS_DEVICE included, is inherited). Returns (process, start)
    for cpu_done."""
    arg = json.dumps(dict(out=out, files=list(files), params=vars(params), pool_max=pool_max,
                          base=base))
    proc = subprocess.Popen([sys.executable, "-c", _CPU_CREATE, arg], cwd=REPO,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def cpu_done(started) -> float:
    """Wait for a cpu_create; its seconds."""
    proc, t0 = started
    _out, err = proc.communicate(timeout=1200)
    check(proc.returncode == 0, f"the CPU create failed: {err[-2000:]!r}")
    return time.perf_counter() - t0


def device_time(torch, prof):
    """(busy ms, {activity: ms}) of the card in a torch.profiler run: busy
    is the union of the device spans (kernels, copies, memsets), the
    dict sums each activity's spans by name."""
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name == "Activity Buffer Request"):  # the profiler's own
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, by_name


def print_device(by_name: dict) -> None:
    """The 12 largest device activities of a profiled run, then every
    other kernel of the port (named agc::...)."""
    for i, (name, ms) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1])):
        if i < 12 or "agc::" in name:
            print(f"  device {ms:9.3f} ms  {name[:100]}")


def adaptive_create(np, torch, ck, tk, cmod, Compressor, CompressorParams, create_archive,
                    ArchiveReader, AGCFile, results, programs, card, tmp, ref_file, names,
                    wseqs) -> None:
    """Phase 8: -a on the phase 7 reference (its full pool on the card) and
    2 samples with novel contigs. See the module docstring."""
    rng = np.random.default_rng(SEED + 9)
    novel = [rng.integers(0, 4, n, dtype=np.uint8)
             for n in [2_000_000, *rng.integers(100_000, 500_000, 8)]]
    nnames = [f"novel{i}" for i in range(len(novel))]
    samples = {
        "ref": list(zip(names, wseqs["ref"])),
        "s0": list(zip(names, wseqs["s0"])) + list(zip(nnames, novel)),
        "s1": [(n, mutate(np, rng, c)) for n, c in zip(nnames, novel)]
        + list(zip(names, wseqs["s1"])),
    }
    os.mkdir(os.path.join(tmp, "adaptive"))
    files = [ref_file]
    for sname in ("s0", "s1"):
        files.append(os.path.join(tmp, "adaptive", f"{sname}.fa"))
        write_fasta(np, files[-1], samples[sname])
    atotal = sum(len(c) for cs in samples.values() for _, c in cs)
    ref_len = sum(len(c) for _, c in samples["ref"])
    check(ref_len > Compressor._POOL_DEVICE_MAX, "the reference is not over _POOL_DEVICE_MAX")
    check(ref_len <= Compressor._POOL_CARD_MAX, "the reference is over _POOL_CARD_MAX")

    # each kmer_canon and greedy_walk call of the new-splitter path is kept
    # (copies of its inputs and output) during the timed create and held
    # against its plain version on the card after the create's window
    kept = {"kmer_canon": [], "greedy_walk": []}
    active = [False]

    def copy(x):
        return x.clone() if torch.is_tensor(x) else x

    def keeping(name, kernel):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            if active[0]:
                kept[name].append((tuple(map(copy, args)), copy(got)))
            return got
        return call

    real_find = Compressor._find_new_splitters

    def find_held(self, codes):
        active[0] = len(codes) > self._HOST_NEW_SPLITTERS_MAX
        try:
            return real_find(self, codes)
        finally:
            active[0] = False

    discovered = []
    real_determine = Compressor.determine_splitters

    def capture(self, reference_file):
        real_determine(self, reference_file)
        discovered.append(set(self._splitter_set))

    saved = tk.kmer_canon, tk.greedy_walk
    tk.kmer_canon = keeping("kmer_canon", ck.kmer_canon)
    tk.greedy_walk = keeping("greedy_walk", ck.greedy_walk)
    Compressor._find_new_splitters = find_held
    Compressor.determine_splitters = capture
    # the discovery programs' calls (singleton_filter's inside
    # candidate_tables included)
    disc_calls = dict.fromkeys(DISC_PROGRAMS, 0)
    saved_disc = [(mod, name, getattr(mod, name)) for mod, name in (
        (cmod, "candidate_tables"), (cmod, "collect_kmers"), (cmod, "singleton_filter"),
        (tk, "singleton_filter"))]
    for mod, name, fn in saved_disc:
        setattr(mod, name, counting(disc_calls, name, fn))
    out = os.path.join(tmp, "adaptive.agc")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launches()
        t0 = time.perf_counter()
        timers = create_archive(out, files, CompressorParams(adaptive_compression=True,
                                                             verbosity=1), device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
    finally:
        tk.kmer_canon, tk.greedy_walk = saved
        Compressor._find_new_splitters = real_find
        Compressor.determine_splitters = real_determine
        for mod, name, fn in saved_disc:
            setattr(mod, name, fn)
    peak = torch.cuda.max_memory_allocated()
    reader = ArchiveReader(out)
    data, n_split = reader.get_part("splitters", 0)
    reader.close()
    got = set(np.frombuffer(data, dtype="<u8").tolist())
    disc = discovered[0]
    print(f"adaptive create (-a, k=31, segment 60000): {atotal} bases (reference {ref_len}, "
          f"full pool on the card) in {wall:.4f} s = {atotal / wall / 1e6:.2f} Mbases/s "
          f"({card}); archive {os.path.getsize(out)} bytes; {len(disc)} splitters from "
          f"discovery, {n_split - len(disc)} added at barriers; delta-scan hits "
          f"{timers.units['delta_hits']}; peak device memory {peak} bytes = "
          f"{peak / ref_len:.2f} bytes a reference position; launches {launches}")
    print("adaptive stage timers (s): " + json.dumps(
        {n: round(t, 4) for n, t in sorted(timers.times.items(), key=lambda kv: -kv[1])}))
    for name in ("kmer_canon", "walk_index", "greedy_walk", "dir_mix", "member_mix"):
        check(launches[name] > 0, f"the adaptive create never launched {name}")
        results[name]["adaptive_create_launches"] = launches[name]
    results["kmer_canon"]["adaptive_peak_bytes"] = peak
    check(n_split > len(disc) and disc <= got, "the adaptive create added no splitter")
    plains = {"kmer_canon": ck.kmer_canon_plain, "greedy_walk": ck.greedy_walk_plain}
    for name, calls in kept.items():
        errs = [max_abs_err(torch, got, plains[name](*args)) for args, got in calls]
        print(f"adaptive new-splitter path: {len(errs)} {name} calls against the plain version "
              f"on the card, max_abs_err {max(errs, default=None)}")
        check(errs and max(errs) == 0,
              f"the new-splitter path's {name} calls disagree or never ran ({errs})")

    # the same reference through the port's host full-pool path
    t0 = time.perf_counter()
    card_max = Compressor._POOL_CARD_MAX
    Compressor._POOL_CARD_MAX = 0
    try:
        host = Compressor(os.path.join(tmp, "host.agc"), CompressorParams(
            adaptive_compression=True), reference_file=ref_file, device=DEVICE)
        host_set = host.splitter_set_snapshot()
        host_tables = (host.cand_singletons.numel(), host.cand_duplicated.numel())
        host.abort()
        del host
    finally:
        Compressor._POOL_CARD_MAX = card_max
    torch.cuda.empty_cache()
    print(f"adaptive discovery: {len(disc)} splitters on the card, {len(host_set)} from the host "
          f"full pool (kmer_discover_splitters; tables {host_tables[0]} singletons, "
          f"{host_tables[1]} duplicated; {time.perf_counter() - t0:.1f} s)")
    check(host_set == disc, "the card's discovery differs from the host full-pool path")

    t0 = time.perf_counter()
    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    with AGCFile(out) as agc:
        for sname, contigs in samples.items():
            for cname, seq in contigs:
                check(agc.GetCtgSeq(sname, cname).encode("latin-1") == alpha[seq].tobytes(),
                      f"{cname}@{sname} does not extract byte-equal from the adaptive archive")
    print(f"adaptive extract: {sum(len(c) for c in samples.values())} contigs of "
          f"{len(samples)} samples byte-equal ({time.perf_counter() - t0:.1f} s)")
    discovery_programs(torch, tk, programs, card, wseqs["ref"], disc_calls)


# The discovery programs of -a and -f (torch ops of ops/kmers.py since PR
# 6): agc_tpu's XLA programs that they replace
DISC_PROGRAMS = {
    "candidate_tables": "agc_tpu/ops/kmers.py:1172",
    "singleton_filter": "agc_tpu/ops/kmers.py:1231",
    "collect_kmers": "agc_tpu/ops/kmers.py:268",
}


def discovery_programs(torch, tk, programs, card, contigs, calls) -> None:
    """candidate_tables and singleton_filter over phase 8's full pool (the
    phase 7 reference's canonical k-mers, sorted), collect_kmers (agc_tpu's
    contig_kmers) over each of its contigs, timed with CUDA events; their
    calls in phase 8's create; bounds from each input read once and each
    output written once."""
    dev = torch.device(DEVICE)
    k = 31
    ms_collect = sum(cuda_ms(torch, lambda c=c: tk.collect_kmers(c, k, dev), 2) for c in contigs)
    n_ref = sum(len(c) for c in contigs)
    pool = tk.sort_kmers(torch.cat([tk.collect_kmers(c, k, dev) for c in contigs]))
    n = pool.numel()
    singles, dups = tk.candidate_tables(pool)
    n_tables = singles.numel() + dups.numel()
    del singles, dups
    rows = {
        # the nibble-packed contig in, one int64 a valid k-mer out
        "collect_kmers": (ms_collect, bound(n_ref / 2 + 8 * n, 0)),
        # the pool in, two bool masks out
        "singleton_filter": (cuda_ms(torch, lambda: tk.singleton_filter(pool), 5),
                             bound(10 * n, 0)),
        # the pool in, the two tables out
        "candidate_tables": (cuda_ms(torch, lambda: tk.candidate_tables(pool), 3),
                             bound(8 * n + 8 * n_tables, 0)),
    }
    del pool
    torch.cuda.empty_cache()
    for name, (ms, (bound_ms, bound_by)) in rows.items():
        programs[name] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, calls=calls[name],
                              replaces=DISC_PROGRAMS[name])
    print(f"discovery programs at phase 8's shape (pool of {n} k-mers, {n_tables} in the "
          f"tables; collect_kmers summed over the {len(contigs)} reference contigs): "
          + json.dumps({name: programs[name] for name in DISC_PROGRAMS}) + f" ({card})")


# The match layer (ops/match.py): kernel checks of phase 3, then phase 9.

# torch-op programs of the match layer, counted and timed apart: the XLA
# programs of agc_tpu/ops/match.py that they replace
MATCH_PROGRAMS = {
    "seg_rows_strided": "agc_tpu/ops/match.py:213",
    "seg_rows": "agc_tpu/ops/match.py:207",
    "ref_slot_tables": "agc_tpu/ops/match.py:243",
    "split_point": "agc_tpu/ops/match.py:454",
    "anchor_join": "agc_tpu/ops/match.py:949",
    "anchor_select": "agc_tpu/ops/match.py:1099",
}


def estimate_case(np, torch, M, dev, rng, key_len: int, stride: int, t: int, tile: int):
    """Inputs of one match_estimate dispatch with its edges forced: a bank
    of 3 references whose last row a pair uses, a row that is all invalid
    keys, hits in the first and last probe block, and a run that starts
    right after the kernel's tile boundary (no cover in the blocks before
    it)."""
    n_refs = 3
    b = M._pow4(4 * t, 2048)
    log2_h = (b // 4 * 2).bit_length() - 1
    refs = [rng.integers(0, 4, int(rng.integers(2 * key_len, b)), dtype=np.uint8)
            for _ in range(n_refs)]
    packed = M._packed_rows(refs, b, dev)
    bank = M.slot_bank(*M.ref_slot_tables(packed, key_len, log2_h))
    ref_keys = M._start_keys(packed, key_len)[:, ::4]
    pool = ref_keys[ref_keys != -1]
    first = ref_keys[0][ref_keys[0] != -1]
    q = 6

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = on(rng.integers(0, 1 << (2 * key_len), (q, t)).astype(np.int64))
    keys = torch.where(on(rng.random((q, t)) < 0.4),
                       pool[on(rng.integers(0, pool.numel(), (q, t)))], keys)
    keys[:, on(rng.random(t) < 0.05)] = -1
    keys[1] = -1
    keys[2, 0] = keys[2, -1] = first[0]
    keys[3, tile - key_len // stride - 2 : tile] = -1
    keys[3, tile] = first[1]
    r = key_len % stride
    a_lo = on(rng.integers(0, r + 1, (q, t)).astype(np.int32))
    a_hi = on(rng.integers(0, stride - r + 1, (q, t)).astype(np.int32))
    nrun = on(rng.integers(0, 40, q).astype(np.int32))
    rows = rng.integers(0, q, 40).astype(np.int32)
    cands = rng.integers(0, n_refs, 40).astype(np.int32)
    rows[:q] = np.arange(q)
    cands[2] = cands[3] = 0
    cands[-1] = n_refs - 1
    return keys.contiguous(), a_lo, a_hi, nrun, on(rows), on(cands), bank


def estimate_bound(torch, cm, keys_s, rows, cands, bank, key_len: int,
                   stride: int) -> tuple[tuple[float, str], float]:
    """match_estimate, each input read once: the keys and ACGT counts of
    each query row used (12 bytes a probe block, 16 where key_len % stride
    leaves a low part), of each bank row used its table's bytes or the
    32-byte sectors its pairs' valid probes touch, where fewer, and 4 + 4
    bytes in and 8 out a pair; 40 int32 operations a probe block a pair
    (two 64-bit hashes, the compares, the scans and the literal sums).
    Returns (the bound, and PR 8's count in ms: 16 bytes a probe block of a
    used row and two sectors for every valid probe of every pair)."""
    t = keys_s.shape[1]
    h = bank.shape[1]
    rows, cands = rows.long(), cands.long()
    used = torch.unique(rows)
    qs = keys_s[rows]
    valid = qs != -1
    sectors = torch.unique(cands[:, None].expand_as(qs)[valid] * (h // 2)
                           + (cm.bucket_of(qs[valid], h.bit_length() - 1) >> 1))
    per_row = torch.bincount(sectors // (h // 2), minlength=bank.shape[0])
    table_bytes = int(torch.minimum(per_row * 32, torch.full_like(per_row, 16 * h))
                      [torch.unique(cands)].sum())
    n_pairs = rows.numel()
    row_bytes = (16 if key_len % stride else 12) * t * used.numel()
    ops = 40 * t * n_pairs
    old = bound(16 * t * used.numel() + 64 * int(valid.sum()) + 16 * n_pairs, ops)[0]
    return bound(row_bytes + table_bytes + 16 * n_pairs, ops), old


def estimate_dispatch(np, torch, M, dev, rng, n_segs: int = 64, n_cands: int = 16):
    """match_estimate's inputs at the dispatch shape of a whole-genome
    prepass: n_segs segments of 60,000 symbols (a 65,536-symbol bucket, so
    16,384 probe blocks at stride 4), each mutated from one of n_segs
    references of 100,000 symbols (bank rows of H = 65,536 slots), each
    segment against n_cands references (its own first), both
    orientations: n_segs * n_cands = 1024 pairs."""
    refs = [rng.integers(0, 4, 100_000, dtype=np.uint8) for _ in range(n_segs)]
    segs = [mutate(np, rng, r[20_000:80_000])[:60_000] for r in refs]
    seg_b = M._pow4(60_000, M._MIN_SEG_BUCKET)
    spacked = M._packed_rows(segs, seg_b, dev)
    lens = torch.tensor([len(s) for s in segs], dtype=torch.int64, device=dev)
    ref_b = M._pow4(100_000, 2 * M._MIN_REF_KEY_BUCKET)
    rpacked = M._packed_rows(refs, ref_b, dev)
    log2_h = (ref_b // 4 * 2).bit_length() - 1
    rows = np.array([2 * i + (c & 1) for i in range(n_segs) for c in range(n_cands)], np.int32)
    cands = np.array([(i + c) % n_segs for i in range(n_segs) for c in range(n_cands)], np.int32)
    return spacked, lens, rpacked, log2_h, torch.from_numpy(rows).to(dev), \
        torch.from_numpy(cands).to(dev)


def match_kernels(np, torch, cm, M, dev, results, card, tile: int) -> dict:
    """Phase 3's match layer: match_estimate against its plain version on
    hard cases (key_len 16 and 17, strides 4, 8, 16, a one-row bank) and at
    the dispatch shape, timed beside its bound; the torch-op programs of
    the layer timed at their shapes. Returns the programs' times."""
    rng = np.random.default_rng(SEED + 11)
    err = 0
    for key_len in (16, 17):
        for stride in (4, 8, 16):
            args = estimate_case(np, torch, M, dev, rng, key_len, stride, 3 * tile + 37, tile)
            got = cm.match_estimate(*args, key_len, stride)
            e = max_abs_err(torch, got, cm.match_estimate_plain(*args, key_len, stride))
            keys, a_lo, a_hi, nrun, rows, cands, bank = args
            one = (keys, a_lo, a_hi, nrun, rows, torch.zeros_like(cands), bank[:1].contiguous())
            e1 = max_abs_err(torch, cm.match_estimate(*one, key_len, stride),
                             cm.match_estimate_plain(*one, key_len, stride))
            print(f"match_estimate hard case key_len={key_len} stride={stride}: "
                  f"{rows.numel()} pairs x {keys.shape[1]} probe blocks (tile {tile}), "
                  f"estimates {got[:6].tolist()}..., max_abs_err {e}, one-row bank {e1}")
            check(e == 0 and e1 == 0,
                  f"match_estimate disagrees with its plain version (key_len {key_len}, "
                  f"stride {stride}: {e}, {e1})")
            err = max(err, e, e1)

    spacked, lens, rpacked, log2_h, rows, cands = estimate_dispatch(np, torch, M, dev, rng)
    key_len, stride = 17, 4
    keys_s, a_lo, a_hi, nrun = M.seg_rows_strided(spacked, lens, key_len, stride)
    bta, btb = M.ref_slot_tables(rpacked, key_len, log2_h)
    bank = cm.slot_bank(bta, btb)
    args = (keys_s, a_lo, a_hi, nrun, rows, cands, bank, key_len, stride)
    got = cm.match_estimate(*args)
    want = cm.match_estimate_plain(*args)
    e = max_abs_err(torch, got, want)
    check(e == 0, f"match_estimate disagrees with its plain version at the dispatch shape ({e})")
    by_seg = got.reshape(keys_s.shape[0] // 2, -1)  # its own reference first
    check(bool((by_seg[:, 0] < by_seg[:, 1:].min(dim=1).values).all()),
          "a segment's own reference is not its best estimate")
    est_bound, old_bound = estimate_bound(torch, cm, keys_s, rows, cands, bank, key_len, stride)
    results["match_estimate"] = dict(
        source="agc_tpu_torch/csrc/match_estimate.cu",
        replaces="agc_tpu/ops/match.py:363",
        max_abs_err=max(err, e),
        ms=cuda_ms(torch, lambda: cm.match_estimate(*args), 10),
        plain_ms=cuda_ms(torch, lambda: cm.match_estimate_plain(*args), 3),
        library_ms=None,
        bound=est_bound,
        old_count_bound_ms=old_bound,
        shape=f"{rows.numel()} pairs x {keys_s.shape[1]} probe blocks (stride 4, key_len 17), "
              f"bank {tuple(bank.shape)}",
    )
    r = results["match_estimate"]
    print(f"match_estimate dispatch shape ({r['shape']}): max_abs_err {e}; kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; PR 8's count {old_bound:.4f} ms; {card})")

    # the torch-op programs at their shapes: bytes in and out over HBM
    n = 2 * spacked.shape[1]
    one = spacked[:1]
    keys1, acgt1, isn1 = M.seg_rows(one, lens[:1], key_len)
    ta1, tb1, ta2, tb2 = bta[0], btb[0], bta[1], btb[1]
    # the anchor join at a whole-genome dispatch: texts of 60,000 symbols
    # against group references of 60,000 symbols (65,536-symbol buckets),
    # as many rows as _ANCHOR_CHUNK_ELEMS admits
    a_rows = M._ANCHOR_CHUNK_ELEMS // (n + n // 4)
    aidx = torch.arange(a_rows, device=dev) % spacked.shape[0]
    apacked = spacked[aidx].contiguous()
    arefs = spacked
    joined = M.anchor_join(apacked, arefs, aidx, key_len)
    progs = {
        "seg_rows_strided": (lambda: M.seg_rows_strided(spacked, lens, key_len, stride),
                             bound(spacked.numel() + keys_s.numel() * 16 + 4 * keys_s.shape[0], 0),
                             f"{spacked.shape[0]} segments x {n} symbols"),
        "seg_rows": (lambda: M.seg_rows(one, lens[:1], key_len),
                     bound(one.numel() + keys1.numel() * 10, 0), f"1 segment x {n} symbols"),
        "ref_slot_tables": (lambda: M.ref_slot_tables(rpacked, key_len, log2_h),
                            bound(rpacked.numel() + 2 * bta.numel() * 8, 0),
                            f"{rpacked.shape[0]} references x {2 * rpacked.shape[1]} symbols, "
                            f"H = {bta.shape[1]}"),
        "split_point": (lambda: M.split_point(keys1, acgt1, isn1, int(lens[0]), ta1, tb1, ta2,
                                              tb2, key_len, False, True),
                        bound(keys1.numel() * 10 + 2 * 64 * (keys1.shape[1] // 4), 0),
                        f"1 segment x {n} symbols, two bank rows"),
        "anchor_join": (lambda: M.anchor_join(apacked, arefs, aidx, key_len),
                        bound(apacked.numel() * 2 + joined.numel() * 4, 0),
                        f"{a_rows} texts x {n} symbols against references of {n}"),
        "anchor_select": (lambda: M.anchor_select(joined),
                          bound(joined.numel() * 4 + joined.shape[0] * 128, 0),
                          f"{a_rows} rows x {joined.shape[1]} diagonals"),
    }
    times = {}
    for name, (fn, bnd, shape) in progs.items():
        times[name] = dict(ms=cuda_ms(torch, fn, 3), bound_ms=bnd[0], shape=shape,
                           replaces=MATCH_PROGRAMS[name])
        print(f"match layer torch ops {name}: {times[name]['ms']:.4f} ms at {shape}, bound "
              f"{bnd[0]:.4f} ms (bytes; {card})")
    del joined, apacked
    torch.cuda.empty_cache()
    return times


def structural_collection(np, tk, Compressor, CompressorParams, rng, tmp: str) -> list:
    """Phase 9c's input where every part of the match layer has work: a
    reference of 2 contigs of 1 Mbase and four samples. Around every fourth
    splitter s_a (segment 8000), the first sample deletes the k-mers of the
    next two splitters (a new group joins s_a to s_a+3) and the second that
    of the next one (a missing-middle split search); the third ends contigs
    just after such s_a, so their tail segments' one-splitter searches rank
    three candidate groups (the estimate prepass); the fourth holds pieces
    of 9,000 symbols with a substitution every 20 symbols, whose segments
    lose their splitters and go to -f's fallback votes (at segment 12000,
    the shortlist). Returns the five paths."""
    base = [structured_ref(np, rng, 1_000_000) for _ in range(2)]
    files = [os.path.join(tmp, f"v{i}.fa") for i in range(5)]
    write_fasta(np, files[0], [(f"vctg{i}", b) for i, b in enumerate(base)])
    comp = Compressor(os.path.join(tmp, "probe.agc"), CompressorParams(segment_size=8000),
                      reference_file=files[0], device=DEVICE)
    splitters = np.array(sorted(comp.splitter_set_snapshot()), dtype=np.uint64)
    comp.abort()
    drops = {1: [], 2: []}
    tails = []
    for ci, b in enumerate(base):
        canon, valid = tk.canon_kmers_np(b, 31)
        pos = np.flatnonzero(valid & np.isin(canon, splitters)).tolist()
        for s in drops:
            drops[s].append(np.zeros(len(b), dtype=bool))
        for i in range(2, len(pos) - 4, 4):
            for s, n_del in ((1, 2), (2, 1)):
                for p in pos[i + 1 : i + 1 + n_del]:
                    drops[s][ci][p - 60 : p + 20] = True
            tails.append((ci, pos[i]))
    for s in drops:
        write_fasta(np, files[s], [(f"vctg{i}", mutate(np, rng, b[~d]))
                                   for i, (b, d) in enumerate(zip(base, drops[s]))])
    write_fasta(np, files[3], [(f"vtail{j}", mutate(np, rng, base[ci][max(0, a - 30_000) : a + 500]))
                               for j, (ci, a) in enumerate(tails)])
    pieces = []
    for ci, b in enumerate(base):
        for s in range(1000, len(b) - 9000, 45_000):
            p = b[s : s + 9000].copy()
            p[::20] = (p[::20] + 1) % 4
            pieces.append((f"vpiece{ci}.{s}", p))
    write_fasta(np, files[4], pieces)
    return files


def counting(counts: dict, name: str, fn):
    def call(*args, **kw):
        counts[name] += 1
        return fn(*args, **kw)
    return call


def match_layer(np, torch, ck, cm, M, tk, cmod, Compressor, CompressorParams, create_archive,
                ArchiveReader, AGCFile, LZDiff, results, programs, card, tmp, wfiles, names,
                wseqs, files4, cfiles, ffiles, stamp) -> None:
    """Phase 9: the match layer at full width. See the module docstring."""
    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    calls = {name: 0 for name in MATCH_PROGRAMS}
    saved = {name: getattr(M, name) for name in MATCH_PROGRAMS}
    for name in MATCH_PROGRAMS:
        setattr(M, name, counting(calls, name, saved[name]))
    real_sets = M.anchor_diag_sets
    try:
        # -- 9a: anchor mode on the whole-genome input ----------------------
        kept = []  # up to 4096 (text, gid, set) of the run

        def keeping(texts, gids, bank, provider, key_len):
            out = real_sets(texts, gids, bank, provider, key_len)
            for t, g, s in zip(texts, gids, out):
                if len(kept) < 4096:
                    kept.append((t, g, None if s is None else s.copy()))
            return out

        M.anchor_diag_sets = keeping
        wtotal = sum(len(c) for cs in wseqs.values() for c in cs)
        out = os.path.join(tmp, "anchor.agc")
        for name in calls:
            calls[name] = 0
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = Compressor(out, CompressorParams(lz_mode="anchor", verbosity=1),
                          reference_file=wfiles[0], device=DEVICE)
        comp.add_sample_files([(cmod.sample_name_from_path(f), f) for f in wfiles])
        comp.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        M.anchor_diag_sets = real_sets
        launches = dict(ck.LAUNCHES)
        acalls = dict(calls)
        timers = comp.timers
        print(f"anchor whole-genome create (lz_mode anchor, default parameters): {wtotal} bases "
              f"in {wall:.4f} s = {wtotal / wall / 1e6:.2f} Mbases/s ({card}); archive "
              f"{os.path.getsize(out)} bytes; launches {launches}; match-layer torch-op "
              f"calls {acalls}; device_lz_tables {timers.times['device_lz_tables']:.4f} s; "
              f"device_match {timers.times['device_match']:.4f} s, "
              f"{timers.units['device_match']} pair-symbols")
        print("anchor stage timers (s): " + json.dumps(
            {n: round(t, 4) for n, t in sorted(timers.times.items(), key=lambda kv: -kv[1])}))
        check(timers.times["device_lz_tables"] > 0 and acalls["anchor_join"] > 0,
              "the anchor create computed no table on the card")
        check(launches["kmer_dir_rc"] > 0, "the anchor create never launched kmer_dir_rc")
        results["kmer_dir_rc"]["anchor_create_launches"] = launches["kmer_dir_rc"]
        for name in ("anchor_join", "anchor_select"):
            programs[name]["phase9_calls"] = acalls[name]
        # the kept sets against the host twin and the torch ops on the CPU
        t0 = time.perf_counter()

        def prepared(gid):
            lz = LZDiff(CompressorParams().min_match_len)
            lz.prepare(comp._ref_codes_of(gid))
            return gid, lz

        # the native calls release the interpreter lock: one thread a core
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            lzs = dict(pool.map(prepared, sorted({g for _t, g, _s in kept})))
            hosts = list(pool.map(lambda k: lzs[k[1]].anchor_diags_host(k[0]), kept))
        for (_t, gid, s), host in zip(kept, hosts):
            check((s is None) == (host is None) and (s is None or np.array_equal(s, host)),
                  f"an anchor set of group {gid} differs from the host twin")
        n_sets = sum(s is not None for _t, _g, s in kept)
        del lzs, hosts
        # the CPU's torch ops take ~14 ms a set: the first 1024 only
        on_cpu = kept[:1024]
        plain = real_sets([t for t, _g, _s in on_cpu], [g for _t, g, _s in on_cpu],
                          M.AnchorCodeBank("cpu"), comp._ref_codes_of,
                          CompressorParams().min_match_len - 3)
        for (_t, g, s), p in zip(on_cpu, plain):
            check((s is None) == (p is None) and (s is None or np.array_equal(s, p)),
                  f"an anchor set of group {g} differs from the CPU's torch ops")
        print(f"anchor sets: {len(kept)} kept ({n_sets} with a set) equal to the host twin "
              f"(lz_anchor_diags), the first {len(on_cpu)} to the join and select on the CPU "
              f"({time.perf_counter() - t0:.1f} s)")
        check(n_sets > len(kept) // 2, f"only {n_sets} of {len(kept)} kept pairs had a set")
        del kept, plain, comp
        t0 = time.perf_counter()
        with AGCFile(out) as agc:
            for sname, contigs in wseqs.items():
                for cname, seq in zip(names, contigs):
                    check(agc.GetCtgSeq(sname, cname).encode("latin-1") == alpha[seq].tobytes(),
                          f"{cname}@{sname} does not extract byte-equal from the anchor archive")
        print(f"anchor extract: {len(wseqs)} samples x {len(names)} contigs byte-equal "
              f"({time.perf_counter() - t0:.1f} s)")
        os.unlink(out)
        torch.cuda.empty_cache()

        stamp("9a")

        # -- 9b: the device tables change no byte ----------------------------
        a, b = os.path.join(tmp, "lz1.agc"), os.path.join(tmp, "lz0.agc")
        walls = []
        for path, flag in ((a, "1"), (b, "0")):
            os.environ["AGC_TPU_DEVICE_LZ"] = flag
            try:
                t0 = time.perf_counter()
                create_archive(path, files4, CompressorParams(lz_mode="anchor"), device=DEVICE)
                walls.append(time.perf_counter() - t0)
            finally:
                del os.environ["AGC_TPU_DEVICE_LZ"]
        equal = same_archive(ArchiveReader, a, b)
        print(f"anchor chr-scale create, tables on the card {walls[0]:.2f} s, host twin "
              f"{walls[1]:.2f} s; archives equal part for part: {equal} ({card})")
        check(equal, "anchor archives differ between device tables on and off")

        stamp("9b")

        # -- 9c: the forced prepass, card against CPU -------------------------
        vfiles = structural_collection(np, tk, Compressor, CompressorParams,
                                       np.random.default_rng(SEED + 12), tmp)
        stress = dict(kmer_length=17, min_match_len=15, segment_size=1000,
                      pack_cardinality=50000)
        held = []  # every match_estimate call of the structural run
        real_est = M.match_estimate
        pairs = [0]

        def keep_est(*args):
            got = real_est(*args)
            pairs[0] += args[4].numel()
            if keep[0]:
                held.append(([x.clone() if torch.is_tensor(x) else x for x in args], got.clone()))
            return got

        keep = [False]
        M.match_estimate = keep_est
        os.environ["AGC_TPU_DEVICE_MATCH"] = "1"
        total_launches = 0
        try:
            runs = (
                ("phase 4's input", CompressorParams(), files4),
                ("segment 1000", CompressorParams(segment_size=1000), cfiles),
                ("-a -f 0.01", CompressorParams(adaptive_compression=True,
                                                fallback_frac=0.01, **stress), ffiles),
                ("structural, segment 8000", CompressorParams(segment_size=8000), vfiles),
                ("structural -f 0.2 -k 17 -l 15 -s 12000",
                 CompressorParams(fallback_frac=0.2, kmer_length=17, min_match_len=15,
                                  segment_size=12000), vfiles),
            )
            # every run's CPU create starts at once (the run's time limit)
            on_cpus = [cpu_create(os.path.join(tmp, f"cpu{i}.agc"), lfiles, params)
                       for i, (_label, params, lfiles) in enumerate(runs)]
            for i, (label, params, lfiles) in enumerate(runs):
                a, b = os.path.join(tmp, "card.agc"), os.path.join(tmp, f"cpu{i}.agc")
                on_cpu = on_cpus[i]
                keep[0] = label == "structural, segment 8000"
                pairs[0] = 0
                for name in calls:
                    calls[name] = 0
                ck.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctimes = create_archive(a, lfiles, params, device=DEVICE)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
                launches, pcalls, n_pairs = dict(ck.LAUNCHES), dict(calls), pairs[0]
                keep[0] = False
                t_cpu = cpu_done(on_cpu)
                equal = same_archive(ArchiveReader, a, b)
                print(f"forced match ({label}): card {t_card:.2f} s, CPU {t_cpu:.2f} s; "
                      f"match_estimate dispatches {launches['match_estimate']}, pairs {n_pairs}; "
                      f"torch-op calls {pcalls}; device_match {ctimes.times['device_match']:.4f} "
                      f"s, {ctimes.units['device_match']} pair-symbols; kmer_dir_rc launches "
                      f"{launches['kmer_dir_rc']}; archives equal part for part: {equal} ({card})")
                check(equal, f"card and CPU archives differ under the forced prepass ({label})")
                total_launches += launches["match_estimate"]
                for name in ("seg_rows_strided", "seg_rows", "ref_slot_tables", "split_point"):
                    programs[name]["phase9_calls"] = (programs[name].get("phase9_calls", 0)
                                                      + pcalls[name])
                if label.startswith("structural"):
                    check(launches["match_estimate"] > 0,
                          f"the forced run ({label}) never launched match_estimate")
                if label == "structural, segment 8000":
                    check(pcalls["split_point"] > 0, "the forced run made no split search")
        finally:
            M.match_estimate = real_est
            del os.environ["AGC_TPU_DEVICE_MATCH"]
        errs = [max_abs_err(torch, got, cm.match_estimate_plain(*args)) for args, got in held]
        print(f"forced match (structural, segment 8000): {len(held)} match_estimate calls "
              f"({sum(a[4].numel() for a, _ in held)} pairs) against the plain version on the "
              f"card, max_abs_err {max(errs, default=None)}")
        check(errs and max(errs) == 0, f"kept match_estimate calls disagree or none ran ({errs})")
        results["match_estimate"]["launches"] = total_launches
    finally:
        for name, fn in saved.items():
            setattr(M, name, fn)
        M.anchor_diag_sets = real_sets


# The device rANS coder (ops/device_rans.py): kernel checks of phase 3,
# then phase 10. int32 operations (csrc/rans.cu's note): encode ~12 a
# symbol in the reciprocal form (the symbol and its table entry, the two
# renorm tests, the multiply-high and shift, the state update), decode ~10
# a symbol, 3 more a stream byte (store or load, shift, count); the tables
# 2 a symbol (its histogram count) and 16 a table entry a part (quantize
# and reciprocal); the layout 2 a frequency and 8 a lane (varint lengths,
# sums, the lane scan). The first port of the encode counted 27 a symbol,
# with the runtime division (~17 of them).
RANS_ENCODE_OPS = 12
RANS_ENCODE_OPS_PR8 = 27
RANS_DECODE_OPS = 10
RANS_BYTE_OPS = 3
RANS_HIST_OPS = 2
RANS_TABLE_OPS = 16 * 256
RANS_LAYOUT_OPS = 2 * 256
RANS_LANE_OPS = 8


def rans_bounds(n_sym: int, n_coded: int, n_stream: int, n_blob: int, n_raw: int,
                n_parts: int, n_lanes: int, n_coded_parts: int, n_coded_lanes: int) -> dict:
    """Bounds of a flush of n_parts parts, n_lanes lanes and n_sym symbols
    (n_coded of them in the n_coded_parts parts, of n_coded_lanes lanes,
    that are coded, n_raw in raw escapes), whose coded parts' streams hold
    n_stream bytes and whose blobs n_blob bytes, each input read once and
    each output written once: rans_tables reads the symbols and writes 1 KB
    of frequencies and 2 KB of table a part; rans_encode reads the symbols
    and the tables and writes 8 bytes a lane; rans_write reads every part's
    meta row and 1 KB of frequencies and every lane's 4-byte count (its
    layout), the coded parts' symbols, 2 KB of table a coded part and 4
    bytes of state a coded lane, and the raw payloads, and writes the
    blobs, coding the coded symbols; the flush as
    one function reads the symbols and writes the blobs, coding every
    symbol once; rans_layout reads a meta row, 1 KB of frequencies a part
    and 4 bytes a lane, and writes 16 bytes a part and 8 a lane.
    'encode_pr8' is the first port's count of the encode (27 operations a
    symbol, its streams written, 1 KB a part)."""
    tables = bound(n_sym + 3072 * n_parts, RANS_HIST_OPS * n_sym + RANS_TABLE_OPS * n_parts)
    encode = bound(n_sym + 2048 * n_parts + 8 * n_lanes, RANS_ENCODE_OPS * n_sym)
    write = bound(n_coded + n_raw + 1056 * n_parts + 4 * n_lanes + 2048 * n_coded_parts
                  + 4 * n_coded_lanes + n_blob,
                  RANS_ENCODE_OPS * n_coded + RANS_BYTE_OPS * (n_stream + n_raw))
    flush = bound(n_sym + 32 * n_parts + n_blob,
                  (RANS_HIST_OPS + RANS_ENCODE_OPS) * n_sym + RANS_TABLE_OPS * n_parts
                  + RANS_BYTE_OPS * (n_stream + n_raw))
    encode_pr8 = bound(n_sym + n_stream + 1024 * n_parts + 8 * n_lanes,
                       RANS_ENCODE_OPS_PR8 * n_sym + RANS_BYTE_OPS * n_stream)
    layout = bound(1072 * n_parts + 12 * n_lanes,
                   RANS_LAYOUT_OPS * n_parts + RANS_LANE_OPS * n_lanes)
    return dict(tables=tables, encode=encode, layout=layout, write=write, flush=flush,
                encode_pr8=encode_pr8)


def rans_decode_bound(n_sym: int, n_stream: int, n_lanes: int,
                      n_blobs: int = 1) -> tuple[float, str]:
    """rans_decode of n_blobs blobs: their symbols written and their stream
    bytes read once, 1 KB of frequencies a blob and 8 bytes a lane (state
    and offset): the sum of each blob's bound."""
    return bound(n_sym + n_stream + 1024 * n_blobs + 8 * n_lanes,
                 RANS_DECODE_OPS * n_sym + RANS_BYTE_OPS * n_stream)


def decode_batch_bound(args) -> tuple[float, str]:
    """rans_decode_bound of a batch (blob_tensors' args)."""
    stream, _off, states, _freqs, meta = args
    return rans_decode_bound(int(meta[:, 0].sum()), stream.numel(), states.numel(), len(meta))


def coded_blob(np, E, data: bytes) -> bytes:
    """The coded form of a payload, kept where entropy.assemble_blob would
    escape it (under ~600 bytes): the decoders take it, and it is how the
    1- and 8-lane tiers are reached."""
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = E.quantize_freqs(np.bincount(arr, minlength=256))
    streams, states = E._encode_lanes(arr, freqs)
    out = bytearray([E.MAGIC, E.lanes_for(len(data)).bit_length() - 1])
    for v in (len(data), *freqs.tolist(), *map(len, streams)):
        E._put_varint(out, int(v))
    for x in states:
        out += int(x).to_bytes(4, "little")
    return bytes(out + b"".join(streams))


def decode_batch(torch, D, dev, blobs: list) -> list:
    """blobs through one rans_decode launch (blob_tensors, then slices)."""
    done, args = D.blob_tensors(blobs, dev)
    return D._decoded(done, D.rans_decode(*args), args[4])


def rans_cases(np) -> list:
    """Hard payloads: agc_tpu's test_entropy cases, every lane tier's edges,
    last rows partly inactive, rare symbols of frequency 1 (two-byte
    renorms), a single symbol (no emission), a raw escape, the
    quantization's edges (every symbol once, a dominant symbol among 255
    rare ones: many passes of -1), more 1-lane parts than a work row of
    256, a fuzz; raw escapes of random lengths (sources and destinations at
    every alignment mod 16), with 1- to 4-byte length varints (n on both
    sides of 128, 16384 and 2^21), and raw and coded parts that straddle
    64 KB chunks."""
    rng = np.random.default_rng(SEED + 11)

    def sym(alpha: int, n: int) -> bytes:
        return rng.integers(0, alpha, n, dtype=np.uint16).astype(np.uint8).tobytes()

    cases = [b"", b"Z", b"ACGT" * 64, sym(256, 10_000), sym(4, 200_000),
             np.repeat(np.arange(5, dtype=np.uint8), 30_000).tobytes(), b"\x00" * 70_000,
             sym(16, 1023), sym(16, 1024), sym(16, 63)]
    cases += [sym(5, n) for n in (63, 64, 1023, 1024, 8191, 8192, 65535, 65536)]
    cases += [sym(4, 256 * 70 + 13), sym(4, 1024 * 100 + 1)]
    skew = np.zeros(50_000, dtype=np.uint8)
    skew[rng.integers(0, len(skew), 12)] = rng.integers(1, 256, 12)
    cases.append(skew.tobytes())
    cases.append(np.arange(256, dtype=np.uint8).tobytes())
    dominant = np.full(3_000_000, 7, dtype=np.uint8)
    dominant[rng.choice(len(dominant), 255, replace=False)] = np.delete(np.arange(256), 7)
    cases.append(dominant.tobytes())
    cases += [sym(int(rng.integers(1, 5)), int(rng.integers(1, 64))) for _ in range(300)]
    cases += [sym(int(rng.integers(1, 257)), int(rng.integers(1, 300_000))) for _ in range(10)]
    cases += [sym(256, int(n)) for n in rng.integers(40, 3000, 48)]
    cases += [sym(256, n) for n in (127, 128, 16383, 16384, (1 << 21) - 1, (1 << 21) + 37,
                                    3 * 65536 + 5)]
    cases.append(sym(4, 2 * 65536 + 77))
    return cases


def without_sync(torch, fn):
    """fn under torch.cuda.set_sync_debug_mode("error"): any call in it that
    waits on the card (a .item(), a .cpu(), a size read back) raises. The
    mode is the process's, so this wraps only calls made while no other
    thread uses the card."""
    def call(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


def rans_kernels(np, torch, D, E, dev, results) -> None:
    """Phase 3: rans_tables, rans_encode and rans_write on every hard case
    in one flush (all five lane tiers), against their plain versions on
    the card, the blobs against the host native coder; rans_decode on each
    coded blob against its plain version and the input."""
    cases = rans_cases(np)
    live = [c for c in cases if c]
    prep = D._prepare(live)
    data, meta, chunks, sel, work = D._upload(prep, dev)
    tiers = sorted(set(prep.meta[:, 2].tolist()))
    check(tiers == [1, 8, 64, 256, 1024], f"the rANS cases cover tiers {tiers}")
    freqs, enc = D.rans_tables(data, meta, chunks)
    want_freqs, want_enc = D.rans_tables_plain(data, meta)
    tab_err = max(max_abs_err(torch, freqs, want_freqs), max_abs_err(torch, enc, want_enc))
    check(tab_err == 0, f"rans_tables disagrees with its plain version ({tab_err})")
    host_freqs = np.stack([E.quantize_freqs(np.bincount(np.frombuffer(c, dtype=np.uint8),
                                                        minlength=256)) for c in live])
    check((freqs.cpu().numpy() == host_freqs.astype(np.int64)).all(),
          "rans_tables' frequencies differ from quantize_freqs")
    counts, states = D.rans_encode(data, meta, enc, sel, work, prep.n_lanes)
    p_counts, p_states = D.rans_encode_plain(data, meta, enc)
    enc_err = max(max_abs_err(torch, counts, p_counts), max_abs_err(torch, states, p_states))
    check(enc_err == 0, f"rans_encode disagrees with its plain version ({enc_err})")
    layout = D.rans_layout(meta, freqs, counts)
    want_layout = D.blob_offsets(meta, freqs, counts)
    lay_err = max(max_abs_err(torch, a, b) for a, b in zip(layout, want_layout))
    check(lay_err == 0, f"rans_layout disagrees with blob_offsets ({lay_err})")
    out, blob_off = D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    want_out = D.rans_write_plain(data, meta, freqs, enc, counts, states, blob_off)
    check(out.numel() >= want_out.numel(), "rans_write's buffer is smaller than its blobs")
    wr_err = max(max_abs_err(torch, out[: want_out.numel()], want_out),
                 max_abs_err(torch, blob_off, want_layout[0]))
    check(wr_err == 0, f"rans_write disagrees with its plain version ({wr_err})")
    want_blobs = [E.compress(c) for c in live]
    blobs = D._slice(*D._download(out, blob_off))
    check(blobs == want_blobs, "the card's blobs differ from the host coder's")
    # the raw escapes' copies at every alignment, every length varint width
    raw = (want_layout[1] < 0).cpu().numpy()
    lens = prep.meta[:, 1]
    heads = np.array([2 + E._varint_len(int(n)) for n in lens])
    src = set((prep.meta[raw, 0] % 16).tolist())
    dst = set(((blob_off[:-1].cpu().numpy() + heads)[raw] % 16).tolist())
    widths = {E._varint_len(int(n)) for n in lens[raw]}
    check(src == dst == set(range(16)) and widths == {1, 2, 3, 4}
          and (lens[raw] > D._CHUNK).any() and (lens[~raw] > D._CHUNK).any(),
          f"the raw escapes cover sources {sorted(src)}, destinations {sorted(dst)} mod 16, "
          f"length varints {sorted(widths)}")
    # the whole flush with no host sync until its download
    flush = without_sync(torch, D.code_flush)(data, meta, chunks, sel, work, prep.n_lanes)
    check(D._slice(*D._download(*flush)) == want_blobs,
          "code_flush under the sync check differs from the host coder")
    n_bad = rans_refusals(np, torch, D, prep, data, meta, chunks, sel, work, freqs, enc, counts,
                          states, want_blobs)
    check(D.encode_batch(cases, dev) == [E.compress(c) for c in cases],
          "encode_batch differs from the host coder")
    # rans_decode: every coded blob of the flush, and the coded forms of
    # the cases the coder escapes (the 1- and 8-lane tiers), in one batch;
    # then each tier in a batch of its own, and each coded blob alone
    # through decompress_device
    small = [c for c in live if len(c) < 1024]
    dec_in = blobs + [coded_blob(np, E, c) for c in small]
    dec_want = live + small
    done, dargs = D.blob_tensors(dec_in, dev)
    out = D.rans_decode(*dargs)
    dec_err = max_abs_err(torch, out, D.rans_decode_plain(*dargs))
    check(dec_err == 0 and D._decoded(done, out, dargs[4]) == dec_want,
          f"rans_decode of the cases' batch disagrees ({dec_err})")
    dec_tiers = sorted(set(dargs[4][:, 1].tolist()))
    check(dec_tiers == [1, 8, 64, 256, 1024], f"the decoded blobs cover tiers {dec_tiers}")
    for tier in dec_tiers:
        pick = [(b, c) for b, c in zip(dec_in, dec_want)
                if E.lanes_for(len(c)) == tier and not b[1] & E._RAW_FLAG]
        check(decode_batch(torch, D, dev, [b for b, _ in pick]) == [c for _, c in pick],
              f"rans_decode of the {tier}-lane blobs alone disagrees")
    n_dec = sum(d is None for d in done)
    check(all(D.decompress_device(b, len(c), DEVICE) == c for b, c in zip(dec_in, dec_want)),
          "decompress_device does not give a case's input")
    n_raw = sum(bool(b[1] & E._RAW_FLAG) for b in blobs)
    print(f"rans_tables / rans_encode / rans_layout / rans_write: {len(live)} parts of "
          f"{len(prep.data)} bytes in one flush (lane tiers {tiers}, {len(prep.work)} encode "
          f"blocks, {n_raw} raw escapes: sources and destinations at all 16 alignments, "
          f"length varints of 1-4 bytes), max_abs_err {tab_err} / {enc_err} / {lay_err} / "
          f"{wr_err}, tables equal to quantize_freqs, every blob equal to the host coder's, "
          f"code_flush with no host sync, {n_bad} malformed chunk lists refused and the flush "
          f"after each right, rans_encode without its lane count refused; "
          f"rans_decode: {n_dec} coded blobs of tiers {dec_tiers} decoded to their inputs in "
          f"one launch, each tier alone, each blob alone, "
          f"max_abs_err {dec_err}")
    for name, replaces, err in (
            ("rans_tables", "agc_tpu/ops/device_rans.py:242", tab_err),
            ("rans_encode", "agc_tpu/ops/device_rans.py:143", enc_err),
            ("rans_layout", "agc_tpu/ops/device_rans.py:266", lay_err),
            ("rans_write", "agc_tpu/ops/device_rans.py:266", wr_err),
            ("rans_decode", "agc_tpu/ops/device_rans.py:277", dec_err)):
        results[name] = dict(source="agc_tpu_torch/csrc/rans.cu", replaces=replaces,
                             max_abs_err=err, library_ms=None)


def rans_refusals(np, torch, D, prep, data, meta, chunks, sel, work, freqs, enc, counts, states,
                  want_blobs) -> int:
    """Chunk lists that are not _prepare's, on the card: each through
    code_flush (the tables take it) and through rans_write alone (the
    tables take the right one) must be refused at the download, and the
    right flush after each must give the host coder's blobs (the scratch
    left zero); rans_encode without its lane count must raise. Returns the
    number of lists."""
    good = prep.chunks
    multi = int(np.flatnonzero(good[1:, 0] == good[:-1, 0])[0]) + 1  # a part's 2nd chunk
    bad = {"an entry dropped": np.delete(good, multi, axis=0),
           "an entry repeated": np.insert(good, multi, good[multi], axis=0),
           "two entries swapped": good[np.r_[0:multi - 1, multi, multi - 1, multi + 1:len(good)]],
           "a start moved by 16 bytes": np.where(np.arange(len(good))[:, None] == multi,
                                                 good + [0, 16], good),
           "the last entry cut off": good[:-1],
           "an entry past the parts": np.vstack([good, [len(prep.meta), 0]])}
    for what, rows in bad.items():
        rows = torch.from_numpy(np.ascontiguousarray(rows)).to(data.device)
        for whose, run in (
                ("code_flush", lambda: D.code_flush(data, meta, rows, sel, work, prep.n_lanes)),
                ("rans_write", lambda: D.rans_write(data, meta, rows, sel, work, freqs, enc,
                                                    counts, states))):
            try:
                D._download(*run())
            except ValueError:
                pass
            else:
                check(False, f"{whose} took a chunk list with {what}")
            got = D.code_flush(data, meta, chunks, sel, work, prep.n_lanes)
            check(D._slice(*D._download(*got)) == want_blobs,
                  f"the flush after {whose}'s chunk list with {what} differs")
    try:
        D.rans_encode(data, meta, enc, sel, work)
    except ValueError:
        pass
    else:
        check(False, "rans_encode ran on the card without its lane count")
    return len(bad)


def rans_split(torch, calls: dict, reps: int = 5, tries: int = 4) -> dict:
    """Each call's time split by torch.profiler into the device activities it
    launches (its kernels, and any memset or copy), ms a call: {call: {name:
    ms}}; calls: {call: (fn, the kernels it launches)}. The profiler drops
    a window's device events at times, after earlier profiler runs in the
    process, so a window that misses any of the call's kernels is run
    again, up to `tries` times ("tries" says how many it took); a call
    whose kernels never all showed is None."""
    act = torch.profiler.ProfilerActivity
    split = {}
    for name, (fn, kernels) in calls.items():
        fn()
        torch.cuda.synchronize()
        got = None
        for n_try in range(1, tries + 1):
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by_name = device_time(torch, prof)[1]
            del prof
            acts = {kernel_name(k): ms / reps for k, ms in by_name.items()}
            if all(k in acts for k in kernels):
                got = {**acts, "tries": n_try}
                break
        split[name] = got
    return split


def opt_ms(v) -> str:
    return "not recorded" if v is None else f"{v:.4f}"


def rans_timing(np, torch, D, E, dev, results, card, payloads: list, blobs: list) -> None:
    """The kernels at the shape of the largest flush (its payloads and the
    blobs the card gave them): rans_tables, rans_encode, rans_layout and
    rans_write over its parts, and the four as the flush (code_flush), each
    whole call timed with CUDA events and split by torch.profiler into its
    kernels and torch ops; the flush once more with no host sync allowed
    until its download, its blobs equal to the given ones; the flush
    through encode_batch on the card and through the host native coder."""
    t0 = time.perf_counter()
    D.encode_batch(payloads, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in payloads:
        E.compress(p)
    host_s = time.perf_counter() - t0
    live = [p for p in payloads if p]
    prep = D._prepare(live)
    data, meta, chunks, sel, work = D._upload(prep, dev)
    n_lanes = prep.n_lanes
    flush = without_sync(torch, D.code_flush)(data, meta, chunks, sel, work, n_lanes)
    check(D._slice(*D._download(*flush)) == [b for p, b in zip(payloads, blobs) if p],
          "the largest flush under the sync check differs from the create's blobs")
    freqs, enc = D.rans_tables(data, meta, chunks)
    counts, states = D.rans_encode(data, meta, enc, sel, work, n_lanes)
    out, blob_off = D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    _boff, stream_at, lane_cs = D.blob_offsets(meta, freqs, counts)
    lens = meta[:, 1]
    coded = stream_at >= 0
    n_coded = int(lens[coded].sum())
    n_coded_lanes = int(meta[:, 2][coded].sum())
    n_raw = int(lens.sum()) - n_coded
    part_bytes = lane_cs[meta[:, 3] + meta[:, 2]] - lane_cs[meta[:, 3]]
    n_stream = int(part_bytes[coded].sum())
    n_blob = int(blob_off[-1])
    b = rans_bounds(int(lens.sum()), n_coded, n_stream, n_blob, n_raw, len(live), n_lanes,
                    int(coded.sum()), n_coded_lanes)
    shape = (f"the largest flush: {len(live)} parts ({int(coded.sum())} coded), "
             f"{int(lens.sum())} bytes, {n_lanes} lanes, {n_blob} blob bytes ({n_raw} raw)")
    runs = {
        "rans_tables": (lambda: D.rans_tables(data, meta, chunks),
                        lambda: D.rans_tables_plain(data, meta), b["tables"]),
        "rans_encode": (lambda: D.rans_encode(data, meta, enc, sel, work, n_lanes),
                        lambda: D.rans_encode_plain(data, meta, enc), b["encode"]),
        "rans_layout": (lambda: D.rans_layout(meta, freqs, counts),
                        lambda: D.blob_offsets(meta, freqs, counts), b["layout"]),
        "rans_write": (lambda: D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts,
                                            states),
                       lambda: D.rans_write_plain(data, meta, freqs, enc, counts, states,
                                                  blob_off), b["write"]),
    }
    for name, (fn, plain, bnd) in runs.items():
        r = results[name]
        r["ms"] = cuda_ms(torch, fn, 5)
        r["plain_ms"] = cuda_ms(torch, plain, 1)
        r["bound"] = bnd
        r["shape"] = shape
    re = results["rans_encode"]
    flush_fn = lambda: D.code_flush(data, meta, chunks, sel, work, n_lanes)  # noqa: E731
    re["flush_ms"] = cuda_ms(torch, flush_fn, 5)
    re["flush_bound_ms"] = b["flush"][0]
    re["flush_bound_by"] = b["flush"][1]
    re["old_count_bound_ms"] = b["encode_pr8"][0]
    kernels = {"rans_tables": ("rans_hist_kernel", "rans_quantize_kernel"),
               "rans_encode": ("rans_encode_kernel",), "rans_layout": ("rans_layout_kernel",),
               "rans_write": ("rans_layout_kernel", "rans_write_kernel", "rans_streams_kernel")}
    kernels["code_flush"] = tuple(dict.fromkeys(k for v in kernels.values() for k in v))
    split = rans_split(torch, {name: (fn, kernels[name]) for name, fn in
                               [*((n, fn) for n, (fn, _p, _b) in runs.items()),
                                ("code_flush", flush_fn)]})

    def kernels_ms(name):  # None where the profiler did not record them all
        return split[name] and sum(split[name][k] for k in kernels[name])

    for name in runs:
        results[name]["kernel_ms"] = kernels_ms(name)
    re["flush_kernel_ms"] = kernels_ms("code_flush")
    print("rANS calls split by torch.profiler (device ms a call; the call's CUDA-event ms "
          f"beside it; {card}): " + "; ".join(
              f"{name} {results[name]['ms'] if name in results else re['flush_ms']:.4f}: "
              + (", ".join(f"{k} {ms:.4f}" if k != "tries" else f"{k} {ms}"
                           for k, ms in sorted(acts.items(), key=lambda kv: -kv[1]))
                 if acts else "its kernels not all recorded")
              for name, acts in split.items()))
    print(f"rANS over {shape}: " + "; ".join(
        f"{name} {results[name]['ms']:.4f} ms, kernels {opt_ms(results[name]['kernel_ms'])} ms "
        f"(bound {results[name]['bound'][0]:.4f} ms, {results[name]['bound'][1]}), plain "
        f"{results[name]['plain_ms']:.4f} ms" for name in runs)
        + f"; the four as the flush (code_flush) {re['flush_ms']:.4f} ms, kernels "
        f"{opt_ms(re['flush_kernel_ms'])} ms (bound {re['flush_bound_ms']:.4f} ms, "
        f"{re['flush_bound_by']}); rans_encode under the 27-operation count: bound "
        f"{re['old_count_bound_ms']:.4f} ms; "
        f"the flush through encode_batch on the card {card_s:.4f} s, through the host native "
        f"coder {host_s:.4f} s ({card})")


def decode_timing(np, torch, D, dev, results, card, blobs: list, payloads: list,
                  key: str) -> None:
    """rans_decode of a batch of coded blobs in one launch against its plain
    version and the payloads, timed with CUDA events beside the sum of the
    blobs' bounds, and the same blobs in one launch each; then each lane
    tier's blobs alone.
    key "" writes the row's ms, plain_ms and bound; "synthetic_" writes
    them under that prefix."""
    done, args = D.blob_tensors(blobs, dev)
    check(all(d is None for d in done), "a blob of the decode batch is not coded")
    out = D.rans_decode(*args)
    e = max_abs_err(torch, out, D.rans_decode_plain(*args))
    check(e == 0 and D._decoded(done, out, args[4]) == payloads,
          f"rans_decode of {len(blobs)} blobs in one launch disagrees ({e})")
    meta = args[4]
    singles = [D.blob_tensors([b], dev)[1] for b in blobs]
    rd = results["rans_decode"]
    rd["max_abs_err"] = max(rd["max_abs_err"], e)
    one = cuda_ms(torch, lambda: D.rans_decode(*args), 10)
    each = cuda_ms(torch, lambda: [D.rans_decode(*a) for a in singles], 2)
    plain = cuda_ms(torch, lambda: D.rans_decode_plain(*args), 1)
    bnd = decode_batch_bound(args)
    kernel = ("rans_decode_kernel",)
    calls = {"batch": (lambda: D.rans_decode(*args), kernel)}
    counts = {}
    for tier in sorted(set(meta[:, 1].tolist())):
        pick = [b for b, m in zip(blobs, meta[:, 1].tolist()) if m == tier]
        counts[tier] = len(pick)
        targs = D.blob_tensors(pick, dev)[1]
        calls[f"{tier}"] = (lambda targs=targs: D.rans_decode(*targs), kernel)
    split = rans_split(torch, calls)
    dev_ms = {name: got and got["rans_decode_kernel"] for name, got in split.items()}
    tiers = {tier: {"blobs": c, "kernel_ms": dev_ms[f"{tier}"]} for tier, c in counts.items()}
    rd[f"{key}ms" if key else "ms"] = one
    rd[f"{key}kernel_ms" if key else "kernel_ms"] = dev_ms["batch"]
    rd[f"{key}plain_ms" if key else "plain_ms"] = plain
    rd[f"{key}bound_ms"] = bnd[0]
    rd[f"{key}one_launch_a_blob_ms"] = each
    rd[f"{key}tier_ms"] = tiers
    if not key:
        rd["bound"] = bnd
    shape = (f"{len(blobs)} coded blobs, {int(meta[:, 0].sum())} symbols, "
             f"{args[2].numel()} lanes, {args[0].numel()} stream bytes")
    rd[f"{key}shape"] = shape
    share = "not recorded" if dev_ms["batch"] is None else f"{100 * bnd[0] / dev_ms['batch']:.2f}%"
    print(f"rans_decode ({key or 'the run'}'s batch: {shape}): one launch {one:.4f} ms a call, "
          f"kernel {opt_ms(dev_ms['batch'])} ms ({share} of the bound), {len(blobs)} launches "
          f"{each:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}), max_abs_err "
          f"{e}; each tier's blobs alone, kernel ms: "
          f"{json.dumps(tiers)} ({card})")


def synthetic_decode(np, E) -> tuple[list, list]:
    """A synthetic batch of 4096 compressible parts from the seed: skewed
    alphabets of 4 to 16 symbols, lengths log-uniform in [1, 300,000], so
    every lane tier occurs (parts the coder would escape in coded form).
    Returns (blobs, payloads)."""
    rng = np.random.default_rng(SEED + 14)
    payloads = []
    for n in np.exp(rng.uniform(0, np.log(300_000), 4096)).astype(np.int64):
        alpha = int(rng.integers(4, 17))
        p = rng.random(alpha) ** 3 + 1e-3
        cdf = np.cumsum(p / p.sum())
        payloads.append(np.searchsorted(cdf[:-1], rng.random(int(n))).astype(np.uint8).tobytes())
    blobs = []
    for p in payloads:
        b = E.compress(p)
        blobs.append(coded_blob(np, E, p) if b[1] & E._RAW_FLAG else b)
    return blobs, payloads


def synthetic_flush(np) -> list:
    """A flush of the shape of phase 10's largest: 11,492 parts of random
    bytes, ~172 MB, all raw escapes."""
    rng = np.random.default_rng(SEED + 12)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(1, 30_016, 11_492)]


def rans_only(np, torch, D, E, dev, card) -> None:
    """--rans-only: phase 3's rANS checks, then rans_timing on the synthetic
    flush, its blobs checked against the host coder's, and decode_timing on
    the synthetic decode batch: a short chip call after a change to
    csrc/rans.cu."""
    results = {}
    rans_kernels(np, torch, D, E, torch.device(DEVICE), results)
    payloads = synthetic_flush(np)
    blobs = D.encode_batch(payloads, dev)
    check(blobs == [E.compress(p) for p in payloads],
          "the synthetic flush's blobs differ from the host coder's")
    rans_timing(np, torch, D, E, dev, results, card, payloads, blobs)
    decode_timing(np, torch, D, dev, results, card, *synthetic_decode(np, E), "synthetic_")


def rans_phase(np, torch, ck, D, E, CompressorParams, create_archive, append_archive,
               ArchiveReader, AGCFile, results, card, tmp, wfiles, names, wseqs, files4,
               cfiles) -> None:
    """Phase 10: the device rANS coder at full width. See the module
    docstring."""
    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    os.environ["AGC_TPU_RANS_DEVICE"] = "1"
    flushes = []
    tables = []  # each flush's frequencies from rans_tables, kept on the card
    split = dict.fromkeys(("prepare", "upload", "code", "download", "slice"), 0.0)

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return got
        return call

    def keeping(payloads, device="cuda"):
        blobs = real_parts(payloads, device)
        flushes.append((payloads, blobs))
        return blobs

    def keep_tables(data, meta, chunks):
        got = real_tables(data, meta, chunks)
        tables.append(got[0])
        return got

    stages = dict(_prepare="prepare", _upload="upload", code_flush="code",
                  _download="download", _slice="slice")
    saved = {name: getattr(D, name) for name in stages}
    real_parts, real_tables = E.compress_parts, D.rans_tables
    try:
        for name, key in stages.items():
            setattr(D, name, timed(key, saved[name]))
        E.compress_parts = keeping
        D.rans_tables = keep_tables
        out = os.path.join(tmp, "rans.agc")
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timers = create_archive(out, wfiles, CompressorParams(profile="tpu-rans", verbosity=1),
                                device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
    finally:
        for name, fn in saved.items():
            setattr(D, name, fn)
        E.compress_parts = real_parts
        D.rans_tables = real_tables
    for name in ("rans_tables", "rans_encode", "rans_layout", "rans_write"):
        check(launches[name] > 0, f"the tpu-rans create never launched {name}")
        results[name]["launches"] = launches[name]
    check(len(tables) == len(flushes), "a flush did not go through rans_tables")
    total = sum(len(c) for cs in wseqs.values() for c in cs)
    n_parts = sum(len(p) for p, _ in flushes)
    n_bytes = sum(len(x) for p, _ in flushes for x in p)
    payloads, blobs = max(flushes, key=lambda f: sum(map(len, f[0])))
    n_raw = sum(bool(b[1] & E._RAW_FLAG) for _, bs in flushes for b in bs if len(b) > 1)
    print(f"tpu-rans create on the card (AGC_TPU_RANS_DEVICE=1): {total} bases in {wall:.4f} s "
          f"= {total / wall / 1e6:.2f} Mbases/s ({card}); archive {os.path.getsize(out)} bytes; "
          f"{len(flushes)} flushes, {n_parts} parts ({n_raw} raw escapes), {n_bytes} payload "
          f"bytes; largest flush {len(payloads)} parts, {sum(map(len, payloads))} bytes; "
          f"launches {launches}")
    print("tpu-rans flush split (s, summed over flushes; code = rans_tables + rans_encode + "
          "rans_layout + rans_write): " + json.dumps(
        {k: round(v, 4) for k, v in split.items()}) + f" = {sum(split.values()):.4f} s")
    print("tpu-rans stage timers (s): " + json.dumps(
        {n: round(t, 4) for n, t in sorted(timers.times.items(), key=lambda kv: -kv[1])}))

    # every part's blob against the host native coder on the same payload
    t0 = time.perf_counter()
    pairs = [(p, b) for ps, bs in flushes for p, b in zip(ps, bs)]
    with ThreadPoolExecutor(8) as pool:
        same = all(pool.map(lambda pb: E.compress(pb[0]) == pb[1], pairs))
    print(f"tpu-rans blobs: {len(pairs)} equal to the host coder's: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(same, "a blob of the card's coder differs from the host coder's")
    # every part's tables (raw escapes too, whose blobs do not show them)
    # against quantize_freqs of its counts
    t0 = time.perf_counter()
    live = [p for ps, _ in flushes for p in ps if len(p)]
    card_freqs = np.concatenate([t.cpu().numpy() for t in tables])
    check(len(live) == len(card_freqs), "the kept tables do not cover every part")
    with ThreadPoolExecutor(8) as pool:
        same = all(pool.map(lambda pf: (E.quantize_freqs(np.bincount(
            np.frombuffer(pf[0], dtype=np.uint8), minlength=256)) == pf[1]).all(),
            zip(live, card_freqs)))
    print(f"tpu-rans tables: {len(live)} parts' frequencies from rans_tables equal to "
          f"quantize_freqs: {same} ({time.perf_counter() - t0:.1f} s)")
    check(same, "the card's quantized tables differ from quantize_freqs")
    del tables, card_freqs, live
    # up to 4096 coded blobs of the run back through decompress_device on
    # the card (raw escapes decode on the host)
    coded = [(p, b) for p, b in pairs if len(p) and not b[1] & E._RAW_FLAG]
    check(coded, "every part of the tpu-rans create is a raw escape")
    ck.reset_launches()
    back = [D.decompress_device(b, len(p), DEVICE) for p, b in coded[:4096]]
    results["rans_decode"]["launches"] = ck.LAUNCHES["rans_decode"]
    check(back == [p for p, _ in coded[:4096]],
          "decompress_device does not give the parts' payloads")
    print(f"decompress_device: {len(back)} of the run's {len(coded)} coded blobs decoded on the "
          f"card to their payloads ({results['rans_decode']['launches']} rans_decode launches)")
    rans_timing(np, torch, D, E, torch.device(DEVICE), results, card, payloads, blobs)
    # the same 4096 coded blobs in one launch (set a), then the synthetic
    # batch (set b)
    dev = torch.device(DEVICE)
    decode_timing(np, torch, D, dev, results, card, [b for _, b in coded[:4096]],
                  [p for p, _ in coded[:4096]], "")
    decode_timing(np, torch, D, dev, results, card, *synthetic_decode(np, E), "synthetic_")
    del flushes, pairs, payloads, blobs, back, coded
    t0 = time.perf_counter()
    with AGCFile(out) as agc:
        for sname, contigs in wseqs.items():
            for cname, seq in zip(names, contigs):
                check(agc.GetCtgSeq(sname, cname).encode("latin-1") == alpha[seq].tobytes(),
                      f"{cname}@{sname} does not extract byte-equal from the tpu-rans archive")
    print(f"tpu-rans extract: {len(wseqs)} samples x {len(names)} contigs byte-equal "
          f"({time.perf_counter() - t0:.1f} s)")

    # chr scale: the card's coder and the host coder give equal archives
    params = CompressorParams(profile="tpu-rans")
    a, b = os.path.join(tmp, "rans_card.agc"), os.path.join(tmp, "rans_host.agc")
    t0 = time.perf_counter()
    create_archive(a, files4, params, device=DEVICE)
    t_card = time.perf_counter() - t0
    del os.environ["AGC_TPU_RANS_DEVICE"]
    t0 = time.perf_counter()
    create_archive(b, files4, params, device=DEVICE)
    t_host = time.perf_counter() - t0
    equal = same_archive(ArchiveReader, a, b)
    print(f"tpu-rans at chr scale: card coder {t_card:.2f} s, host coder {t_host:.2f} s; "
          f"archives equal part for part: {equal} ({card})")
    check(equal, "the card's and the host's coders give different chr-scale archives")

    # collection scale: create, then append, on the card and on the CPU
    os.environ["AGC_TPU_RANS_DEVICE"] = "1"
    try:
        for label, base, inputs in (("create", None, cfiles[:2]),
                                    ("append", ("rans_cc.agc", "rans_cpu_c.agc"), cfiles[2:])):
            a = os.path.join(tmp, f"rans_c{label[0]}.agc")
            b = os.path.join(tmp, f"rans_cpu_{label[0]}.agc")
            on_cpu = cpu_create(b, inputs, params,
                                base=None if base is None else os.path.join(tmp, base[1]))
            t0 = time.perf_counter()
            if base is None:
                create_archive(a, inputs, params, device=DEVICE)
            else:
                append_archive(os.path.join(tmp, base[0]), a, inputs, params, device=DEVICE)
            t_card = time.perf_counter() - t0
            t_cpu = cpu_done(on_cpu)
            equal = same_archive(ArchiveReader, a, b)
            print(f"tpu-rans collection {label} ({len(inputs)} files): card {t_card:.2f} s, "
                  f"CPU (plain versions) {t_cpu:.2f} s; archives equal part for part: {equal} "
                  f"({card})")
            check(equal, f"the card's and the CPU's tpu-rans {label} archives differ")
    finally:
        os.environ.pop("AGC_TPU_RANS_DEVICE", None)


# Phase 11: the sharded, mesh and distributed creates (agc_tpu_torch/
# parallel/) on the card. Each path's launches are counted from 0 just
# before it; the torchdist runs of other processes are checked by their
# archives.
_TORCHDIST_CPU = (
    "import json, sys\n"
    "from agc_tpu_torch.core.compressor import CompressorParams\n"
    "from agc_tpu_torch.parallel.torchdist import create_archive_torchdist\n"
    "a = json.loads(sys.argv[1])\n"
    "create_archive_torchdist(a['out'], a['files'], CompressorParams(), n_procs=a['n'], "
    "device='cpu', timeout_s=900)\n"
)


def fasta_body(path: str) -> bytes:
    """The bases of a one-contig FASTA file."""
    with open(path, "rb") as f:
        return b"".join(line.rstrip(b"\n") for line in f if not line.startswith(b">"))


def splitters_of(reader_cls, path: str) -> bytes:
    reader = reader_cls(path)
    try:
        return reader.get_part("splitters", 0)[0]
    finally:
        reader.close()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launched(ck, names, label: str) -> dict:
    """The launch counts of the path just driven; fails when one of
    ``names`` was never launched."""
    counts = dict(ck.LAUNCHES)
    for name in names:
        check(counts[name] > 0, f"{label} never launched {name}")
    return {k: v for k, v in counts.items() if v}


def parallel_phase(np, torch, ck, u64, CompressorParams, create_archive, ArchiveReader, AGCFile,
                   results, programs, card, tmp, ref4, files4, cfiles, wfiles, names, wseqs,
                   w_size: int, w_wall: float, stamp) -> None:
    """Phase 11: the sharded, mesh and distributed creates on the card. See
    the module docstring."""
    import contextlib
    import io

    import torch.distributed as dist

    from agc_tpu_torch.parallel import sharding as ts
    from agc_tpu_torch.parallel import torchdist as td
    from agc_tpu_torch.parallel.distributed import create_archive_sharded

    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    dev = torch.device(DEVICE)

    # (a) thread shards at full width: phase 7's input, 2 shards
    sh_out = os.path.join(tmp, "sharded.agc")
    wtotal = sum(len(c) for cs in wseqs.values() for c in cs)
    os.environ["AGC_TPU_SHARD_TIMINGS"] = "1"
    captured = io.StringIO()
    ck.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(captured):
            create_archive_sharded(sh_out, wfiles, CompressorParams(), n_shards=2,
                                   worker="thread", device=DEVICE)
        torch.cuda.synchronize()
    finally:
        del os.environ["AGC_TPU_SHARD_TIMINGS"]
        sys.stderr.write(captured.getvalue())
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    la = launched(ck, ("kmer_canon", "walk_index", "greedy_walk", "member_mix", "dir_mix"),
                  "the thread-sharded whole-genome create")
    split = [json.loads(line.split(" ", 1)[1]) for line in captured.getvalue().splitlines()
             if line.startswith("AGC_TPU_SHARD_TIMINGS ")]
    check(len(split) == 1, "the sharded create printed no AGC_TPU_SHARD_TIMINGS line")
    size = os.path.getsize(sh_out)
    print(f"thread-sharded whole-genome create (2 shards): {wtotal} bases in {wall:.4f} s = "
          f"{wtotal / wall / 1e6:.2f} Mbases/s ({card}); phase 7's create {w_wall:.4f} s; "
          f"boot / shards / merge: {json.dumps(split[0])}; peak device memory {peak} bytes; "
          f"archive {size} bytes against phase 7's {w_size} ({size / w_size:.5f}); launches {la}")
    check(size <= w_size * 1.02, "the 2-shard archive is over 2% larger than phase 7's")
    for name in ("kmer_canon", "member_mix", "dir_mix"):
        results[name]["sharded_launches"] = la[name]
    t0 = time.perf_counter()
    with AGCFile(sh_out) as agc:
        for sname, contigs in wseqs.items():
            for cname, seq in zip(names, contigs):
                check(agc.GetCtgSeq(sname, cname).encode("latin-1") == alpha[seq].tobytes(),
                      f"{cname}@{sname} of the sharded archive does not extract byte-equal")
    print(f"thread-sharded extract: {len(wseqs)} samples x {len(names)} contigs byte-equal "
          f"({time.perf_counter() - t0:.1f} s)")
    os.unlink(sh_out)
    stamp("11a")

    # (b) process shards, each spawned worker opening the card, against
    # thread shards on phase 4's input
    thr4, proc4 = os.path.join(tmp, "thr4.agc"), os.path.join(tmp, "proc4.agc")
    total4 = sum(os.path.getsize(f) for f in files4)
    walls = {}
    for label, out, worker in (("thread", thr4, "thread"), ("process", proc4, "process")):
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        create_archive_sharded(out, files4, CompressorParams(), n_shards=2, worker=worker,
                               device=DEVICE)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        # the process shards' scans run in the workers: here only the
        # boot's discovery and the inventory pass over the reference
        lb = launched(ck, ("kmer_canon", "scan_fused"), f"the {label}-sharded create")
        print(f"{label}-sharded create of phase 4's input (2 shards): {walls[label]:.4f} s "
              f"({card}); launches in this process {lb}")
    equal = same_archive(ArchiveReader, thr4, proc4)
    print(f"process shards against thread shards: archives equal part for part: {equal}")
    check(equal, "the process-sharded archive differs from the thread-sharded one")
    stamp("11b")

    # (c) the mesh create over the card's one-device mesh, against phase
    # 4's plain create; its first 16 kmer_dir_rc calls kept and held
    # against the plain version after the run
    plain4, mesh4 = os.path.join(tmp, "plain4.agc"), os.path.join(tmp, "mesh4.agc")
    create_archive(plain4, files4, CompressorParams(), device=DEVICE)
    kept = []
    real = ts.kmer_dir_rc

    def keeping(packed, k, index=None):
        out = real(packed, k, index)
        if len(kept) < 16:
            kept.append(((packed, k, index), out))
        return out

    ts.kmer_dir_rc = keeping
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ts.mesh_create_archive(mesh4, files4, CompressorParams(), mesh=ts.make_mesh(),
                               device=DEVICE)
        torch.cuda.synchronize()
    finally:
        ts.kmer_dir_rc = real
    mwall = time.perf_counter() - t0
    lc = launched(ck, ("kmer_canon", "kmer_dir_rc", "set_table"), "the mesh create")
    equal = same_archive(ArchiveReader, mesh4, plain4)
    print(f"mesh create of phase 4's input over {ts.make_mesh()}: {mwall:.4f} s ({card}); "
          f"launches {lc}; archive equal to the plain create's part for part: {equal}")
    check(equal, "the mesh archive differs from the plain create's")
    err = 0
    for args, got in kept:
        want = ck.kmer_dir_rc_plain(*args)
        err = max(err, max(max_abs_err(torch, a, b) for a, b in zip(got, want)))
    print(f"mesh kmer_dir_rc: {len(kept)} kept calls at {[tuple(a[0].shape) for a, _ in kept]} "
          f"(packed rows) against kmer_dir_rc_plain on the card: max_abs_err {err}")
    check(err == 0 and kept, f"the mesh's kmer_dir_rc disagrees with its plain version ({err})")
    (packed, k, index), _out = kept[0]
    n_set = index.values.numel()
    walk_bytes = 8 * n_set + 4 * ((1 << ck.index_bits(n_set)) + 1)
    r = results["kmer_dir_rc"]
    r["mesh_launches"] = lc["kmer_dir_rc"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["mesh_ms"] = cuda_ms(torch, lambda: ck.kmer_dir_rc(packed, k, index), 10)
    r["mesh_plain_ms"] = cuda_ms(torch, lambda: ck.kmer_dir_rc_plain(packed, k, index), 2)
    r["mesh_bound_ms"] = dir_rc_bound(packed.numel(), walk_bytes)[0]
    print(f"kmer_dir_rc at the mesh's row shape {tuple(packed.shape)} with the {n_set}-splitter "
          f"set: {r['mesh_ms']:.4f} ms, plain {r['mesh_plain_ms']:.4f} ms, bound "
          f"{r['mesh_bound_ms']:.4f} ms ({card})")
    del kept, packed, index, _out
    torch.cuda.empty_cache()
    stamp("11c")

    # (d) torchdist. Two processes sharing the card (gloo) on phase 4's
    # input: the splitters of phase 4's single create, every sample
    # byte-equal, the archive equal to the thread shards' of (b)
    # phase 6's CPU run (two gloo processes of their own, compared below)
    # starts first, beside the card's runs (the run's time limit)
    cpu6, nccl6, gloo6 = (os.path.join(tmp, f"{n}6.agc") for n in ("cpu", "nccl", "gloo"))
    proc = subprocess.Popen([sys.executable, "-c", _TORCHDIST_CPU,
                             json.dumps(dict(out=cpu6, files=cfiles, n=2))],
                            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    CHILDREN.append(proc)
    on_cpu = (proc, time.perf_counter())
    td4 = os.path.join(tmp, "td4.agc")
    t0 = time.perf_counter()
    td.create_archive_torchdist(td4, files4, CompressorParams(), n_procs=2, device=DEVICE,
                                timeout_s=900)
    twall = time.perf_counter() - t0
    same_split = splitters_of(ArchiveReader, td4) == splitters_of(ArchiveReader, plain4)
    equal = same_archive(ArchiveReader, td4, thr4)
    print(f"torchdist create of phase 4's input, 2 processes on one card (gloo), beside the "
          f"CPU run: {twall:.4f} s ({card}); splitters equal to the single create's: {same_split}; archive equal to "
          f"the thread shards': {equal}")
    check(same_split, "torchdist's splitters differ from the single create's")
    check(equal, "torchdist's archive differs from the thread shards'")
    with AGCFile(td4) as agc:
        for path in files4:
            sname = os.path.splitext(os.path.basename(path))[0]
            check(agc.GetCtgSeq(sname, "chr1").encode("latin-1") == fasta_body(path),
                  f"sample {sname} of the torchdist archive does not extract byte-equal")
    print(f"torchdist extract: {len(files4)} samples byte-equal")
    for path in (thr4, proc4, plain4, mesh4, td4):
        os.unlink(path)

    # phase 6's 12-contig collection: one process over NCCL (in this
    # process: a world of one), two over gloo, against the CPU run
    check(td.choose_backend(1, DEVICE) == "nccl", "one process on the card did not choose NCCL")
    ck.reset_launches()
    t0 = time.perf_counter()
    td.run_worker(0, 1, f"127.0.0.1:{free_port()}", nccl6, cfiles, CompressorParams(),
                  device=DEVICE, backend="nccl", timeout_s=900)
    torch.cuda.synchronize()
    nwall = time.perf_counter() - t0
    ld = launched(ck, ("kmer_canon", "kmer_dir_rc", "set_table", "scan_fused"),
                  "the NCCL torchdist create")
    results["kmer_dir_rc"]["torchdist_launches"] = ld["kmer_dir_rc"]
    t0 = time.perf_counter()
    td.create_archive_torchdist(gloo6, cfiles, CompressorParams(), n_procs=2, device=DEVICE,
                                timeout_s=900)
    gwall = time.perf_counter() - t0
    t_cpu = cpu_done(on_cpu)
    eq_n, eq_g = same_archive(ArchiveReader, nccl6, cpu6), same_archive(ArchiveReader, gloo6, cpu6)
    print(f"torchdist on phase 6's collection: NCCL, 1 process {nwall:.4f} s (launches {ld}); "
          f"gloo, 2 processes on the card {gwall:.4f} s; CPU, 2 processes {t_cpu:.2f} s; "
          f"archives equal to the CPU's part for part: NCCL {eq_n}, gloo {eq_g} ({card})")
    check(eq_n and eq_g, "torchdist's card archives differ from the CPU's")

    # the exchange-and-reduce at phase 4's pool (the reference's canonical
    # k-mers) in a world of one over NCCL, torch.sort of the pool beside it
    from agc_tpu_torch.ops import kmers as tk

    pool = tk.collect_kmers(ref4, 31, dev)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        g = td._Group(0, 1, dev, dev)
        m = td._pow2(pool.numel())
        singles, dups = td._exchange_and_reduce_owned(g, [pool], m=m)
        want = tk.candidate_tables(tk.sort_kmers(pool))
        check(torch.equal(singles, want[0]) and torch.equal(dups, want[1]),
              "the exchange-and-reduce disagrees with candidate_tables on the card")
        ms = cuda_ms(torch, lambda: td._exchange_and_reduce_owned(g, [pool], m=m), 5)
        sort_ms = cuda_ms(torch, lambda: torch.sort(pool), 5)
    finally:
        dist.destroy_process_group()
    # the pool read once, the padded block exchanged (read and written),
    # the two tables written
    xbound = bound(8 * pool.numel() + 16 * m + 8 * (singles.numel() + dups.numel()), 0)
    programs["exchange_and_reduce"] = dict(
        ms=ms, bound_ms=xbound[0], bound_by=xbound[1], library_ms=sort_ms,
        replaces="agc_tpu/parallel/jaxdist.py:149-222", shape=f"pool {pool.numel()}, m {m}")
    print(f"exchange-and-reduce, world of one over NCCL, phase 4's pool of {pool.numel()} "
          f"k-mers (m {m}): {ms:.4f} ms, torch.sort of the pool {sort_ms:.4f} ms, bound "
          f"{xbound[0]:.4f} ms ({xbound[1]}); {singles.numel()} singletons, {dups.numel()} "
          f"duplicated ({card})")
    del pool, singles, dups, want
    torch.cuda.empty_cache()


def main() -> int:
    started = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from agc_tpu_torch import AGCFile
    from agc_tpu_torch.core import ArchiveReader
    from agc_tpu_torch.core import compressor as cmod
    from agc_tpu_torch.core import entropy as E
    from agc_tpu_torch.core.compressor import (Compressor, CompressorParams, append_archive,
                                               create_archive)
    from agc_tpu_torch.core.lz import LZDiff
    from agc_tpu_torch.ops import _build
    from agc_tpu_torch.ops import cuda_kmers as ck
    from agc_tpu_torch.ops import cuda_match as cm
    from agc_tpu_torch.ops import device_rans as D
    from agc_tpu_torch.ops import match as M
    from agc_tpu_torch.ops import kmers as tk
    from agc_tpu_torch.ops import u64

    # -- 1. environment ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
          f"count {torch.cuda.device_count()}")
    print(card)
    dev = torch.device(DEVICE)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip())

    results = {}

    def stamp(phase: str) -> None:
        print(f"phase {phase} done at {time.perf_counter() - started:.1f} s", flush=True)

    stamp("1-2")
    if sys.argv[1:] == ["--rans-only"]:
        rans_only(np, torch, D, E, dev, card)
        print(f"chip_smoke.py --rans-only: {time.perf_counter() - started:.1f} s")
        return 0

    # -- 3. kernels against their plain versions ---------------------------
    n_scan = N_SCAN
    rows = scan_rows(np, 8, n_scan, SEED)
    packed = torch.from_numpy(np.stack([tk.pack4_np(r) for r in rows])).to(dev)
    n_pos = packed.numel() * 2
    err = 0
    scan_ms = plain_ms = None
    for k in (17, 21, 31, 32):
        ud, ur, v = tk.dir_rc_kmers_np(rows[0, :400_000], k)
        canon = np.unique(np.minimum(ud, ur)[v])
        for n_splitters in (40, 8192):
            pick = np.sort(canon[:: max(1, len(canon) // n_splitters)][:n_splitters])
            table = tk.make_scan_table(pick, k, dev)
            t_size = table.tmix.numel()
            caps = (tk._SCAN_CAP, 16) if n_splitters == 8192 else (tk._SCAN_CAP,)
            for cap in caps:
                a = ck.scan_fused(packed, k, table.tmix, cap)
                b = ck.scan_fused_plain(packed, k, table.tmix, cap)
                torch.cuda.synchronize()
                e = max_abs_err(torch, a, b)
                counts = a[:, 0].tolist()
                print(f"scan_fused k={k} table={t_size} cap={cap}: counts {counts} "
                      f"max_abs_err {e}")
                err = max(err, e)
                if cap == 16:
                    check(max(counts) > cap, "the forced cap overflow did not overflow")
            if k == 31 and n_splitters == 8192:
                scan_table = table
                scan_ms = cuda_ms(torch, lambda: ck.scan_fused(packed, k, table.tmix, tk._SCAN_CAP), 20)
                plain_ms = cuda_ms(torch, lambda: ck.scan_fused_plain(packed, k, table.tmix, tk._SCAN_CAP), 3)
                # what the function needs a position: the ladder, the
                # XOR-mix and one equality test (a constant-probe lookup)
                scan_bound = bound(
                    packed.numel() + 4 * t_size + 4 * packed.shape[0] * (1 + 3 * tk._SCAN_CAP),
                    n_pos * (LADDER_OPS + 2),
                )
    check(err == 0, f"scan_fused disagrees with its plain version (max_abs_err {err})")
    err = max(err, scan_fused_hard(np, torch, ck, tk, dev, np.random.default_rng(SEED + 5),
                                   _build.lib().agc_scan_fused_tile()))
    results["scan_fused"] = dict(
        source="agc_tpu_torch/csrc/scan_fused.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:232",
        max_abs_err=err, ms=scan_ms, plain_ms=plain_ms, library_ms=None,
        bound=scan_bound,
        shape=f"8 x {n_scan} symbols, k=31, 16384-entry table, cap {tk._SCAN_CAP}",
    )

    # dir_mix: the halves the join reads, on the join's rows (8 x 4 Mi)
    k = 31
    dlo, dhi, valid = ck.dir_mix(packed, k)
    want = ck.dir_mix_plain(packed, k)
    e = max(max_abs_err(torch, x, y) for x, y in zip((dlo, dhi, valid), want))
    check(e == 0, f"dir_mix disagrees with its plain version (max_abs_err {e})")
    del want
    results["dir_mix"] = dict(
        source="agc_tpu_torch/csrc/dir_mix.cu",
        replaces="agc_tpu/ops/kmers.py:58",
        max_abs_err=e,
        ms=cuda_ms(torch, lambda: ck.dir_mix(packed, k), 20),
        plain_ms=cuda_ms(torch, lambda: ck.dir_mix_plain(packed, k), 3),
        library_ms=None,
        bound=bound(packed.numel() + 9 * n_pos, LADDER_OPS * n_pos),
        shape=f"8 x {n_scan} symbols, k=31",
    )
    print(f"dir_mix k=31 8 x {n_scan}: {int(valid.sum())} valid windows, max_abs_err {e}")

    # the filter's pass rate on the main path's mixes: scan_fused's valid
    # positions against its 16384-entry table (8 x 4 Mi symbols, k=31)
    mix = (dlo ^ dhi).reshape(-1)
    live = mix[valid.reshape(-1)]
    passing = ck.mix_filter_pass(ck.mix_set_built(scan_table.tmix)[0], live)
    members = ck.member_mix_plain(live, scan_table.tmix)
    print(f"MixSet on scan_fused's {live.numel()} valid windows (T={scan_table.tmix.numel()}): "
          f"pass rate {float(passing.float().mean()):.6f}, false passes "
          f"{float((passing & ~members).float().mean()):.6f}")
    del dlo, dhi, valid, live, passing, members

    # member_mix on the join's mixes (N = 8 x 4 Mi): the whole-genome
    # path's 32768-entry table and a whole human assembly's 131072 entries
    ud, ur, v = tk.dir_rc_kmers_np(rows[0, :1_000_000], k)
    canon = np.unique(np.minimum(ud, ur)[v])
    join = {}
    for n_split in (12_000, 40_000):
        pick = np.sort(canon[:: len(canon) // n_split][:n_split])
        tbl = tk.make_scan_table(pick, k, dev).tmix
        join[f"join T={tbl.numel()}"] = u64.to_u32(tbl)
    mm_err = member_mix_hard(np, torch, ck, u64, dev, np.random.default_rng(SEED + 6),
                             mix_tables(np, np.random.default_rng(SEED + 7), join), mix)
    mm = {}
    for tn in join.values():
        tbl = u64.from_u32(tn, dev)
        t_size = tbl.numel()
        want = ck.member_mix_plain(mix, tbl)
        e = max(max_abs_err(torch, ck.member_mix(mix, tbl), want),
                max_abs_err(torch, torch.isin(mix, tbl), want))  # the library agrees
        check(e == 0, f"member_mix disagrees with its plain version (table {t_size}, "
                      f"max_abs_err {e})")
        passing = ck.mix_filter_pass(ck.mix_set_built(tbl)[0], mix)
        print(f"MixSet on the join's {mix.numel()} mixes (T={t_size}, {tbl.unique().numel()} "
              f"distinct): pass rate {float(passing.float().mean()):.6f}, false passes "
              f"{float((passing & ~want).float().mean()):.6f}")
        del passing
        mm[t_size] = dict(
            max_abs_err=max(e, mm_err),
            ms=cuda_ms(torch, lambda: ck.member_mix(mix, tbl), 20),
            plain_ms=cuda_ms(torch, lambda: ck.member_mix_plain(mix, tbl), 3),
            library_ms=cuda_ms(torch, lambda: torch.isin(mix, tbl), 3),
            # 4 bytes in and 1 out a mix; one equality test a mix (a
            # constant-probe lookup needs no more)
            bound=bound(5 * mix.numel() + 4 * t_size, mix.numel()),
        )
        print(f"member_mix N={mix.numel()} table={t_size}: "
              f"{int(want.sum())} members, max_abs_err {e}; kernel {mm[t_size]['ms']:.4f} ms, "
              f"plain {mm[t_size]['plain_ms']:.4f} ms, torch.isin "
              f"{mm[t_size]['library_ms']:.4f} ms, bound {mm[t_size]['bound'][0]:.4f} ms ({card})")
    check(sorted(mm) == [32768, 131072], f"member_mix tables {sorted(mm)}")
    # the device time of each kernel a call launches (the MixSet build
    # apart from the kernel that uses it), 10 calls under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    t32, t128 = (u64.from_u32(join[f"join T={t}"], dev) for t in (32768, 131072))
    for label, call in (
        ("member_mix, T=32768", lambda: ck.member_mix(mix, t32)),
        ("member_mix, T=131072", lambda: ck.member_mix(mix, t128)),
        ("scan_fused, 8 x 4 Mi, T=16384",
         lambda: ck.scan_fused(packed, 31, scan_table.tmix, tk._SCAN_CAP)),
    ):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        by_kernel = device_time(torch, prof)[1]
        print(f"{label}, per call: " + "; ".join(
            f"{kernel_name(name)} {ms / 10:.4f} ms"
            for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])) + f" ({card})")
    results["member_mix"] = dict(
        source="agc_tpu_torch/csrc/member_mix.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:333",
        **mm[32768],
        large_table_ms=mm[131072]["ms"],
        shape=f"{mix.numel()} mixes, 32768-entry table",
    )
    del mix, t32, t128

    # the large-table join: dir_mix + member_mix on the card against the
    # plain versions on the CPU, tolerance 0
    ud, ur, v = tk.dir_rc_kmers_np(rows[0, :400_000], 31)
    canon = np.unique(np.minimum(ud, ur)[v])
    pick = canon[:: max(1, len(canon) // 9000)]  # > 8192 splitters: a join table
    jt_dev, jt_cpu = tk.make_scan_table(pick, 31, dev), tk.make_scan_table(pick, 31, "cpu")
    check(jt_dev.kind == "join", "the join table is not a join table")
    jcap = tk._cap_total_for(2, n_scan)
    j_dev = tk.scan_batch_join_global_p4(packed[:2], 31, jt_dev.tmix, jcap)
    j_cpu = tk.scan_batch_join_global_p4(packed[:2].cpu(), 31, jt_cpu.tmix, jcap)
    e = max_abs_err(torch, j_dev.cpu(), j_cpu)
    print(f"join scan table={jt_dev.tmix.numel()}: count {int(j_dev[0])}, "
          f"card (kernels) vs CPU (plain) max_abs_err {e}")
    check(e == 0, "the join scan differs between the card and the CPU")
    del packed

    rng = np.random.default_rng(SEED)
    ref = structured_ref(np, rng, REF_MB << 20)
    k = 31
    # kmer_canon's hard cases: k = 1, 17, 31 and 32 on seam-packed rows
    # whose length is no multiple of a tile, invalid symbols on the tile
    # boundaries; then the main path's shape, one 64 Mi-symbol contig
    hrng = np.random.default_rng(SEED + 3)
    hard = torch.from_numpy(
        np.stack([tk.pack4_np(r) for r in seam_rows(np, hrng, tk._SEAM)])).to(dev)
    kc_err = 0
    for hk in (1, 17, 31, 32):
        e = max_abs_err(torch, ck.kmer_canon(hard, hk), ck.kmer_canon_plain(hard, hk))
        print(f"kmer_canon hard case k={hk}, {hard.shape[0]} seam-packed rows x "
              f"{2 * hard.shape[1]} symbols: max_abs_err {e}")
        check(e == 0, f"kmer_canon disagrees with its plain version at k={hk} ({e})")
        kc_err = max(kc_err, e)
    dr_err, st_err = dir_rc_hard(np, torch, ck, u64, hard)
    del hard
    cpacked = torch.from_numpy(tk.pack4_np(ref)[None, :]).to(dev)
    canon = ck.kmer_canon(cpacked, k)
    e = max_abs_err(torch, canon, ck.kmer_canon_plain(cpacked, k))
    check(e == 0, f"kmer_canon disagrees with its plain version (max_abs_err {e})")
    results["kmer_canon"] = dict(
        source="agc_tpu_torch/csrc/kmer_canon.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:106",
        max_abs_err=max(kc_err, e),
        ms=cuda_ms(torch, lambda: ck.kmer_canon(cpacked, k), 10),
        plain_ms=cuda_ms(torch, lambda: ck.kmer_canon_plain(cpacked, k), 2),
        library_ms=None,
        bound=canon_bound(cpacked.numel()),
        shape=f"1 contig x {len(ref)} symbols, k=31",
    )
    print(f"kmer_canon k=31 n={len(ref)}: max_abs_err {e}")

    # greedy_walk's hard cases, tolerance 0
    walk_err = 0
    for name, hcanon, contigs, hpool, hseg, hcap in walk_cases(np, SEED + 4):
        args = (torch.from_numpy(hcanon).to(dev),
                torch.tensor([s for s, _ in contigs], dtype=torch.int64, device=dev),
                torch.tensor([n for _, n in contigs], dtype=torch.int64, device=dev),
                torch.from_numpy(hpool).to(dev), hseg, hcap)
        g = ck.greedy_walk(*args)
        e = max_abs_err(torch, g, ck.greedy_walk_plain(*args))
        counts, tails = g[:, 0].tolist(), g[:, 1 + 2 * hcap].tolist()
        print(f"greedy_walk hard case '{name}': seg {hseg}, cap {hcap}, emissions {counts}, "
              f"tail found {[t != SENTINEL for t in tails]}, max_abs_err {e}")
        check(e == 0, f"greedy_walk disagrees with its plain version on '{name}' ({e})")
        e = index_err(torch, ck.walk_index(args[3]), ck.walk_index_plain(args[3]))
        check(e == 0, f"walk_index disagrees with its plain version on '{name}' ({e})")
        if name == "no singleton":
            check(counts == [0] and tails == [SENTINEL], "the no-singleton case found a hit")
        if name.startswith("cap"):
            check(counts == [hcap], f"'{name}' did not stop at its cap")
        walk_err = max(walk_err, e)

    flat = canon[0].contiguous()
    pool = tk.sort_kmers(flat)
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    reals = torch.full((1,), len(ref), dtype=torch.int64, device=dev)
    seg = max(CompressorParams().segment_size, k)
    cap = len(ref) // seg + 2
    # the walk's index of the pool's singletons, then the walk over it,
    # timed apart
    idx = ck.walk_index(pool)
    e = index_err(torch, idx, ck.walk_index_plain(pool))
    check(e == 0, f"walk_index disagrees with its plain version (max_abs_err {e})")
    results["walk_index"] = dict(
        source="agc_tpu_torch/csrc/greedy_walk.cu",
        replaces="agc_tpu/ops/kmers.py:599",
        max_abs_err=e,
        ms=cuda_ms(torch, lambda: ck.walk_index(pool), 10),
        plain_ms=cuda_ms(torch, lambda: ck.walk_index_plain(pool), 2),
        library_ms=None,
        bound=index_bound(pool.numel(), *idx),
        shape=f"pool {pool.numel()}: {idx[0].numel()} singletons, {idx[1].numel()} "
              "directory entries",
    )
    # kmer_dir_rc at 1 x 64 Mi symbols, k=31: without a set (the segment
    # scans of -f) and with the pool's singletons (-f discovery's dense
    # scan against the singleton table), through that set's table
    singles = idx[0]
    sti = ck.set_table(singles)
    et = set_table_err(torch, ck, sti, ck.set_table_plain(singles))
    check(et == 0, f"set_table disagrees with its plain version at the 64 Mi set ({et})")
    e = max(max_abs_err(torch, x, y) for x, y in zip(ck.kmer_dir_rc(cpacked, k)[:3],
                                                     ck.kmer_dir_rc_plain(cpacked, k)[:3]))
    em = max_abs_err(torch, ck.kmer_dir_rc(cpacked, k, sti)[3],
                     ck.kmer_dir_rc_plain(cpacked, k, sti)[3])
    check(e == 0 and em == 0, f"kmer_dir_rc disagrees with its plain version ({e}, {em})")
    n_valid = int(ck.kmer_dir_rc(cpacked, k)[2].sum())
    walk_bytes = 8 * singles.numel() + 4 * idx[1].numel()
    results["kmer_dir_rc"] = dict(
        source="agc_tpu_torch/csrc/kmer_canon.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:137",
        max_abs_err=max(dr_err, e, em),
        ms=cuda_ms(torch, lambda: ck.kmer_dir_rc(cpacked, k), 10),
        plain_ms=cuda_ms(torch, lambda: ck.kmer_dir_rc_plain(cpacked, k), 2),
        library_ms=None,
        bound=dir_rc_bound(cpacked.numel()),
        member_ms=cuda_ms(torch, lambda: ck.kmer_dir_rc(cpacked, k, sti), 10),
        member_plain_ms=cuda_ms(torch, lambda: ck.kmer_dir_rc_plain(cpacked, k, sti), 2),
        # the set counted as a walk index: 8 bytes a value, 4 a directory
        # entry (PR 9's yardstick; the table's own bytes do not raise it)
        member_bound_ms=dir_rc_bound(cpacked.numel(), walk_bytes)[0],
        # the lookup stage's yardstick: isin_sorted on the same codes
        member_library_ms=cuda_ms(torch, lambda: ck.isin_sorted(flat, singles), 3),
        # PR 8's count: two 32-byte sectors a lookup of a valid position
        member_bound_pr8_count_ms=bound(37 * cpacked.numel() + 64 * n_valid,
                                        40 * cpacked.numel())[0],
        member_table_bytes=sti.nbytes,
        member_walk_index_bytes=walk_bytes,
        member_spill_share=sti.n_spilled / max(1, singles.numel()),
        shape=f"1 contig x {len(ref)} symbols, k=31; with a set: the {singles.numel()} "
              "singletons of its pool",
    )
    r = results["kmer_dir_rc"]
    results["set_table"] = dict(
        source="agc_tpu_torch/csrc/kmer_canon.cu",
        replaces="agc_tpu/ops/kmers.py:258",
        max_abs_err=max(st_err, et),
        ms=cuda_ms(torch, lambda: ck.set_table(singles), 5),
        plain_ms=cuda_ms(torch, lambda: ck.set_table_plain(singles), 1),
        library_ms=None,
        # the set read once, the table (buckets and overflow) written once
        bound=bound(8 * singles.numel() + sti.nbytes, 0),
        table_bytes=sti.nbytes,
        spill_share=r["member_spill_share"],
        shape=f"the {singles.numel()} singletons of the 64 Mi pool: 2^{sti.first.bits} + "
              f"2^{sti.second.bits} buckets, {sti.n_spilled} spilled, {sti.tail.numel()} to the "
              "tail",
    )
    print(f"kmer_dir_rc k=31 n={len(ref)}: max_abs_err {r['max_abs_err']}; {r['ms']:.4f} ms "
          f"(bound {r['bound'][0]:.4f}), with {singles.numel()} singletons "
          f"{r['member_ms']:.4f} ms (bound {r['member_bound_ms']:.4f}, "
          f"{100 * r['member_bound_ms'] / r['member_ms']:.1f}% of it; lookups "
          f"{r['member_ms'] - r['ms']:.4f} ms against isin_sorted's "
          f"{r['member_library_ms']:.4f} ms); set_table {results['set_table']['ms']:.4f} ms "
          f"(bound {results['set_table']['bound'][0]:.4f}), 2^{sti.first.bits} + "
          f"2^{sti.second.bits} buckets, {sti.nbytes} table bytes against the walk index's "
          f"{walk_bytes}, {sti.n_spilled} values spilled ({100 * r['member_spill_share']:.3f}% "
          f"of the set), {sti.tail.numel()} to the tail ({card})")
    split = rans_split(torch, {
        "set_table": (lambda: ck.set_table(singles), SET_KERNELS),
        "kmer_dir_rc with the set": (lambda: ck.kmer_dir_rc(cpacked, k, sti),
                                     ("kmer_dir_rc_kernel",))})
    sk = split["set_table"]
    results["set_table"]["kernel_ms"] = sk and sum(sk[n] for n in SET_KERNELS)
    print("set_table and kmer_dir_rc with the set split by torch.profiler (device ms a call): "
          + json.dumps(split) + f" ({card})")
    # what holds the lookups: the card's random-read rate, torch.take of an
    # int64 a position from 16 MB (in L2) and from a table of the set
    # table's bytes; and the lookups with the spill path cut (the second
    # table and the tail emptied), what the spill costs them
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    take = {}
    for nbytes in (16 << 20, sti.nbytes):
        table = torch.zeros(nbytes // 8, dtype=torch.int64, device=dev)
        at = torch.randint(0, table.numel(), (len(ref),), device=dev, generator=gen)
        take[nbytes] = cuda_ms(torch, lambda: torch.take(table, at), 5)
        del table, at
    cut = ck.SetTable(sti.first, ck.set_table(singles[:0]).second, sti.tail[:0], singles)
    r["member_spill_cut_ms"] = cuda_ms(torch, lambda: ck.kmer_dir_rc(cpacked, k, cut), 5)
    # -f discovery builds a set and scans the reference once: build + scan
    r["member_build_and_scan_ms"] = results["set_table"]["ms"] + r["member_ms"]
    print(f"random reads: torch.take of {len(ref)} int64 "
          + ", ".join(f"from {b} bytes {ms:.4f} ms ({len(ref) / ms / 1e6:.2f} G a second)"
                      for b, ms in take.items())
          + f"; kmer_dir_rc with the spill path cut {r['member_spill_cut_ms']:.4f} ms; "
          f"set_table + one scan {r['member_build_and_scan_ms']:.4f} ms ({card})")
    del sti, cut
    # set_table's peak device memory at the set a pool of _POOL_CARD_MAX
    # positions would give (phase 3's singleton share of it): sorted
    # distinct values made on the card, the set itself not counted
    n_big = int(len(singles) / len(ref) * cmod.Compressor._POOL_CARD_MAX)
    big = torch.randint(1, 1 << 33, (n_big,), device=dev, generator=gen).cumsum_(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stb = ck.set_table(big)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    results["set_table"].update(card_max_values=n_big, card_max_table_bytes=stb.nbytes,
                                card_max_peak_bytes=peak, card_max_build_s=big_s)
    print(f"set_table at _POOL_CARD_MAX's set ({n_big} values, {8 * n_big} bytes): "
          f"{stb.nbytes} table bytes, peak device memory of the build {peak} bytes beside the "
          f"set, {big_s:.4f} s ({card})")
    del stb, big
    torch.cuda.empty_cache()
    g = ck.greedy_walk(flat, starts, reals, pool, seg, cap, index=idx)
    gp = ck.greedy_walk_plain(flat, starts, reals, pool, seg, cap)
    e = max_abs_err(torch, g, gp)
    check(e == 0, f"greedy_walk disagrees with its plain version (max_abs_err {e})")
    check(int(g[0, 0]) > 100, f"greedy_walk emitted only {int(g[0, 0])} splitters")
    probes = walk_positions(g[0].tolist(), len(ref), seg, cap)
    results["greedy_walk"] = dict(
        source="agc_tpu_torch/csrc/greedy_walk.cu",
        replaces="agc_tpu/ops/kmers.py:599",
        max_abs_err=max(walk_err, e),
        ms=cuda_ms(torch, lambda: ck.greedy_walk(flat, starts, reals, pool, seg, cap, index=idx), 5),
        plain_ms=cuda_ms(torch, lambda: ck.greedy_walk_plain(flat, starts, reals, pool, seg, cap), 2),
        library_ms=None,
        bound=walk_bound(probes, g.numel()),
        shape=f"1 contig x {len(ref)} positions, pool {pool.numel()}, seg {seg}; the walk "
              "over a built walk_index",
    )
    print(f"greedy_walk: {int(g[0, 0])} emissions, {probes} positions to probe, "
          f"max_abs_err {e}; walk_index {results['walk_index']['ms']:.4f} ms + walk "
          f"{results['greedy_walk']['ms']:.4f} ms ({card})")
    del cpacked, canon, flat, pool, idx, g, gp
    torch.cuda.empty_cache()
    programs = match_kernels(np, torch, cm, M, dev, results, card,
                             _build.lib().agc_match_estimate_tile())
    rans_kernels(np, torch, D, E, dev, results)
    stamp("3")

    # -- 4. the main path: chr-scale create --------------------------------
    tmp = tempfile.mkdtemp(prefix="agc_torch_smoke_")
    try:
        files = [os.path.join(tmp, "ref.fa")]
        write_fasta(np, files[0], [("chr1", ref)])
        seqs = {"ref": ref}
        for i in range(N_SAMPLES):
            seqs[f"s{i}"] = mutate(np, rng, ref)
            files.append(os.path.join(tmp, f"s{i}.fa"))
            write_fasta(np, files[-1], [("chr1", seqs[f"s{i}"])])
        total = sum(len(s) for s in seqs.values())
        out = os.path.join(tmp, "smoke.agc")

        def timed_create(params) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            create_archive(out, files, params, device=DEVICE)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        ck.reset_launches()
        # default parameters; verbosity 1 only adds the stage timings on stderr
        walls = [timed_create(CompressorParams(verbosity=1))]
        launches = dict(ck.LAUNCHES)
        print(f"create: {total} bases in {walls[0]:.4f} s = {total / walls[0] / 1e6:.2f} "
              f"Mbases/s ({card}); archive {os.path.getsize(out)} bytes; launches {launches}")
        for name in ("scan_fused", "kmer_canon", "walk_index", "greedy_walk"):
            check(launches[name] > 0, f"the create never launched {name}")
            results[name]["launches"] = launches[name]
        walls += [timed_create(CompressorParams()) for _ in range(2)]
        print(f"create walls (s): {[round(w, 4) for w in walls]}; Mbases/s: "
              f"{[round(total / w / 1e6, 2) for w in walls]} ({card})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pwall = timed_create(CompressorParams())
        busy, by_name = device_time(torch, prof)
        print(f"profiled create: wall {pwall:.4f} s, device busy {busy:.3f} ms, "
              f"busy share {busy / 1e3 / pwall:.5f} of that run ({card})")
        print_device(by_name)
        results["scan_fused"]["chr_scale_profiled_ms"] = kernel_ms(by_name, SCAN_KERNELS)
        print(f"profiled create: scan_fused kernels {kernel_ms(by_name, SCAN_KERNELS):.3f} ms "
              f"({', '.join(SCAN_KERNELS)}; {card})")

        reader = ArchiveReader(out)
        data, _n = reader.get_part("splitters", 0)
        reader.close()
        got = set(np.frombuffer(data, dtype="<u8").tolist())
        t0 = time.perf_counter()
        cpu = Compressor(os.path.join(tmp, "cpu.agc"), CompressorParams(),
                         reference_file=files[0], device="cpu")
        want = cpu.splitter_set_snapshot()
        cpu.abort()
        print(f"splitters: {len(got)} on the card, {len(want)} from the plain "
              f"versions on the CPU ({time.perf_counter() - t0:.1f} s)")
        check(got == want and len(got) > 100, "splitters differ from the CPU plain version")

        alpha = np.frombuffer(ALPHA, dtype=np.uint8)
        with AGCFile(out) as agc:
            for name, seq in seqs.items():
                check(agc.GetCtgSeq(name, "chr1").encode("latin-1") == alpha[seq].tobytes(),
                      f"sample {name} does not extract byte-equal")
        print(f"extract: {len(seqs)} samples byte-equal")

        stamp("4")

        # -- 5. the CLI on the card ----------------------------------------
        cli_out = os.path.join(tmp, "cli.agc")
        cli = [sys.executable, "-m", "agc_tpu_torch.cli.main"]
        r = subprocess.run(cli + ["create", "--device", DEVICE, "-o", cli_out, *files],
                           cwd=REPO, capture_output=True, timeout=600)
        check(r.returncode == 0, f"CLI create exited {r.returncode}: {r.stderr[-2000:]!r}")
        r = subprocess.run(cli + ["getctg", cli_out, "chr1@s1"],
                           cwd=REPO, capture_output=True, timeout=600)
        check(r.returncode == 0, f"CLI getctg exited {r.returncode}: {r.stderr[-2000:]!r}")
        body = b"".join(r.stdout.split(b"\n")[1:])
        check(body == alpha[seqs["s1"]].tobytes(), "CLI getctg does not extract byte-equal")
        print("CLI: create --device cuda, then getctg chr1@s1 byte-equal")
        del seqs

        stamp("5")

        # -- 6. card against CPU on a many-contig collection ----------------
        crng = np.random.default_rng(SEED + 1)
        base = [structured_ref(np, crng, int(n))
                for n in crng.integers(20_000, 2_000_000, 12)]
        cfiles = []
        for fi in range(3):
            cfiles.append(os.path.join(tmp, f"m{fi}.fa"))
            write_fasta(np, cfiles[-1], [
                (f"ctg{ci}.{fi}", b if fi == 0 else mutate(np, crng, b))
                for ci, b in enumerate(base)
            ])
        cbases = sum(len(b) for b in base)
        n_splits = {}
        labels = (
            ("default", CompressorParams(), None),
            ("-c", CompressorParams(concatenated_genomes=True), None),
            ("segment 1000", CompressorParams(segment_size=1000), None),
            # a reference over _POOL_DEVICE_MAX: value-sampled discovery
            ("sampled + segment 1000", CompressorParams(segment_size=1000), 1 << 23),
        )
        # every label's CPU create starts at once, beside the card's
        # creates (the run's time limit)
        on_cpus = [cpu_create(os.path.join(tmp, f"cpu{i}.agc"), cfiles, params, pool_max)
                   for i, (_label, params, pool_max) in enumerate(labels)]
        for i, (label, params, pool_max) in enumerate(labels):
            default_max = Compressor._POOL_DEVICE_MAX
            if pool_max is not None:
                Compressor._POOL_DEVICE_MAX = pool_max
            try:
                a, b = os.path.join(tmp, "card.agc"), os.path.join(tmp, f"cpu{i}.agc")
                on_cpu = on_cpus[i]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctimes = create_archive(a, cfiles, params, device=DEVICE).times
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
                t_cpu = cpu_done(on_cpu)
            finally:
                Compressor._POOL_DEVICE_MAX = default_max
            reader = ArchiveReader(a)
            n_split = n_splits[label] = reader.get_part("splitters", 0)[1]
            reader.close()
            equal = same_archive(ArchiveReader, a, b)
            stages = {n: round(ctimes[n], 3) for n in ("splitter_discovery", "scan_collect",
                                                        "match_contig", "store_encode")}
            print(f"collection ({label}; 3 files x 12 contigs, reference {cbases} bases): "
                  f"{n_split} splitters; card {t_card:.2f} s {stages}, CPU {t_cpu:.2f} s; "
                  f"archives equal part for part: {equal} ({card})")
            check(equal, f"card and CPU archives differ ({label})")
        check(n_splits["segment 1000"] > 8192, "segment 1000 did not reach the join-scan table size")
        check(n_splits["sampled + segment 1000"] > 8192
              and n_splits["sampled + segment 1000"] != n_splits["segment 1000"],
              "the sampled mode did not give its own splitter set over 8192")
        del base

        # -a, -f and -a -f with the reference CI's stress parameters; the
        # discovery's splitter count is read by wrapping determine_splitters
        afiles = adaptive_collection(np, tk, np.random.default_rng(SEED + 8), tmp)
        ffiles = adaptive_collection(np, tk, np.random.default_rng(SEED + 10), tmp, 4, 2, "f")
        stress = dict(kmer_length=17, min_match_len=15, segment_size=1000,
                      pack_cardinality=50000)
        discovered = []
        real_determine = Compressor.determine_splitters
        set_tables = []  # (values, bytes, spilled, tail, walk index bytes) of -f's sets
        real_set_table = cmod.set_table

        def counting_determine(self, reference_file):
            real_determine(self, reference_file)
            discovered.append(set(self._splitter_set))

        def sizing_set_table(values):
            st = real_set_table(values)
            set_tables.append((values.numel(), st.nbytes, st.n_spilled, st.tail.numel(),
                               8 * values.numel()
                               + 4 * ((1 << ck.index_bits(values.numel())) + 1)))
            return st

        Compressor.determine_splitters = counting_determine
        cmod.set_table = sizing_set_table
        try:
            runs = (
                ("-a", CompressorParams(adaptive_compression=True, **stress), afiles),
                ("-f 0.05", CompressorParams(fallback_frac=0.05, **stress), ffiles),
                ("-a -f 0.01", CompressorParams(adaptive_compression=True,
                                                fallback_frac=0.01, **stress), ffiles),
            )
            # every run's CPU create starts at once (the run's time limit)
            on_cpus = [cpu_create(os.path.join(tmp, f"cpu{i}.agc"), lfiles, params)
                       for i, (_label, params, lfiles) in enumerate(runs)]
            for i, (label, params, lfiles) in enumerate(runs):
                discovered.clear()
                a, b = os.path.join(tmp, "card.agc"), os.path.join(tmp, f"cpu{i}.agc")
                on_cpu = on_cpus[i]
                ck.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctimes = create_archive(a, lfiles, params, device=DEVICE)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
                alaunch = dict(ck.LAUNCHES)
                t_cpu = cpu_done(on_cpu)
                reader = ArchiveReader(a)
                n_split = reader.get_part("splitters", 0)[1]
                reader.close()
                equal = same_archive(ArchiveReader, a, b)
                n_disc = len(discovered[0])
                stages = {n: round(ctimes.times[n], 3) for n in (
                    "splitter_discovery", "scan_collect", "match_contig", "store_encode")}
                print(f"collection ({label}, -k 17 -l 15 -s 1000 -b 50000; 3 files, novel "
                      f"contigs, {os.path.getsize(lfiles[0])} reference FASTA bytes): "
                      f"{n_disc} splitters from discovery, {n_split} at the end; "
                      f"delta-scan hits {ctimes.units['delta_hits']}; card {t_card:.2f} s "
                      f"{stages}, CPU {t_cpu:.2f} s; launches {alaunch}; archives equal part "
                      f"for part: {equal} ({card})")
                check(equal, f"card and CPU archives differ ({label})")
                if params.adaptive_compression:
                    check(n_split > n_disc, f"{label} added no splitter")
                    check(ctimes.units["delta_hits"] > 0, f"{label}: the delta scans found no hit")
                if label == "-a":
                    check(n_disc <= 8192 < n_split,
                          f"the -a table did not pass 8192 during the run ({n_disc} -> {n_split})")
                    check(alaunch["scan_fused"] > 0 and alaunch["member_mix"] > 0,
                          "the -a run did not scan through scan_fused, then the join")
                if params.fallback_frac:
                    check(alaunch["kmer_dir_rc"] > 0, f"the {label} run never launched kmer_dir_rc")
                    check(alaunch["set_table"] > 0, f"the {label} run never launched set_table")
                    if label == "-f 0.05":
                        results["kmer_dir_rc"]["launches"] = alaunch["kmer_dir_rc"]
                        results["set_table"]["launches"] = alaunch["set_table"]
                        n, nbytes, spill, tail, walk = set_tables[0]
                        print(f"-f 0.05 discovery's set_table: {n} values, {nbytes} table bytes "
                              f"(a walk index of the set: {walk}), {spill} spilled, {tail} to "
                              "the tail")
                set_tables.clear()
        finally:
            Compressor.determine_splitters = real_determine
            cmod.set_table = real_set_table

        stamp("6")

        # -- 7. the whole-genome path: sampled discovery and the join -------
        wrng = np.random.default_rng(SEED + 2)
        names = [f"chr{i + 1}" for i in range(len(GRCH38_CHR1_3))]
        t0 = time.perf_counter()
        wseqs = {"ref": [structured_ref(np, wrng, n) for n in GRCH38_CHR1_3]}
        for i in range(N_SAMPLES):
            wseqs[f"s{i}"] = [mutate(np, wrng, c) for c in wseqs["ref"]]
        wfiles = []
        os.mkdir(os.path.join(tmp, "whole"))
        for sname, contigs in wseqs.items():  # the sample name is the file's stem
            wfiles.append(os.path.join(tmp, "whole", f"{sname}.fa"))
            write_fasta(np, wfiles[-1], list(zip(names, contigs)))
        wtotal = sum(len(c) for cs in wseqs.values() for c in cs)
        print(f"whole-genome input: reference {sum(GRCH38_CHR1_3)} bases (GRCh38 chr1-3 "
              f"lengths) + {N_SAMPLES} samples = {wtotal} bases, made in "
              f"{time.perf_counter() - t0:.1f} s")
        wout = os.path.join(tmp, "whole.agc")
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wtimes = create_archive(wout, wfiles, CompressorParams(), device=DEVICE).times
        torch.cuda.synchronize()
        wwall = time.perf_counter() - t0
        w_size = os.path.getsize(wout)
        wlaunch = dict(ck.LAUNCHES)
        for name in ("kmer_canon", "walk_index", "greedy_walk", "member_mix", "dir_mix"):
            check(wlaunch[name] > 0, f"the whole-genome create never launched {name}")
        for name in ("member_mix", "dir_mix"):
            results[name]["launches"] = wlaunch[name]
        reader = ArchiveReader(wout)
        data, w_split = reader.get_part("splitters", 0)
        reader.close()
        w_got = set(np.frombuffer(data, dtype="<u8").tolist())
        print(f"whole-genome create: {wtotal} bases in {wwall:.4f} s = "
              f"{wtotal / wwall / 1e6:.2f} Mbases/s ({card}); archive "
              f"{os.path.getsize(wout)} bytes; {w_split} splitters; launches {wlaunch}")
        print("whole-genome stage timers (s): " + json.dumps(
            {n: round(t, 4) for n, t in sorted(wtimes.items(), key=lambda kv: -kv[1])}))
        check(w_split > 8192, f"the whole-genome create has {w_split} splitters, not > 8192")

        # the whole-genome discovery once more, each kmer_canon and
        # greedy_walk call held against its plain version on the card at
        # this path's shapes (the chr1-3 rows; each contig walked whole over
        # the sampled pool); discovery goes on from the plain outputs, so
        # its splitter set is the plain versions' and must be the archive's
        held = {"kmer_canon": [], "greedy_walk": []}
        first = {}  # each kernel's first call: chr1

        def holding(name, kernel, plain, positions):
            def call(*args, **kw):
                first.setdefault(name, args)
                got, want = kernel(*args, **kw), plain(*args)
                held[name].append((max_abs_err(torch, got, want), positions(*args)))
                return want
            return call

        saved = cmod.kmer_canon, tk.greedy_walk
        cmod.kmer_canon = holding("kmer_canon", ck.kmer_canon, ck.kmer_canon_plain,
                                  lambda packed, k: 2 * packed.numel())
        tk.greedy_walk = holding("greedy_walk", ck.greedy_walk, ck.greedy_walk_plain,
                                 lambda canon, starts, reals, pool, *_: (canon.numel(), pool.numel()))
        t0 = time.perf_counter()
        try:
            plain_disc = Compressor(os.path.join(tmp, "plain.agc"), CompressorParams(),
                                    reference_file=wfiles[0], device=DEVICE)
            w_want = plain_disc.splitter_set_snapshot()
            plain_disc.abort()
        finally:
            cmod.kmer_canon, tk.greedy_walk = saved
        for name, calls in held.items():
            e = max((err for err, _ in calls), default=None)
            print(f"whole-genome {name} vs plain on the card: {len(calls)} calls at "
                  f"{[at for _, at in calls]} (positions{', pool' * (name == 'greedy_walk')}), "
                  f"max_abs_err {e}")
            check(e == 0, f"whole-genome {name} disagrees with its plain version ({e})")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
        check(len(held["kmer_canon"]) == 2 * len(names) and len(held["greedy_walk"]) == len(names),
              "the whole-genome discovery did not go through both kernels once a contig")
        print(f"whole-genome splitters: {len(w_got)} in the archive, {len(w_want)} from the "
              f"plain versions on the card ({time.perf_counter() - t0:.1f} s)")
        check(w_got == w_want, "whole-genome splitters differ from the plain versions'")

        # one kmer_canon call on the chr1 row and one greedy_walk call of
        # chr1 over the sampled pool, at this path's shapes
        cpk, ck_k = first["kmer_canon"]
        wc = results["kmer_canon"]
        wc["whole_genome_ms"] = cuda_ms(torch, lambda: ck.kmer_canon(cpk, ck_k), 5)
        wc["whole_genome_bound_ms"] = canon_bound(cpk.numel())[0]
        wargs = first["greedy_walk"]
        w_canon, _s, w_reals, w_pool, w_seg, w_cap = wargs
        w_idx = ck.walk_index(w_pool)
        wi = results["walk_index"]
        wi["whole_genome_ms"] = cuda_ms(torch, lambda: ck.walk_index(w_pool), 5)
        wi["whole_genome_bound_ms"] = index_bound(w_pool.numel(), *w_idx)[0]
        g = ck.greedy_walk(*wargs, index=w_idx)
        probes = walk_positions(g[0].tolist(), int(w_reals[0]), w_seg, w_cap)
        ww = results["greedy_walk"]
        ww["whole_genome_ms"] = cuda_ms(torch, lambda: ck.greedy_walk(*wargs, index=w_idx), 5)
        ww["whole_genome_bound_ms"] = walk_bound(probes, g.numel())[0]
        print(f"whole-genome chr1: kmer_canon {wc['whole_genome_ms']:.4f} ms over "
              f"{2 * cpk.numel()} positions (bound {wc['whole_genome_bound_ms']:.4f} ms); "
              f"walk_index {wi['whole_genome_ms']:.4f} ms over pool {w_pool.numel()} (bound "
              f"{wi['whole_genome_bound_ms']:.4f} ms); greedy_walk {ww['whole_genome_ms']:.4f} "
              f"ms, {int(g[0, 0])} emissions, {probes} positions to probe (bound "
              f"{ww['whole_genome_bound_ms']:.4f} ms) ({card})")
        del held, first, plain_disc, cpk, wargs, w_canon, w_pool, w_idx, g
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with AGCFile(wout) as agc:
            for sname, contigs in wseqs.items():
                for cname, seq in zip(names, contigs):
                    check(agc.GetCtgSeq(sname, cname).encode("latin-1") == alpha[seq].tobytes(),
                          f"{cname}@{sname} does not extract byte-equal")
        print(f"whole-genome extract: {len(wseqs)} samples x {len(names)} contigs byte-equal "
              f"({time.perf_counter() - t0:.1f} s)")

        stamp("7")

        # -- 8. the adaptive create at full width -----------------------------
        adaptive_create(np, torch, ck, tk, cmod, Compressor, CompressorParams, create_archive,
                        ArchiveReader, AGCFile, results, programs, card, tmp, wfiles[0], names,
                        wseqs)

        stamp("8")

        # -- 9. the match layer at full width --------------------------------
        match_layer(np, torch, ck, cm, M, tk, cmod, Compressor, CompressorParams,
                    create_archive, ArchiveReader, AGCFile, LZDiff, results, programs, card,
                    tmp, wfiles, names, wseqs, files, cfiles, ffiles, stamp)
        stamp("9")

        # -- 10. the device rANS coder at full width -------------------------
        rans_phase(np, torch, ck, D, E, CompressorParams, create_archive, append_archive,
                   ArchiveReader, AGCFile, results, card, tmp, wfiles, names, wseqs, files,
                   cfiles)
        stamp("10")

        # -- 11. the sharded, mesh and distributed creates -------------------
        parallel_phase(np, torch, ck, u64, CompressorParams, create_archive, ArchiveReader,
                       AGCFile, results, programs, card, tmp, ref, files, cfiles, wfiles,
                       names, wseqs, w_size, wwall, stamp)
        stamp("11")
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"],
         **{key: v for key, v in r.items()
            if key.startswith(("whole_genome", "chr_scale", "large_table", "member_",
                               "adaptive_", "anchor_", "old_count_", "flush_", "kernel_ms",
                               "synthetic_", "one_launch_", "tier_", "spill_",
                               "table_bytes", "sharded_", "mesh_", "torchdist_"))}}
        for name, r in results.items()
    ]
    for name, r in results.items():
        print(f"{name}: {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms "
              f"({r['shape']}; {card})")
    print("torch-op programs: " + json.dumps(programs))
    print(f"chip_smoke.py: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
