"""Compression engine of the port: FASTA collection -> AGC archive.

Counterpart of ``agc_tpu/core/compressor.py``: its parameters, helpers,
``Compressor`` class and ``create_archive`` / ``append_archive`` entry
points, over the port's own copies of the host layers (segment matching,
LZ, zstd, container, collection). The port's device ops are bound in the
one import block from ``..ops`` below - the seam that later slices swap
kernels behind.

Splitter discovery, the candidate tables and new-splitter discovery of
adaptive mode (-a), the dense scans of fallback minimizers (-f), the
membership scans and the match layer (the batched estimate prepass, the
split search, -f's shortlist and the anchor-mode tables, ``ops/match.py``)
run on ``device``: the CUDA kernels of ``agc_tpu_torch.ops.cuda_kmers``
and ``cuda_match`` on ``"cuda"``, their plain PyTorch versions on
``"cpu"``. Engines give identical results, so the archive bytes do not
depend on the device. Options whose device ops are not ported yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, replace as _dc_replace

import numpy as np
import torch

from ..version import (
    AGC_FILE_MAJOR,
    AGC_FILE_MINOR,
    COMMENT,
    PRODUCER,
    PRODUCER_BUILD,
    PRODUCER_VERSION,
)
from .archive import ArchiveWriter
from .codecs import (
    fixed_u32,
    fixed_u64,
    murmur64,
    ss_base,
    ss_delta_name,
    ss_ref_name,
)
from .collection import CollectionV3
from .genome_io import (
    preprocess_raw_contig,
    read_contigs_raw,
    sample_name_from_path,
)
from .segment import SegmentWriter, _zstd_level
from ..ops import match as _match
from ..ops import resolve_device, u64
from ..ops.cuda_kmers import isin_sorted, kmer_canon, set_table, walk_index
from ..ops.kmers import (
    DaemonPool,
    ScanBatcher,
    _revcomp_np,
    _shift_for,
    candidate_tables,
    canon_kmers_np,
    collect_kmers,
    collect_kmers_device_packed,
    contig_canon,
    find_splitter_emissions_packed,
    make_scan_table,
    pack4_np,
    sample_kmers,
    scan_contig,
    singleton_filter,
    sort_kmers,
)
from ..utils.profiling import StageTimers, device_trace

__all__ = ["Compressor", "CompressorParams", "append_archive", "create_archive"]

EMPTY = (1 << 64) - 1
PK_EMPTY = (EMPTY, EMPTY)
NO_RAW_GROUPS = 16
# async store backlog bound in BYTES (in addition to the barrier-count
# bound): each in-flight job pins its whole barrier's segment bytes
_STORE_BACKLOG_BYTES = int(
    os.environ.get("AGC_TPU_STORE_BACKLOG_MB", "640")
) << 20

_FALLBACK_RND = 0xD73F8BF11046C40E


@dataclass
class CompressorParams:
    kmer_length: int = 31
    min_match_len: int = 20
    pack_cardinality: int = 50
    segment_size: int = 60000
    concatenated_genomes: bool = False
    adaptive_compression: bool = False
    fallback_frac: float = 0.0
    verbosity: int = 0
    # archive profile: "zstd" (reference-compatible container, default) or
    # "tpu-rans" (same container/layout, parts coded by the lane-
    # interleaved rANS stage; readable by agc-tpu and its C API, not by
    # the reference binary; see core/entropy.py and core/convert.py)
    profile: str = "zstd"
    # LZ decision rule: "classic" (the reference's probe-per-position
    # walk, lz_diff.cpp:669-798) or "anchor" (the anchor rule,
    # lz_native.cpp anchor section + ops/match.py anchor_diag_sets). The
    # grammar is the same; the CHOICE of matches differs, so the mode
    # changes archive bytes, whereas AGC_TPU_DEVICE_LZ (where the anchor
    # tables are computed) never does. None = AGC_TPU_LZ_MODE env or
    # classic.
    lz_mode: str | None = None


class Kmer:
    """Canonical k-mer snapshot: (dir, rc) left-aligned u64 codes.

    reference: src/core/kmer.h (data/is_dir_oriented/swap_dir_rc).
    """

    __slots__ = ("dir", "rc", "full")

    def __init__(self, dir_=0, rc=0, full=False):
        self.dir = dir_
        self.rc = rc
        self.full = full

    def data(self) -> int:
        return min(self.dir, self.rc)

    def is_dir_oriented(self) -> bool:
        return self.dir <= self.rc

    def swapped(self) -> "Kmer":
        return Kmer(self.rc, self.dir, self.full)


EMPTY_KMER = Kmer()


@dataclass
class _PendingSeg:
    sample: str
    contig: str
    part_no: int
    data: bytes | None  # None: materialize from ``raw`` at store time
    is_rc: bool
    raw: np.ndarray | None = None  # numeric view (reverse-complemented
    # and converted on the store worker, off the matcher's thread)
    # anchor tables for the anchor LZ mode, computed on the device by the
    # store's prepass (None = the host twin computes them / classic rule)
    anchor_tab: object = None
    # shard-shipped LZ delta: (delta_bytes, ref_hash) computed against
    # the boot-broadcast group reference; the writer uses it only after
    # verifying its group's actual reference hash (parallel/distributed)
    delta_hint: object = None
    # boot-precompressed reference blob: (blob, meta, ref_hash); used by
    # the group's FIRST member iff its bytes hash-match (zstd profile)
    ref_blob_hint: object = None

    def materialize(self) -> bytes:
        # race-tolerant (the store worker and a matcher-side ensure_ref
        # may materialize concurrently): read fields once, publish data
        # before clearing raw — both compute identical bytes
        data = self.data
        if data is None:
            raw = self.raw
            if raw is None:
                return self.data  # lost the race; winner published data
            arr = _rc_numeric(raw) if self.is_rc else raw
            data = arr.astype(np.uint8, copy=False).tobytes()
            self.data = data
            self.raw = None
        return data

    def size(self) -> int:
        return len(self.data) if self.data is not None else len(self.raw)


class _LazyHints:
    """Deferred result of the async device-match prepass. ``ordinals``
    is the set of queried segment ordinals: ``get``/``ref`` for any other
    ordinal return at once, and a queried ordinal blocks on the background
    estimate job only when ITS segment's one-splitter search consumes the
    hint (inside _find_cand_one_splitter), so the device work overlaps the
    host's walk over the contig's earlier segments. Every queried
    ordinal's segment reaches _find_cand_one_splitter before the sample
    barrier, so the future is always consumed within its contig, and an
    error of the job surfaces there."""

    __slots__ = ("_fut", "_hints", "_ordinals", "_timers")

    def __init__(self, fut, ordinals, timers):
        self._fut = fut
        self._hints = None
        self._ordinals = frozenset(ordinals)
        self._timers = timers

    def get(self, seg_ord, default=None):
        if seg_ord not in self._ordinals:
            return default
        if self._hints is None:
            with self._timers.stage("wait_match"):
                self._hints = self._fut.result()
        return self._hints.get(seg_ord, default)

    def ref(self, seg_ord):
        """A resolve-on-use handle for _find_cand_one_splitter (None when
        the ordinal has no pending query)."""
        if seg_ord not in self._ordinals:
            return None
        return _LazyHint(self, seg_ord)


class _LazyHint:
    """One segment's deferred device hint; ``resolve`` blocks on the
    prepass job (first resolver wins, result memoized on the parent)."""

    __slots__ = ("_parent", "_ord")

    def __init__(self, parent, ord_):
        self._parent = parent
        self._ord = ord_

    def resolve(self):
        return self._parent.get(self._ord)


def rerank_near_ties(
    scored: list[tuple[int, int, tuple[int, int]]], window: float = 1.01
) -> tuple[int, int, tuple[int, int]]:
    """Pick the candidate group from ``scored`` [(estimate, stored-member
    count, splitter pair), ...] for a fallback-minimizer match.

    When every candidate group is a rearranged copy of the same genome the
    LZ estimates land within a fraction of a percent of each other and
    hash-probe noise decides the exact argmin; the PACKED size is then
    dominated not by the LZ delta but by which zstd pack the member joins —
    co-packing with the group that already holds the member's family
    compresses measurably better. Rule: take the exact argmin (ties by
    smaller pair, deterministic), unless another candidate within
    ``window`` of it DOMINATES it in stored members (>=2x and strictly
    more). The reference (agc_compressor.cpp:1929-1933) always takes the
    exact argmin and loses that pack sharing to estimate noise."""
    argmin = min(scored, key=lambda s: (s[0], s[2]))
    near = [s for s in scored if s[0] <= argmin[0] * window]
    if len(near) > 1:
        lead = min(near, key=lambda s: (-s[1], s[0], s[2]))
        if lead[1] >= 2 * max(argmin[1], 1) and lead[1] > argmin[1]:
            return lead
    return argmin


def _union_hits(a, b):
    """Union two disjoint (pos, udir, urc) hit sets, position-sorted."""
    if not len(b[0]):
        return a
    if not len(a[0]):
        return b
    pos = np.concatenate([a[0], b[0]])
    order = np.argsort(pos, kind="stable")
    return (
        pos[order],
        np.concatenate([a[1], b[1]])[order],
        np.concatenate([a[2], b[2]])[order],
    )


_NATIVE_LIB = None
_NATIVE_LIB_TRIED = False


def _native_lib():
    """Module-local memo of the ctypes library: get_lib() takes a lock on
    every call, which contends measurably when store worker + matcher
    both reverse-complement thousands of segments."""
    global _NATIVE_LIB, _NATIVE_LIB_TRIED
    if not _NATIVE_LIB_TRIED:
        from ..native import get_lib

        _NATIVE_LIB = get_lib()
        _NATIVE_LIB_TRIED = True
    return _NATIVE_LIB


def _rc_numeric(arr: np.ndarray) -> np.ndarray:
    """Reverse complement of a numeric sequence (ACGT codes 0-3 flip,
    N/IUPAC codes pass through; reference: agc_basic.cpp:257-315).
    Single native pass when the fast library is available."""
    lib = _native_lib()
    if lib is not None and arr.flags.c_contiguous and arr.dtype == np.uint8:
        import ctypes

        out = np.empty(len(arr), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rc_numeric(
            arr.ctypes.data_as(u8p), len(arr), out.ctypes.data_as(u8p)
        )
        return out
    out = arr[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def greedy_splitter_walk(n, k, seg, hits, hit_canon, fb_ctx=None):
    """Greedy splitter emission over membership hits, with optional -f
    fallback-record collection (reference: find_splitters_in_contig,
    agc_compressor.cpp:762-825).

    ``hits``: sorted positions (k-mer END index) of candidate-set members;
    ``hit_canon``: their canonical codes; ``fb_ctx``: dense per-position
    (valid, canon, udir, urc, fallback_filter) arrays for -f.
    Returns (splitters, fallback-records (prev, cur, kmer, is_dir))."""
    out: list[int] = []
    fallbacks: list[tuple[int, int, int, bool]] = []

    if fb_ctx is not None:
        valid, canon, udir, urc, fb_filter = fb_ctx

        def fb_range(lo_pos, hi_pos, prev_sp, cur_sp):
            """Collect fallback k-mers with asymmetric orientation in
            positions [lo_pos, hi_pos)."""
            vv = np.flatnonzero(valid[lo_pos:hi_pos]) + lo_pos
            for p in vv.tolist():
                d = int(canon[p])
                if udir[p] != urc[p] and fb_filter(d):
                    fallbacks.append(
                        (prev_sp, cur_sp, d, bool(udir[p] <= urc[p]))
                    )
    else:
        def fb_range(lo_pos, hi_pos, prev_sp, cur_sp):
            pass

    prev_splitter = EMPTY
    last_emit = None  # position of last emission
    fb_start = 0  # first position whose fallback kmers belong to open segment

    for hi, p in enumerate(hits.tolist()):
        if last_emit is not None and (p - last_emit) < seg:
            continue
        if last_emit is not None and p < last_emit + k:
            continue
        d = int(hit_canon[hi])
        out.append(d)
        fb_range(fb_start, p + 1, prev_splitter, d)
        prev_splitter = d
        # the reference Resets its rolling k-mer at the cut, so the
        # k-1 windows after an emission are never full and contribute
        # no fallback k-mers (find_splitters_in_contig,
        # agc_compressor.cpp:806 kmer.Reset())
        fb_start = p + k
        last_emit = p

    # rightmost-candidate fallback (agc_compressor.cpp:817-824)
    floor = (last_emit + k) if last_emit is not None else 0
    tail = np.flatnonzero(hits >= floor)
    if len(tail):
        hi = int(tail[-1])
        d = int(hit_canon[hi])
        out.append(d)
        fb_range(fb_start, n, prev_splitter, d)
    return out, fallbacks


class _FallbackFilter:
    """Hashed k-mer fraction filter (reference: agc_compressor.h:570-599)."""

    def __init__(self, fraction: float):
        self.thr = int(((1 << 64) - 1) * fraction) if fraction > 0 else 0

    def __bool__(self):
        return self.thr != 0

    def __call__(self, kmer: int) -> bool:
        return (murmur64(kmer) ^ _FALLBACK_RND) < self.thr


class Compressor:
    """Create or append to an AGC archive; device work runs on
    ``device`` ("cuda" by default, "cpu" for the plain versions)."""

    _entropy_batcher = None  # tpu-rans deferred-part sink (lazy)
    _match_pool = None  # async device-match prepass worker (lazy)

    def __init__(
        self,
        out_path: str,
        params: CompressorParams | None = None,
        reference_file: str | None = None,
        in_path: str | None = None,
        prefetch: bool = True,
        device="cuda",
    ):
        self._init_state(params, device)
        self.writer = ArchiveWriter(out_path)
        if in_path is not None:
            self._init_append(in_path, prefetch)
        else:
            assert reference_file is not None, "create mode needs a reference file"
            self._init_create(reference_file)

    def _init_state(self, params: CompressorParams | None, device) -> None:
        """Every attribute of the engine but its archive writer. The
        sharded creates build engines without opening an archive
        (parallel/distributed.py) and start from this same state."""
        # private copy: append mode overwrites k/l/b/s/profile from the
        # input archive, and that must not leak into the caller's object
        self.p = _dc_replace(params) if params is not None else CompressorParams()
        self.k = self.p.kmer_length
        self.archive_version = AGC_FILE_MAJOR * 1000 + AGC_FILE_MINOR
        if self.p.profile not in ("zstd", "tpu-rans"):
            # validate BEFORE the writer opens (and truncates) out_path
            raise ValueError(f"unknown archive profile {self.p.profile!r}")
        self.device = resolve_device(device)
        self.collection: CollectionV3
        self.map_segments: dict[tuple[int, int], int] = {PK_EMPTY: 0}
        self.terminators: dict[int, list[int]] = {}
        self.v_segments: list[SegmentWriter | None] = []
        self.no_segments = 0
        self.splitters: np.ndarray = np.empty(0, dtype=np.uint64)
        self._splitter_set: set[int] = set()
        self.fallback_filter = _FallbackFilter(self.p.fallback_frac)
        self._match_bank = None  # RefBank of ops/match.py, lazy
        self._anchor_bank = None  # AnchorCodeBank for the anchor LZ mode
        self.map_fallback: dict[int, list[tuple[int, int]]] = {}
        self._pending_fallback: list[tuple[int, int, int, bool]] = []
        # adaptive-mode candidate tables of the reference: its singleton
        # and duplicated k-mers, sorted flipped int64 tensors on the device
        self.cand_singletons = torch.empty(0, dtype=torch.int64, device=self.device)
        self.cand_duplicated = torch.empty(0, dtype=torch.int64, device=self.device)
        self._pending_new_splitters: list[int] = []
        # append-only log of splitters added after create-time discovery
        # (drives adaptive-mode delta scans in add_sample_files)
        self._splitter_log: list[int] = []
        self._raw_contigs: list[tuple[str, str, np.ndarray]] = []
        # per-barrier buffers (CBufferedSegPart)
        self._buf_known: dict[int, list[_PendingSeg]] = {}
        self._buf_new: list[tuple[int, int, _PendingSeg]] = []
        self.processed_samples = 0
        self.processed_bases = 0
        # high-water mark of samples covered by stored metadata batches.
        # The reference re-stores the final batch when the contig count of
        # a -c create lands exactly on a batch boundary (the unconditional
        # end-of-input sync token, agc_compressor.cpp:2240-2248, reaches
        # the barrier store at :1153-1154 after the names were already
        # evicted), appending a spurious EMPTY batch part that corrupts a
        # later append (collection_v3.cpp:97-104 copies it verbatim and
        # shifts every later batch).  We guard instead of replicating the
        # bug; see also the trailing-part drop in _init_append.
        self._batches_stored_end = 0
        self.file_type_info = {
            "producer": PRODUCER,
            "producer_version_major": str(PRODUCER_VERSION[0]),
            "producer_version_minor": str(PRODUCER_VERSION[1]),
            "producer_version_build": PRODUCER_BUILD,
            "file_version_major": str(AGC_FILE_MAJOR),
            "file_version_minor": str(AGC_FILE_MINOR),
            "comment": COMMENT,
        }
        if self.p.profile != "zstd":
            self.file_type_info["compression-profile"] = self.p.profile
        self._closed = False
        self._mode = None
        self._n_threads = max(1, (os.cpu_count() or 2) // 2)
        self._store_pool = None  # persistent pool for async barrier stores
        self._pending_store = None  # list of in-flight store futures
        self._pending_meta = []  # in-flight metadata batch compressions
        self._pending_reference = None  # deferred create-time discovery
        # per-contig splitter hits of the discovery reference, recorded
        # during discovery: every splitter is a SINGLETON of the
        # reference, so its only reference occurrence is its emission
        # position — the reference sample's membership scan is fully
        # known before it runs and is skipped
        self._ref_scan_cache: list[dict] | None = None
        self._ref_scan_file: str | None = None
        # discovery's preprocessed reference contigs, handed to the sample
        # producer so the reference file is read+converted once, not twice
        self._ref_codes: list[tuple[str, np.ndarray]] | None = None
        self._ref_codes_ready = threading.Event()
        # the sharded merge's boot-precompressed reference parts, by
        # splitter pair (parallel/distributed.py); empty elsewhere
        self._inv_ref_blobs: dict = {}
        self.timers = StageTimers()
        # the engine thread's waits on its workers read 0 s, not nothing,
        # in a run that never waits on one (no contig reaching the match
        # prepass's gate, every sample parsed ahead)
        for wait in ("wait_parse", "wait_match", "wait_store"):
            self.timers.add(wait, 0.0)

    # ==================================================================
    # create / append initialization
    # ==================================================================

    def _init_create(self, reference_file: str) -> None:
        self._mode = "create"
        # splitter discovery is deferred to first use so sample-file
        # prefetch (add_sample_files' producer pool) overlaps its device
        # round-trips
        self._pending_reference = reference_file
        self.collection = CollectionV3(
            self.p.pack_cardinality, self.p.segment_size, self.k
        )
        self.collection.profile = self.p.profile
        self._register_collection_streams()
        self.v_segments = [None] * NO_RAW_GROUPS
        for gid in range(NO_RAW_GROUPS):
            self.writer.register_stream(ss_delta_name(self.archive_version, gid))
            seg = self._make_writer(gid)
            self.v_segments[gid] = seg
            seg.add_raw(b"\x7f")  # ensure raw groups exist (agc_compressor.cpp:2313-2321)
        self.no_segments = NO_RAW_GROUPS

    def _register_collection_streams(self) -> None:
        """v3 archives MUST carry collection-samples/-contigs/-details as
        stream ids 0/1/2: the reference's append resolves these streams in
        the INPUT archive by the ids it just registered in the output
        archive ("in and out ids for collection-* must be the same!",
        collection_v3.cpp:48-61) and segfaults on any other layout."""
        if self.archive_version >= 3000:
            for s in (
                "collection-samples",
                "collection-contigs",
                "collection-details",
            ):
                self.writer.register_stream(s)

    def _init_append(self, in_path: str, prefetch: bool) -> None:
        """reference: CAGCCompressor::Append + appending_init
        (agc_compressor.cpp:303-380, 2330-2384)."""
        self._mode = "append"
        from .decompressor import Decompressor

        d = Decompressor(in_path, prefetch=prefetch)
        self._append_src = d
        self.archive_version = d.archive_version
        self.p.kmer_length = d.kmer_length
        self.p.min_match_len = d.min_match_len
        self.p.pack_cardinality = d.pack_cardinality
        self.p.segment_size = d.segment_size
        self.k = d.kmer_length
        # preserve original producer info keys where present
        for key, val in d.file_type_info.items():
            if key.startswith("file_version"):
                self.file_type_info[key] = val
        # the profile is an archive property: appends continue whatever
        # profile the input archive was written with
        self.p.profile = d.file_type_info.get("compression-profile", "zstd")
        if self.p.profile != "zstd":
            self.file_type_info["compression-profile"] = self.p.profile
        elif "compression-profile" in self.file_type_info:
            del self.file_type_info["compression-profile"]

        self.collection = d.collection
        self.collection.profile = self.p.profile
        reader = d.reader
        self._register_collection_streams()
        if self.archive_version >= 3000:
            # Copy all complete old metadata batches verbatim to the new
            # archive; only the last partial batch is re-serialized together
            # with new samples (reference: prepare_for_appending_copy /
            # prepare_for_appending_load_last_batch, collection_v3.cpp:48-108).
            n_batches = reader.n_parts("collection-contigs")
            n_old = self.collection.get_no_samples()
            bs = self.collection.batch_size
            last_batch_full = n_old % bs == 0
            # real batch count from the sample count, NOT the part count:
            # reference -c archives whose contig total lands exactly on a
            # batch boundary carry a spurious trailing EMPTY batch part
            # (agc_compressor.cpp:2240-2248 + :1153-1154 store the final
            # batch twice, the second time after eviction); copying it
            # would shift every appended batch by one part (that is the
            # reference's own appending bug, collection_v3.cpp:97-104)
            real_batches = (n_old + bs - 1) // bs
            n_copy = (
                min(n_batches, real_batches)
                if last_batch_full
                else real_batches - 1
            )
            self._batches_stored_end = n_copy * bs
            for i in range(n_copy):
                data, meta = reader.get_part("collection-contigs", i)
                self.writer.add_part("collection-contigs", data, meta)
                data, meta = reader.get_part("collection-details", i)
                self.writer.add_part("collection-details", data, meta)
            # load the partial last batch (it will be re-stored) and make
            # every sample's names queryable
            for sid in range(n_old):
                self.collection._ensure_sample(
                    sid, details=(sid // bs) >= n_copy
                )
        # legacy (1.x / 2.x) collections are fully loaded by the
        # Decompressor; the whole collection is re-serialized in the
        # original format at close (reference: store_metadata_impl_v1/v2)
        # rebuild segment writers by probing stream names
        self.no_segments = 0
        self.v_segments = []
        while True:
            ref_s = ss_ref_name(self.archive_version, self.no_segments)
            delta_s = ss_delta_name(self.archive_version, self.no_segments)
            if not reader.has_stream(ref_s) and not reader.has_stream(delta_s):
                break
            seg = self._make_writer(self.no_segments)
            seg.appending_init(reader)
            self.v_segments.append(seg)
            self.no_segments += 1
        while self.no_segments < NO_RAW_GROUPS:
            # archive predates some raw-group streams: create them fresh
            gid = self.no_segments
            self.writer.register_stream(ss_delta_name(self.archive_version, gid))
            seg = self._make_writer(gid)
            self.v_segments.append(seg)
            seg.add_raw(b"\x7f")
            self.no_segments += 1

        # reload splitters
        part = reader.get_part("splitters", 0)
        data, n_splitters = part
        arr = np.frombuffer(data, dtype="<u8").copy()
        self._splitter_set = set(int(x) for x in arr)
        self._refresh_splitter_table()

        # reload segment-splitter map + terminators
        part = reader.get_part("segment-splitters", 0)
        data, n_entries = part
        self.map_segments = {PK_EMPTY: 0}
        for i in range(n_entries):
            off = i * 20
            k1 = int.from_bytes(data[off : off + 8], "little")
            k2 = int.from_bytes(data[off + 8 : off + 16], "little")
            gid = int.from_bytes(data[off + 16 : off + 20], "little")
            self.map_segments[(k1, k2)] = gid
            if k1 != EMPTY and k2 != EMPTY:
                self.terminators.setdefault(k1, []).append(k2)
                if k1 != k2:
                    self.terminators.setdefault(k2, []).append(k1)
        for v in self.terminators.values():
            v.sort()

        self.processed_samples = self.collection.get_no_samples()

        if self.p.adaptive_compression:
            self._build_candidate_kmers_from_archive()

    def _build_candidate_kmers_from_archive(self) -> None:
        """Adaptive append: re-count reference-sample k-mers
        (reference: agc_compressor.cpp:828-847)."""
        ref_name = self.collection.get_reference_name()
        if not ref_name:
            return
        seqs = self._append_src.get_sample_sequences(ref_name)
        kmers = [collect_kmers(ctg, self.k, self.device) for _, ctg in seqs]
        self._set_tables(*candidate_tables(sort_kmers(
            torch.cat(kmers) if kmers
            else torch.empty(0, dtype=torch.int64, device=self.device)
        )))

    def _set_tables(self, singles: torch.Tensor, dups: torch.Tensor) -> None:
        """Keep the candidate tables (sorted flipped int64 on the device)
        where adaptive mode reads them; other modes need none."""
        if self.p.adaptive_compression:
            self.cand_singletons, self.cand_duplicated = singles, dups

    def _make_writer(self, gid: int) -> SegmentWriter:
        w = SegmentWriter(
            ss_base(self.archive_version, gid),
            self.writer,
            self.p.pack_cardinality,
            self.p.min_match_len,
            self.archive_version,
        )
        w.profile = self.p.profile
        w.lz_mode = self._lz_mode()
        w.entropy_batcher = self._entropy_sink()
        return w

    def _lz_mode(self) -> str:
        """Resolved LZ decision rule (see CompressorParams.lz_mode).
        Anchor mode needs the V2 grammar; legacy (1.x) archives always
        use classic."""
        mode = self.p.lz_mode or os.environ.get("AGC_TPU_LZ_MODE", "classic")
        if mode == "anchor" and self.archive_version >= 2000:
            return "anchor"
        return "classic"

    def _device_lz_enabled(self) -> bool:
        """Engine choice for anchor-mode tables (never changes bytes):
        AGC_TPU_DEVICE_LZ=1/0 forces; auto computes them on the engine's
        device when that is a CUDA card, with the host twin otherwise."""
        force = os.environ.get("AGC_TPU_DEVICE_LZ")
        if force is not None:
            return force not in ("0", "")
        return self.device.type == "cuda"

    def _entropy_sink(self):
        """Shared deferred-entropy sink for the tpu-rans profile: part
        payloads queue here and are rANS-coded a flush at a time at the
        store/finish flush points (entropy.compress_parts), on the
        engine's device when the device coder is forced. None on the zstd
        profile (zstd compresses inline)."""
        if self.p.profile != "tpu-rans":
            return None
        if self._entropy_batcher is None:
            from .entropy import EntropyBatcher

            self._entropy_batcher = EntropyBatcher(self.writer, self.device)
        return self._entropy_batcher

    # ==================================================================
    # splitter discovery (device kernels)
    # ==================================================================

    def _emission_hits(self, codes: np.ndarray, pos_list) -> dict:
        """Materialize (pos, udir, urc) scan hits for splitter emission
        positions of one discovery-reference contig (same layout as
        ScanBatcher.collect: left-aligned u64 codes, position = last base
        of the k-mer)."""
        pos = np.asarray(sorted(int(p) for p in pos_list), dtype=np.int64)
        k = self.k
        dir_u = np.zeros(len(pos), dtype=np.uint64)
        for j in range(k):
            dir_u |= codes[pos - j].astype(np.uint64) << np.uint64(2 * j)
        rc_u = _revcomp_np(dir_u, k)
        sh = np.uint64(_shift_for(k))
        return {
            "n": len(codes),
            "hits": (pos, dir_u << sh, rc_u << sh),
        }

    def determine_splitters(self, reference_file: str) -> None:
        """reference: agc_compressor.cpp:428-563."""
        self._ref_scan_file = reference_file
        try:
            self._determine_splitters_impl(reference_file)
        finally:
            # unblock the sample producer waiting to reuse the reference
            # contigs (load_file in add_sample_files)
            self._ref_codes_ready.set()

    # above this many reference positions the full k-mer pool (8 B each,
    # plus sort temporaries) is not built: discovery takes the value-
    # sampled two-pass path, as agc_tpu does (a different splitter set)
    _POOL_DEVICE_MAX = 256 << 20
    # -a and -f never take the sampled path (agc_tpu sends them to a host
    # full pool above _POOL_DEVICE_MAX): their full pool is built on the
    # card up to this many positions, and on the host above. Set from the
    # peak device memory measured on the card (PERF.md §5).
    _POOL_CARD_MAX = 1 << 30

    def _determine_splitters_impl(self, reference_file: str) -> None:
        """Discovery on ``self.device``: canonical fill of the whole
        reference in one kmer_canon launch, one pool sort, and the greedy
        singleton walks of all contigs in one greedy_walk launch; above
        ``_POOL_DEVICE_MAX`` positions, the value-sampled path. -a and -f
        build the full pool whatever its size, on the card up to
        ``_POOL_CARD_MAX`` positions and on the host above (the route is
        chosen by size before any launch)."""
        if self.p.verbosity > 0:
            # reference stage messages (agc_compressor.cpp:448, 481)
            print("Gathering reference k-mers", file=sys.stderr)
            print("Determination of splitters", file=sys.stderr)
        with self.timers.stage("disc_parse_ref"):
            named = [
                (cid, preprocess_raw_contig(raw, cid))
                for cid, raw in read_contigs_raw(reference_file)
            ]
        self._ref_codes = named
        contigs = [codes for _, codes in named]
        total = sum(len(c) for c in contigs)
        if self.p.adaptive_compression or self.fallback_filter:
            on_card = total <= self._POOL_CARD_MAX
            if self.p.verbosity > 0:
                print(
                    f"Candidate k-mer pool: {total} positions on the "
                    f"{'device' if on_card else 'host'} (card limit "
                    f"{self._POOL_CARD_MAX})",
                    file=sys.stderr,
                )
            if not on_card:
                if self.fallback_filter:
                    self._determine_splitters_host_candidates(contigs)
                else:
                    self._determine_splitters_host(contigs)
                return
            if self.fallback_filter:
                self._fallback_discovery(contigs)
                return
            emissions = self._pool_emissions(contigs)
        elif total > self._POOL_DEVICE_MAX:
            emissions = self._sampled_emissions(contigs, total)
        else:
            emissions = self._pool_emissions(contigs)
        splitters: list[int] = []
        cache = []
        for codes, (pos, kmers, tail_pos, tail_kmer) in zip(contigs, emissions):
            splitters.extend(int(x) for x in kmers)
            emitted = [int(x) for x in pos]
            last = int(pos[-1]) if len(pos) else None
            if tail_pos is not None and (last is None or tail_pos >= last + self.k):
                splitters.append(int(tail_kmer))
                emitted.append(int(tail_pos))
            cache.append(self._emission_hits(codes, emitted))
        self._ref_scan_cache = cache
        self._splitter_set = set(splitters)
        self._refresh_splitter_table()
        if self.p.verbosity > 1:
            print(f"No. of splitters: {len(self._splitter_set)}", file=sys.stderr)

    def _pool_emissions(self, contigs: list) -> list:
        """The full k-mer pool on the device: one kmer_canon launch over
        all contigs, one sort, one walk_index of the pool and the greedy
        singleton walks of all contigs in one greedy_walk launch. In
        adaptive mode the same sorted pool gives the candidate tables: the
        singleton walk over the whole pool emits what agc_tpu's membership
        walk over the singleton table emits (the two tests differ only in
        the neighbour check, and that table holds each value once). Returns
        per contig (pos, kmers, tail_pos, tail_kmer)."""
        with self.timers.stage("disc_collect"):
            canon, placements = collect_kmers_device_packed(
                contigs, self.k, self.device
            )
        with self.timers.stage("disc_sort"):
            pool = sort_kmers(canon)
        with self.timers.stage("disc_greedy"):
            emissions = find_splitter_emissions_packed(
                canon, placements, self.k, pool, self.p.segment_size
            )
        del canon
        if self.p.adaptive_compression:
            with self.timers.stage("disc_tables"):
                self._set_tables(*candidate_tables(pool))
        return emissions

    def _fallback_discovery(self, contigs: list) -> None:
        """-f discovery over the full pool on the device: one kmer_canon
        launch, one sort, the candidate tables, then per contig the dense
        scan against the singleton table (kmer_dir_rc with its set_table)
        and the host greedy walk that collects the fallback records
        (agc_tpu's _set_candidates + _find_splitters_in_contig path)."""
        with self.timers.stage("disc_collect"):
            canon, _placements = collect_kmers_device_packed(
                contigs, self.k, self.device
            )
        with self.timers.stage("disc_sort"):
            pool = sort_kmers(canon)
            del canon
        with self.timers.stage("disc_tables"):
            singles, dups = candidate_tables(pool)
            del pool
            index = set_table(singles)
        self._set_tables(singles, dups)
        self._walk_candidates(contigs, index)

    def _walk_candidates(self, contigs: list, index) -> None:
        """Splitters and fallback records of every reference contig from
        its dense scan against the singleton table's ``index``
        (``set_table``)."""
        splitters: list[int] = []
        with self.timers.stage("disc_greedy"):
            for codes in contigs:
                found, fallbacks = self._find_splitters_in_contig(codes, index)
                splitters.extend(found)
                self._pending_fallback.extend(fallbacks)
        self._splitter_set = set(splitters)
        self._refresh_splitter_table()
        if self.p.verbosity > 1:
            print(f"No. of splitters: {len(self._splitter_set)}", file=sys.stderr)

    def _determine_splitters_host(self, contigs: list) -> None:
        """Host splitter discovery for -a references over
        ``_POOL_CARD_MAX`` positions (agc_tpu's _determine_splitters_host):
        same singleton + greedy + tail semantics as the device path, over
        ONE flat host pool sorted in place (agc_compressor.cpp:441-490),
        filled and walked by the native library; singleton membership is
        answered by neighbor checks in the sorted pool. The candidate
        tables then go to the device."""
        import ctypes

        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                "the host full-pool route needs the native library "
                "(agc_tpu_torch/native), which failed to build"
            )
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        total = sum(len(c) for c in contigs)
        pool = np.empty(total, dtype=np.uint64)
        fill = 0
        with self.timers.stage("disc_collect"):
            for c in contigs:
                cc = np.ascontiguousarray(c)
                fill += lib.kmer_canon_fill(
                    cc.ctypes.data_as(u8p), len(cc), self.k,
                    pool[fill:].ctypes.data_as(u64p),
                )
        pool = pool[:fill]
        with self.timers.stage("disc_sort"):
            pool.sort()

        with self.timers.stage("disc_tables"):
            if fill:
                first = np.empty(fill, dtype=bool)
                first[0] = True
                np.not_equal(pool[1:], pool[:-1], out=first[1:])
                run_end = np.append(np.nonzero(first)[0][1:], fill)
                single_mask = first.copy()
                single_mask[first] = (run_end - np.nonzero(first)[0]) == 1
                singles = pool[single_mask]
                dups = np.unique(pool[~first])
            else:
                singles = dups = np.empty(0, dtype=np.uint64)
            self._set_tables(
                u64.from_u64(singles, self.device), u64.from_u64(dups, self.device)
            )
            del singles, dups

        seg = self.p.segment_size
        splitters: list[int] = []
        cache = []
        with self.timers.stage("disc_greedy"):
            for contig_codes in contigs:
                n = len(contig_codes)
                if not n or not fill:
                    cache.append({"n": n, "hits": None})
                    continue
                c = np.ascontiguousarray(contig_codes)
                cap = n // max(1, seg) + 8
                while True:
                    out_pos = np.empty(cap, dtype=np.int64)
                    out_kmer = np.empty(cap, dtype=np.uint64)
                    cnt = lib.kmer_discover_splitters(
                        c.ctypes.data_as(u8p), n, self.k,
                        pool.ctypes.data_as(u64p), fill, seg,
                        out_pos.ctypes.data_as(i64p),
                        out_kmer.ctypes.data_as(u64p), cap,
                    )
                    if cnt <= cap:
                        break
                    cap = cnt
                splitters.extend(int(x) for x in out_kmer[:cnt])
                cache.append(self._emission_hits(contig_codes, out_pos[:cnt]))
        self._ref_scan_cache = cache
        self._splitter_set = set(splitters)
        self._refresh_splitter_table()
        if self.p.verbosity > 1:
            print(f"No. of splitters: {len(self._splitter_set)}", file=sys.stderr)

    def _determine_splitters_host_candidates(self, contigs: list) -> None:
        """-f references over ``_POOL_CARD_MAX`` positions (agc_tpu's
        _determine_splitters_host_candidates): host (numpy) candidate
        tables, which then go to the device for the dense scans and the
        fallback-collecting greedy."""
        pools = []
        with self.timers.stage("disc_collect"):
            for codes in contigs:
                canon, valid = canon_kmers_np(codes, self.k)
                pools.append(canon[valid])
        pool = np.concatenate(pools) if pools else np.empty(0, np.uint64)
        del pools
        with self.timers.stage("disc_tables"):
            if len(pool):
                uniqs, counts = np.unique(pool, return_counts=True)
            else:
                uniqs = np.empty(0, np.uint64)
                counts = np.empty(0, np.int64)
            del pool
            singles = u64.from_u64(uniqs[counts == 1], self.device)
            self._set_tables(singles, u64.from_u64(uniqs[counts > 1], self.device))
            del uniqs, counts
            index = set_table(singles)
        self._walk_candidates(contigs, index)

    def _sampled_emissions(self, contigs: list, total: int) -> list:
        """Value-sampled discovery (agc_tpu's _determine_splitters_sampled)
        for references over ``_POOL_DEVICE_MAX`` positions, such as whole
        human assemblies. Pass 1 canonizes each contig in one kmer_canon
        launch and keeps a 1/2^frac_bits value sample of its k-mers per
        CHUNK slice (``sample_kmers``); the samples make the sorted pool.
        Pass 2 builds the pool's walk_index once, then canonizes each
        contig again and walks it whole in one greedy_walk launch over
        that index. Only one contig's codes and the
        packed reference (0.5 byte a base) stay on the device between the
        passes. Returns per contig (pos, kmers, tail_pos, tail_kmer)."""
        frac_bits = 0
        while (total >> frac_bits) > self._POOL_DEVICE_MAX:
            frac_bits += 1
        with self.timers.stage("disc_collect"):
            rows = [
                torch.from_numpy(pack4_np(np.ascontiguousarray(c))).to(self.device)
                if len(c) >= self.k else None
                for c in contigs
            ]
            parts = []
            for row, codes in zip(rows, contigs):
                if row is None:
                    continue
                canon = kmer_canon(row[None, :], self.k)[0]
                parts.extend(sample_kmers(canon, len(codes), self.k, frac_bits))
                del canon
        with self.timers.stage("disc_sort"):
            pool = sort_kmers(
                torch.cat(parts) if parts
                else torch.empty(0, dtype=torch.int64, device=self.device)
            )
            del parts
        emissions = []
        with self.timers.stage("disc_greedy"):
            index = walk_index(pool)  # one index of the pool for every contig's walk
            for row, codes in zip(rows, contigs):
                if row is None:
                    emissions.append((np.empty(0, np.int64), np.empty(0, np.uint64), None, 0))
                    continue
                canon = kmer_canon(row[None, :], self.k)[0]
                emissions.extend(find_splitter_emissions_packed(
                    canon, [(0, len(codes))], self.k, pool, self.p.segment_size, index=index
                ))
                del canon
        return emissions

    def _ensure_splitters(self) -> None:
        if self._pending_reference is not None:
            ref_file = self._pending_reference
            self._pending_reference = None
            with self.timers.stage("splitter_discovery"):
                self.determine_splitters(ref_file)
            if self.p.verbosity > 1:
                print(f"No. of splitters: {len(self._splitter_set)}", file=sys.stderr)

    def add_cmd_line(self, cmd: str) -> None:
        """reference: CAGCCompressor::AddCmdLine (agc_compressor.cpp:2395).
        Persisted only by the v1/v2 collection serializers, like the
        reference (the v3 serializer drops command lines)."""
        fn = getattr(self.collection, "add_cmd_line", None)
        if fn is not None:
            fn(cmd)

    def splitter_set_snapshot(self) -> set:
        self._ensure_splitters()
        return set(self._splitter_set)

    def _refresh_splitter_table(self, new_sorted=None) -> None:
        """Rebuild the sorted splitter table and its device-resident copy
        (uploaded once per change, not per contig). With ``new_sorted``
        the host array is merged incrementally instead of re-sorting the
        whole set (adaptive runs merge at thousands of barriers)."""
        if new_sorted is not None and len(self.splitters):
            self.splitters = np.union1d(self.splitters, new_sorted)
        else:
            self.splitters = np.array(sorted(self._splitter_set), dtype=np.uint64)
        self._splitters_dev = make_scan_table(self.splitters, self.k, self.device)

    def _find_splitters_in_contig(
        self, codes: np.ndarray, index
    ) -> tuple[list[int], list[tuple[int, int, int, bool]]]:
        """Greedy splitter emission with -f fallback-record collection
        over the dense scan of the contig (reference:
        find_splitters_in_contig, agc_compressor.cpp:762-825).

        ``index``: the set_table of the sorted candidate table. Returns (splitters, fallback-records (prev, cur, kmer,
        is_dir))."""
        n = len(codes)
        if n < self.k:
            return [], []
        canon, udir, urc, valid, member = scan_contig(codes, self.k, index, self.device)
        hits = np.flatnonzero(member)
        return greedy_splitter_walk(
            n, self.k, self.p.segment_size, hits, canon[hits],
            (valid, canon, udir, urc, self.fallback_filter),
        )

    # ==================================================================
    # sample ingestion
    # ==================================================================

    def _process_contig_batch(self, items: list[tuple[str, str, np.ndarray]]) -> None:
        """Run one barrier-delimited batch of contigs (concatenated mode)
        through the device scan pipeline: ALL scans of the batch are
        dispatched first (the batcher groups them into multi-row
        dispatches; the table is constant within a barrier), then the
        host matches in order — draining by a fixed depth would force one
        tiny dispatch per contig for small-genome collections."""
        batcher = ScanBatcher(self.k, self._splitters_dev, self.timers)
        tokens = [batcher.add(codes) for _, _, codes in items]
        batcher.flush()
        for (sname, cid, codes), token in zip(items, tokens):
            with self.timers.stage("scan_collect"):
                hits = batcher.collect(token)
            with self.timers.stage("match_contig", len(codes)):
                self._process_contig(sname, cid, codes, hits=hits)

    def _concat_file_begin(self, fname: str) -> None:
        """Hook: a -c create is about to ingest ``fname``'s contigs.
        No-op here; the sharded capture keys its records by file so the
        merge can replay the global -c contig stream (distributed.py)."""

    def _concat_contig_registered(self, fname: str, cid: str) -> None:
        """Hook: a -c create registered contig ``cid`` of ``fname``."""

    def add_sample_files(self, sample_files: list[tuple[str, str]]) -> bool:
        """reference: CAGCCompressor::AddSampleFiles (agc_compressor.cpp:2118).

        Batches are barrier-delimited exactly as in the reference (one
        sample per barrier; in concatenated mode, pack_cardinality contigs
        per barrier) so adaptive splitter merges observe the same schedule.
        """
        if self.p.concatenated_genomes:
            self._ensure_splitters()
            self._ref_codes = None  # reused only by the pipelined path
            batch: list[tuple[str, str, np.ndarray]] = []
            n_in_batch = self.processed_samples % self.p.pack_cardinality
            for _fname, path in sample_files:
                self.collection.reset_prev_sample_name()
                # capture hook (sharded -c): key captured segments by the
                # input file PATH, unique even when two inputs share a
                # basename, so the merge can replay the global contig
                # stream in file order (parallel/distributed.py)
                self._concat_file_begin(path)
                try:
                    contig_iter = list(read_contigs_raw(path))
                except OSError:

                    print(f"Cannot open file: {path}", file=sys.stderr)
                    continue
                for cid, raw in contig_iter:
                    if not self.collection.register_sample_contig("", cid):
                        print(
                            f"Error: Pair sample_name:contig_name {cid}:{cid} "
                            "is already in the archive!",
                            file=sys.stderr,
                        )
                        continue
                    self._concat_contig_registered(path, cid)
                    batch.append(("", cid, preprocess_raw_contig(raw, cid)))
                    n_in_batch += 1
                    if n_in_batch >= self.p.pack_cardinality:
                        self._process_contig_batch(batch)
                        self._synchronize()
                        batch = []
                        n_in_batch = 0
            self._process_contig_batch(batch)
            self._synchronize()
            return True

        # Pipelined path (both adaptive and non-adaptive): scans are
        # dispatched across sample barriers against a SNAPSHOT of the
        # splitter table. In adaptive mode the table grows at barriers;
        # hits against splitters added after a contig's snapshot are
        # recovered by scanning only the small DELTA table at collect time
        # (hit sets are unions over disjoint tables, so the result is
        # byte-identical to the reference's sequential schedule while the
        # expensive full-table scans stay batched and speculative).
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        # producer pool: FASTA read + ASCII->numeric conversion run ahead
        # of matching with a bounded prefetch window (reference: the
        # AddSampleFiles producer thread, agc_compressor.cpp:2160-2251;
        # the native converter releases the GIL, so files genuinely parse
        # in parallel). Started BEFORE splitter discovery so the first
        # samples load while discovery waits on the device.
        def load_file(path):
            if path == (self._pending_reference or self._ref_scan_file):
                # the discovery pass already reads+converts this file;
                # wait for it and reuse its contigs (one core: the
                # duplicate parse would serialize with everything else)
                self._ref_codes_ready.wait()
                out, self._ref_codes = self._ref_codes, None
                if out is not None:
                    return out
            try:
                with self.timers.stage("parse_fasta"):
                    return [
                        (cid, preprocess_raw_contig(raw, cid))
                        for cid, raw in read_contigs_raw(path)
                    ]
            except OSError:
                # unopenable input: warn and skip, like the reference
                # (agc_compressor.cpp:2165-2168)

                print(f"Cannot open file: {path}", file=sys.stderr)
                return []

        window = 3  # samples read ahead
        # byte bound: at assembly-scale samples (500 MB+) a 3-sample
        # window alone held 1.5 GB of codes (round-4 5 Gbase run: 9.6 GB
        # peak vs the reference's 4.3). FASTA file size ≈ bases, so cap
        # the prefetch by on-disk bytes too (always ≥ 1 ahead).
        _WINDOW_BYTES = int(
            os.environ.get("AGC_TPU_PREFETCH_MB", "256")
        ) << 20
        producer_pool = ThreadPoolExecutor(max_workers=window)
        pending: deque = deque()
        next_file = 0

        def top_up():
            nonlocal next_file
            while next_file < len(sample_files) and len(pending) < window:
                sname, path = sample_files[next_file]
                if pending:
                    try:
                        ahead = sum(
                            os.path.getsize(p2)
                            for _, _, _, p2 in pending
                        )
                    except OSError:
                        ahead = 0
                    if ahead >= _WINDOW_BYTES:
                        break
                pending.append(
                    (next_file, sname,
                     producer_pool.submit(load_file, path), path)
                )
                next_file += 1

        top_up()
        self._ensure_splitters()
        batcher = ScanBatcher(self.k, self._splitters_dev, self.timers)
        batcher_base = len(self._splitter_log)

        def gen():
            try:
                while pending:
                    si, sample_name, fut, _path = pending.popleft()
                    with self.timers.stage("wait_parse"):
                        contigs = fut.result()
                    top_up()
                    # collection registration stays on the consumer thread
                    # (deterministic order w.r.t. barriers)
                    self.collection.reset_prev_sample_name()
                    for ci, (cid, codes) in enumerate(contigs):
                        if not self.collection.register_sample_contig(
                            sample_name, cid
                        ):
                            print(
                                f"Error: Pair sample_name:contig_name "
                                f"{sample_name}:{cid} is already in the "
                                "archive!",
                                file=sys.stderr,
                            )
                            continue
                        yield si, sample_name, cid, codes, ci
            finally:
                producer_pool.shutdown(wait=False)

        def cached_hits(si, ci, codes):
            """Precomputed splitter hits for the discovery reference's
            own contigs: every splitter is a reference singleton, so its
            only occurrence is its recorded emission position — the
            membership scan's outcome is known without running it."""
            if (
                self._ref_scan_cache is None
                or sample_files[si][1] != self._ref_scan_file
                or self._splitter_log  # table grew since discovery
            ):
                return None
            if ci >= len(self._ref_scan_cache):
                return None
            ent = self._ref_scan_cache[ci]
            if ent["n"] != len(codes) or ent["hits"] is None:
                return None
            return ent["hits"]

        pipeline: deque = deque()
        prev_si = None

        def attach_delta(entries) -> None:
            """After a merge added splitters: scan all in-flight contigs
            against a table of JUST the new splitters in batched
            dispatches, then refresh the snapshot for future adds. Hit
            sets union over disjoint tables, so results equal the
            sequential schedule at a handful of dispatches per merge
            instead of one per contig."""
            nonlocal batcher, batcher_base
            if len(self._splitter_log) <= batcher_base:
                return
            vals = np.array(
                sorted(set(self._splitter_log[batcher_base:])),
                dtype=np.uint64,
            )
            dbatcher = ScanBatcher(self.k, make_scan_table(vals, self.k, self.device),
                                   self.timers)
            for e in entries:
                e["deltas"].append((dbatcher, dbatcher.add(e["codes"])))
            dbatcher.flush()
            batcher.flush()  # in-flight tokens keep the old table
            batcher = ScanBatcher(self.k, self._splitters_dev, self.timers)
            batcher_base = len(self._splitter_log)

        def drain_one():
            nonlocal prev_si
            e = pipeline.popleft()
            if prev_si is not None and e["si"] != prev_si:
                self._synchronize()
                attach_delta([e, *pipeline])
            prev_si = e["si"]
            with self.timers.stage("scan_collect"):
                hits = e["batcher"].collect(e["token"])
                for db, dt in e["deltas"]:
                    delta = db.collect(dt)
                    # hits only the delta scans found
                    self.timers.count("delta_hits", len(delta[0]))
                    hits = _union_hits(hits, delta)
            with self.timers.stage("match_contig", len(e["codes"])):
                self._process_contig(e["sname"], e["cid"], e["codes"],
                                     hits=hits)

        def oldest_dispatched() -> bool:
            token = pipeline[0]["token"]
            return token["kind"] != "parts" or all(
                "out" in p for p in token["parts"]
            )

        # drain policy: consume an entry once its scan has actually been
        # DISPATCHED (the batcher auto-flushes every 8 Mbase); draining on
        # a fixed count would force one tiny dispatch per contig for
        # small-genome collections (e.g. SARS-CoV-2: one RTT per sample).
        # pipeline_syms caps buffered memory for huge-contig inputs; in
        # adaptive mode it also bounds how much every splitter merge must
        # delta-rescan, so it stays one flush-quantum deep. Non-adaptive
        # runs keep a LOW-water target too: draining all dispatched entries
        # in one burst leaves the device idle while the host works through
        # barriers; holding ~4 flush quanta in flight keeps the next
        # dispatch scanning during the drain.
        pipeline_syms = 0
        _MAX_PIPELINE_SYMS = (
            (8 << 20) if self.p.adaptive_compression else (64 << 20)
        )
        _TARGET_SYMS = 0 if self.p.adaptive_compression else (32 << 20)
        _MIN_DEPTH = 4

        for si, sname, cid, codes, ci in gen():
            hits = cached_hits(si, ci, codes)
            with self.timers.stage("pack_dispatch"):
                token = (
                    {"kind": "precomputed", "hits": hits}
                    if hits is not None
                    else batcher.add(codes)
                )
            pipeline.append(
                {"si": si, "sname": sname, "cid": cid, "codes": codes,
                 "token": token, "batcher": batcher, "deltas": []}
            )
            pipeline_syms += len(codes)
            while pipeline and (
                pipeline_syms > _MAX_PIPELINE_SYMS
                or (
                    pipeline_syms > _TARGET_SYMS
                    and len(pipeline) > _MIN_DEPTH
                    and oldest_dispatched()
                )
            ):
                if not oldest_dispatched():
                    batcher.flush()
                pipeline_syms -= len(pipeline[0]["codes"])
                drain_one()
        batcher.flush()
        while pipeline:
            drain_one()
        if prev_si is not None:
            self._synchronize()
        return True

    def add_sample_file(self, path: str, sample_name: str | None = None) -> bool:
        """One sample file, named from its path unless ``sample_name`` is
        given (agc_tpu's ``Compressor.add_sample_file``)."""
        if sample_name is None:
            sample_name = sample_name_from_path(path)
        return self.add_sample_files([(sample_name, path)])

    def _synchronize(self) -> None:
        """Per-sample barrier: new-splitter merge (adaptive), registration,
        store, metadata batch (reference: worker protocol,
        agc_compressor.cpp:1114-1237)."""
        with self.timers.stage("barrier"):
            if self.p.adaptive_compression:
                self._adaptive_barrier()
            self._register_segments()
            with self.timers.stage("store_segments"):
                self._store_segments(async_ok=True)
            self._merge_fallback_mappings()
            # advance sample counter & flush metadata batch
            if not self.p.concatenated_genomes:
                self.processed_samples += 1
            else:
                self.processed_samples = min(
                    (self.processed_samples // self.p.pack_cardinality + 1)
                    * self.p.pack_cardinality,
                    self.collection.get_no_samples(),
                )
            if (
                self.processed_samples % self.p.pack_cardinality == 0
                and self.archive_version >= 3000
                # skip when this batch is already on disk: the end-of-input
                # sync of a -c create re-enters here with an unchanged,
                # batch-aligned sample count (the reference then writes an
                # empty duplicate batch, agc_compressor.cpp:1153-1154)
                and self.processed_samples > self._batches_stored_end
            ):
                # batch metadata serializes placements: in-flight stores must land
                self._join_pending_store()
                if self._store_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    # the one store worker, as in _store_segments: the
                    # batch queues behind the barriers' jobs, whose groups
                    # fan across _n_threads there (_fans)
                    self._store_pool = ThreadPoolExecutor(max_workers=1)
                self._batches_stored_end = self.processed_samples
                fut = self.collection.store_contig_batch(
                    self.writer,
                    self.processed_samples - self.p.pack_cardinality,
                    self.processed_samples,
                    executor=self._store_pool,
                    evict=True,
                )
                if fut is not None:
                    self._pending_meta.append(fut)
            self.writer.flush_buffers()

    def _adaptive_barrier(self) -> None:
        """Adaptive-mode half of the barrier: merge the pending new
        splitters into the table, then rescan the requeued hard contigs
        against the grown table (reference: new_splitters token,
        agc_compressor.cpp:1187-1237)."""
        self._pending_new_splitters = self._exchange_new_splitters(
            self._pending_new_splitters
        )
        self._merge_new_splitters()
        hard = self._raw_contigs
        self._raw_contigs = []
        if hard:
            # one batched dispatch for all hard-contig rescans (the
            # merged table now includes their new splitters)
            hb = ScanBatcher(self.k, self._splitters_dev, self.timers)
            tokens = [hb.add(codes) for _, _, codes in hard]
            hb.flush()
            for (sample_name, cid, codes), token in zip(hard, tokens):
                self._process_contig(
                    sample_name, cid, codes, hits=hb.collect(token),
                    hard_contig=True,
                )

    def _exchange_new_splitters(self, pending: list[int]) -> list[int]:
        """Hook for distributed shards (parallel/torchdist.py): replace
        the locally discovered pending new splitters with the cross-shard
        union (the analogue of the reference's in-band ``new_splitters``
        token, agc_compressor.cpp:1187-1237). Single host: identity."""
        return pending

    def _merge_new_splitters(self) -> None:
        if not self._pending_new_splitters:
            return
        added = []
        for d in self._pending_new_splitters:
            if d not in self._splitter_set:
                self._splitter_set.add(d)
                self._splitter_log.append(d)
                added.append(d)
        self._pending_new_splitters = []
        if added:
            self._refresh_splitter_table(
                np.array(sorted(set(added)), dtype=np.uint64)
            )

    def _merge_fallback_mappings(self) -> None:
        for prev_sp, cur_sp, kmer, is_dir in self._pending_fallback:
            pair = (prev_sp, cur_sp) if is_dir else (cur_sp, prev_sp)
            lst = self.map_fallback.setdefault(kmer, [])
            if pair not in lst:
                lst.append(pair)
        self._pending_fallback = []

    # ==================================================================
    # contig segmentation
    # ==================================================================

    def _process_contig(
        self, sample_name: str, contig_name: str, codes: np.ndarray, hits,
        hard_contig: bool = False,
    ) -> bool:
        """reference: compress_contig (agc_compressor.cpp:1997-2051).

        ``hits``: the (pos, udir, urc) splitter hits of the contig, from
        the scan pipeline. ``hard_contig``: the adaptive barrier's second
        pass over a contig that had no splitter."""
        n = len(codes)
        old_pb = self.processed_bases
        self.processed_bases += n
        if (
            self.p.verbosity > 0
            and old_pb // 10_000_000 != self.processed_bases // 10_000_000
        ):

            print(
                f"Compressed: {self.processed_bases // 1_000_000} Mb",
                end="\r",
                file=sys.stderr,
            )
        cuts: list[int] = []
        cut_kmers: dict[int, Kmer] = {}
        if n >= self.k and len(self.splitters):
            hits, h_udir, h_urc = hits
            last = None
            for hi, p in enumerate(hits.tolist()):
                if last is not None and p < last + self.k:
                    continue
                cuts.append(p)
                cut_kmers[p] = Kmer(int(h_udir[hi]), int(h_urc[hi]), True)
                last = p

        if (
            self.p.adaptive_compression
            and not hard_contig
            and not cuts
        ):
            # contig has no splitters: discover new ones, retry after merge
            # (reference: agc_compressor.cpp:2040-2047)
            if n >= self.p.segment_size:
                self._find_new_splitters(codes)
            self._raw_contigs.append((sample_name, contig_name, codes))
            return False

        hints = self._device_match_prepass(codes, cuts, cut_kmers)
        # dict hints (below the gate) are ready now; _LazyHints hand out
        # resolve-on-use handles so the prepass job keeps overlapping the
        # walk until its first consumer
        hint_of = hints.ref if isinstance(hints, _LazyHints) else hints.get
        seg_part_no = 0
        split_pos = 0
        split_kmer = EMPTY_KMER
        for seg_ord, p in enumerate(cuts):
            kmer_here = cut_kmers[p]
            segment = codes[split_pos : p + 1]
            extra = self._add_segment(
                sample_name, contig_name, seg_part_no, segment, split_kmer,
                kmer_here, device_hint=hint_of(seg_ord),
            )
            seg_part_no += 1 + extra
            split_pos = p + 1 - self.k
            split_kmer = kmer_here
        if split_pos < n:
            self._add_segment(
                sample_name,
                contig_name,
                seg_part_no,
                codes[split_pos:],
                split_kmer,
                EMPTY_KMER,
                device_hint=hint_of(len(cuts)),
            )
        return True

    # device-match prepass gate: "auto" runs it when a contig's
    # (segment x candidate) symbol volume reaches _DEVICE_MATCH_MIN_SYMS,
    # "1" forces it, "0" disables it (agc_tpu's gate, unchanged)
    _DEVICE_MATCH_MIN_SYMS = int(
        os.environ.get("AGC_TPU_MATCH_MIN_SYMS", str(24 << 20))
    )

    def _ref_codes_of(self, gid: int) -> bytes | None:
        """Numeric reference codes of group ``gid`` for the match banks;
        None for raw/packed/unstored groups (those estimate as 0, the host
        parity: CSegment::estimate, segment.cpp:83-85)."""
        seg = self.v_segments[gid]
        if seg is None or seg.get_ref_size() == 0:
            return None
        return seg.ref_bytes_for_index()

    def _device_match_prepass(self, codes, cuts, cut_kmers):
        """Batched device estimates of every one-splitter candidate search
        in this contig (ops/match.py): one batch ranks all (segment,
        candidate) pairs; the host then exact-estimates only each
        segment's shortlist. Returns {segment-ordinal: (candidates,
        allowed-indices)}, or _LazyHints over a job on the match worker.

        Candidate sets depend only on ``terminators`` and group
        references, which are stable between barriers, so ranking every
        segment of the contig up front equals ranking them one by one
        (reference schedule: find_cand_segment_with_one_splitter per
        segment, agc_compressor.cpp:1630-1808)."""
        mode = os.environ.get("AGC_TPU_DEVICE_MATCH", "auto")
        if mode == "0" or not cuts:
            return {}
        queries = []  # (seg_ord, candidates, MatchQuery)
        total_pair_syms = 0
        n = len(codes)
        bounds = list(cuts) + ([n - 1] if (len(cuts) and cuts[-1] + 1 - self.k < n) else [])
        split_pos = 0
        split_kmer = EMPTY_KMER
        for seg_ord, p in enumerate(bounds):
            is_tail = seg_ord == len(cuts)
            kmer_here = EMPTY_KMER if is_tail else cut_kmers[p]
            seg_slice = codes[split_pos : n if is_tail else p + 1]
            front, back = split_kmer, kmer_here
            if not is_tail:
                split_pos = p + 1 - self.k
                split_kmer = kmer_here
            if front.full == back.full:
                continue  # both or neither: no one-splitter search
            if len(seg_slice) > (4 << 20):
                continue  # outlier segment: host path
            role_swapped = not front.full  # back-only: dir role is RC
            kmer = back.swapped() if role_swapped else front
            cands = self._one_splitter_cands(kmer, len(seg_slice))
            if not cands or len(cands) < 2:
                continue  # 0/1 candidates: nothing for a ranker to prune
            mq = _match.MatchQuery(
                seg_slice,
                [(self.map_segments[(c0, c1)], is_rc != role_swapped)
                 for c0, c1, is_rc in cands],
            )
            queries.append((seg_ord, cands, mq))
            total_pair_syms += len(seg_slice) * len(cands)
        if not queries:
            return {}
        if mode != "1" and total_pair_syms < self._DEVICE_MATCH_MIN_SYMS:
            # below the gate: hand the candidate lists down with every
            # index allowed, so _find_cand_one_splitter need not redo them
            return {
                seg_ord: (cands, list(range(len(cands))))
                for seg_ord, cands, _mq in queries
            }
        if self._match_bank is None:
            self._match_bank = _match.RefBank(self.p.min_match_len - 3, device=self.device)
        if self._match_pool is None:
            self._match_pool = DaemonPool(1, "agc-match")

        def run_estimates():
            # on the match worker: the device work and its download
            # overlap the host's walk over the contig's earlier segments
            with self.timers.stage("device_match", total_pair_syms):
                _match.estimate_batch(
                    [mq for _, _, mq in queries], self._match_bank, self._ref_codes_of,
                )
                margin = float(os.environ.get("AGC_TPU_MATCH_MARGIN", "0.15"))
                out = {}
                for seg_ord, cands, mq in queries:
                    out[seg_ord] = (cands, _match.shortlist(mq.ests, margin=margin, extra=1))
            return out

        return _LazyHints(
            self._match_pool.submit(run_estimates),
            (seg_ord for seg_ord, _, _ in queries),
            self.timers,
        )

    # below this size the whole new-splitter search runs on the host: a
    # 30 kb genome costs microseconds in numpy vs several device launches
    _HOST_NEW_SPLITTERS_MAX = 1 << 20

    def _find_new_splitters(self, codes: np.ndarray) -> None:
        """reference: find_new_splitters (agc_compressor.cpp:2054-2082).

        Over ``_HOST_NEW_SPLITTERS_MAX`` positions (and always under -f)
        on the device: one kmer_canon launch and a sort give the contig's
        singletons (``singleton_filter``); the reference's singletons and
        duplicates go by ``searchsorted`` against the candidate tables;
        one greedy_walk launch over the walk_index of what is left (a
        table that holds each value once, so the singleton walk is the
        membership walk of agc_tpu's find_splitter_emissions); under -f,
        the dense scan against its set_table."""
        if (
            len(codes) <= self._HOST_NEW_SPLITTERS_MAX
            and not self.fallback_filter
        ):
            self._find_new_splitters_host(codes)
            return
        n = len(codes)
        if n < self.k:
            return
        canon = contig_canon(codes, self.k, self.device)
        kmers = canon[canon != u64.SENTINEL]
        if not kmers.numel():
            return
        sorted_k = sort_kmers(kmers)
        single, _ = singleton_filter(sorted_k)
        uniq = sorted_k[single]
        del kmers, sorted_k, single
        # exclude reference singletons and duplicated k-mers
        uniq = uniq[~isin_sorted(uniq, self.cand_singletons)]
        uniq = uniq[~isin_sorted(uniq, self.cand_duplicated)]
        if not uniq.numel():
            return
        if not self.fallback_filter:
            (pos, kmers, tail_pos, tail_kmer), = find_splitter_emissions_packed(
                canon, [(0, n)], self.k, uniq, self.p.segment_size, index=walk_index(uniq)
            )
            self._pending_new_splitters.extend(int(x) for x in kmers)
            last = int(pos[-1]) if len(pos) else None
            if tail_pos is not None and (last is None or tail_pos >= last + self.k):
                self._pending_new_splitters.append(int(tail_kmer))
        else:
            found, fallbacks = self._find_splitters_in_contig(codes, set_table(uniq))
            self._pending_new_splitters.extend(found)
            self._pending_fallback.extend(fallbacks)

    def _find_new_splitters_host(self, codes: np.ndarray) -> None:
        """Host path of _find_new_splitters, numerically identical to the
        device walk (same singleton/exclusion/emission/tail rules); the
        exclusion looks the contig's singletons up in the device tables."""
        canon, valid = canon_kmers_np(codes, self.k)
        vals = canon[valid]
        if not len(vals):
            return
        uniqs, counts = np.unique(vals, return_counts=True)
        uniq = uniqs[counts == 1]
        cand = u64.from_u64(uniq, self.device)
        keep = ~isin_sorted(cand, self.cand_singletons) & ~isin_sorted(
            cand, self.cand_duplicated
        )
        uniq = uniq[keep.cpu().numpy()]
        if not len(uniq):
            return
        ix = np.searchsorted(uniq, canon)
        member = valid & (uniq[np.minimum(ix, uniq.size - 1)] == canon)
        hits = np.flatnonzero(member)
        seg = self.p.segment_size
        last = None
        for p in hits.tolist():
            if last is not None and (p - last) < seg:
                continue
            self._pending_new_splitters.append(int(canon[p]))
            last = p
        floor = (last + self.k) if last is not None else 0
        tail = hits[hits >= floor]
        if len(tail):
            self._pending_new_splitters.append(int(canon[tail[-1]]))

    # ==================================================================
    # segment -> group matching (reference: add_segment, 1275-1499)
    # ==================================================================

    def _add_segment(
        self,
        sample: str,
        contig: str,
        part_no: int,
        segment: np.ndarray,
        kmer_front: Kmer,
        kmer_back: Kmer,
        device_hint: tuple[list, list[int]] | None = None,
        delta_hint: tuple | None = None,
    ) -> int:
        """Returns 1 when the segment was split into two parts, else 0.
        ``device_hint``: this segment's result of the estimate prepass.

        ``delta_hint``: (pk, delta_bytes, ref_hash) shipped by a shard
        (sharded create): the LZ delta of this segment against the
        boot-broadcast reference of group ``pk``. Attached to the
        pending segment only when the matcher's final pk equals the
        hint's; the store verifies the group reference hash before
        using the bytes, so a stale hint can never change the archive."""
        pk = PK_EMPTY
        store_rc = False
        segment_rc: np.ndarray | None = None
        segment2 = None
        segment2_rc = None
        store2_rc = False
        segment_id = -1
        segment_id2 = -1

        if not kmer_front.full and not kmer_back.full:
            # no splitter on either side: a raw group unless -f finds one
            if self.fallback_filter:
                pk, store_rc = self._find_cand_fallback(segment, 1)
                if pk != PK_EMPTY and store_rc:
                    segment_rc = _rc_numeric(segment)
        elif kmer_front.full and kmer_back.full:
            if kmer_front.data() < kmer_back.data():
                pk = (kmer_front.data(), kmer_back.data())
            else:
                # RC + byte conversion deferred to the store worker
                # (_PendingSeg.materialize); the matcher never reads them
                pk = (kmer_back.data(), kmer_front.data())
                store_rc = True
        elif kmer_front.full:
            segment_rc = _rc_numeric(segment)
            pk, store_rc = self._find_cand_one_splitter(
                kmer_front, segment, segment_rc, device_hint=device_hint
            )
            if (pk[0] == EMPTY or pk[1] == EMPTY) and self.fallback_filter:
                pk_alt, rc_alt = self._find_cand_fallback(segment, 5)
                if pk_alt != PK_EMPTY:
                    pk, store_rc = pk_alt, rc_alt
        else:  # kmer_back only
            kmer = kmer_back.swapped()
            segment_rc = _rc_numeric(segment)
            pk, store_dir = self._find_cand_one_splitter(
                kmer, segment_rc, segment, device_hint=device_hint
            )
            store_rc = not store_dir
            if (pk[0] == EMPTY or pk[1] == EMPTY) and self.fallback_filter:
                pk_alt, dir_alt = self._find_cand_fallback(segment_rc, 5)
                if pk_alt != PK_EMPTY:
                    pk, store_rc = pk_alt, not dir_alt

        found = pk in self.map_segments

        # missing-middle split (reference: 1419-1496)
        if (
            not self.p.concatenated_genomes
            and not found
            and pk[0] != EMPTY
            and pk[1] != EMPTY
            and pk[0] in self.terminators
            and pk[1] in self.terminators
        ):
            if segment_rc is None:
                segment_rc = _rc_numeric(segment)
            if kmer_front.data() == kmer_back.data():
                if not kmer_front.is_dir_oriented():
                    store_rc = True
            else:
                kmer1, kmer2 = kmer_front, kmer_back
                use_rc = False
                if kmer1.data() > kmer2.data():
                    kmer1, kmer2 = kmer2.swapped(), kmer1.swapped()
                    use_rc = True
                middle, best_pos = self._find_missing_middle(
                    kmer1,
                    kmer2,
                    segment_rc if use_rc else segment,
                    segment if use_rc else segment_rc,
                )
                if middle != EMPTY:
                    left_size = best_pos
                    right_size = len(segment) - best_pos
                    if left_size == 0:
                        store_rc = use_rc if middle < kmer2.data() else not use_rc
                        pk = (min(middle, kmer2.data()), max(middle, kmer2.data()))
                    elif right_size == 0:
                        store_rc = use_rc if kmer1.data() < middle else not use_rc
                        pk = (min(kmer1.data(), middle), max(kmer1.data(), middle))
                    else:
                        if use_rc:
                            left_size, right_size = right_size, left_size
                        seg2_start = left_size - self.k // 2
                        segment2 = segment[seg2_start:]
                        segment = segment[: seg2_start + self.k]
                        if kmer_front.data() < middle:
                            store_rc = False
                            pk = (kmer_front.data(), middle)
                        else:
                            store_rc = True
                            segment_rc = _rc_numeric(segment)
                            pk = (middle, kmer_front.data())
                        segment_id = self.map_segments[pk]
                        if middle < kmer_back.data():
                            store2_rc = False
                            pk2 = (middle, kmer_back.data())
                        else:
                            store2_rc = True
                            segment2_rc = _rc_numeric(segment2)
                            pk2 = (kmer_back.data(), middle)
                        segment_id2 = self.map_segments[pk2]
            found = pk in self.map_segments

        if not found and self.fallback_filter:
            pk_fb, rc_fb = self._find_cand_fallback(segment, 2)
            if pk_fb != PK_EMPTY:
                pk, store_rc = pk_fb, rc_fb
                found = pk in self.map_segments
                if store_rc:
                    segment_rc = _rc_numeric(segment)

        def _bytes(arr):
            return arr.astype(np.uint8, copy=False).tobytes()

        def pending(part):
            hint = (
                delta_hint[1:]
                if delta_hint is not None and delta_hint[0] == pk
                else None
            )
            rb_hint = self._inv_ref_blobs.get(pk)
            if store_rc and segment_rc is None:
                return _PendingSeg(
                    sample, contig, part, None, store_rc, raw=segment,
                    delta_hint=hint, ref_blob_hint=rb_hint,
                )
            return _PendingSeg(
                sample, contig, part,
                _bytes(segment_rc if store_rc else segment), store_rc,
                delta_hint=hint, ref_blob_hint=rb_hint,
            )

        if not found:
            self._buf_new.append((pk[0], pk[1], pending(part_no)))
            return 0

        if segment_id2 == -1:
            segment_id = self.map_segments[pk]
        self._buf_known.setdefault(segment_id, []).append(pending(part_no))
        if segment_id2 >= 0:
            data2 = _bytes(segment2_rc if store2_rc else segment2)
            self._buf_known.setdefault(segment_id2, []).append(
                _PendingSeg(sample, contig, part_no + 1, data2, store2_rc)
            )
            return 1
        return 0

    # ------------------------------------------------------------------

    def _one_splitter_cands(
        self, kmer: Kmer, seg_size: int
    ) -> list[tuple[int, int, bool]] | None:
        """Ordered candidate (k1, k2, is_rc) triples for a one-splitter
        search: terminator neighbors ranked by ref-size proximity
        (reference: find_cand_segment_with_one_splitter, 1630-1718).
        None when the splitter has no terminators (one-sided group)."""
        d = kmer.data()
        terms = self.terminators.get(d)
        if not terms:
            return None
        candidates = []
        for cand in terms:
            if cand < d:
                candidates.append((cand, d, True))
            else:
                candidates.append((d, cand, False))
        self._ensure_groups_ready(
            self.map_segments[(c0, c1)] for c0, c1, _ in candidates
        )
        ref_sizes = {}
        for c0, c1, is_rc in candidates:
            gid = self.map_segments[(c0, c1)]
            ref_sizes[(c0, c1)] = self.v_segments[gid].get_ref_size()
        candidates.sort(
            key=lambda c: (abs(seg_size - ref_sizes[(c[0], c[1])]), ref_sizes[(c[0], c[1])])
        )
        return candidates

    def _find_cand_one_splitter(
        self,
        kmer: Kmer,
        segment_dir: np.ndarray,
        segment_rc: np.ndarray,
        device_hint: tuple[list, list[int]] | None = None,
    ) -> tuple[tuple[int, int], bool]:
        """reference: find_cand_segment_with_one_splitter (1630-1808).

        ``device_hint``: (candidates, allowed-indices) from the estimate
        prepass: the host exact-estimates only the device shortlist. A
        _LazyHint resolves HERE, its first real consumer."""
        if isinstance(device_hint, _LazyHint):
            device_hint = device_hint.resolve()
        d = kmer.data()

        def one_sided():
            if kmer.is_dir_oriented():
                return (d, EMPTY), False
            return (EMPTY, d), True

        seg_size = len(segment_dir)
        if device_hint is not None:
            candidates = [device_hint[0][i] for i in device_hint[1]]
        else:
            candidates = self._one_splitter_cands(kmer, seg_size)
        if not candidates:
            return one_sided()

        best_pk = PK_EMPTY
        best_est = seg_size if seg_size < 16 else seg_size - 16
        best_rc = False
        seg_dir_b = segment_dir.astype(np.uint8, copy=False).tobytes()
        seg_rc_b = segment_rc.astype(np.uint8, copy=False).tobytes()

        if len(candidates) > 2 and self._n_threads > 1:
            # parallel estimation with a shared shrinking bound -- the
            # analogue of the reference's incrementing-barrier thread
            # lending (agc_compressor.cpp:1719-1778); the native estimator
            # releases the GIL
            from concurrent.futures import ThreadPoolExecutor

            bound = [best_est]
            bound_lock = threading.Lock()

            def est_one(cand):
                c0, c1, is_rc = cand
                gid = self.map_segments[(c0, c1)]
                e = self.v_segments[gid].estimate(
                    seg_rc_b if is_rc else seg_dir_b, bound[0]
                )
                # min under a lock: an unguarded check-then-set could
                # overwrite a tighter bound with a staler, looser one
                # (selection stays correct either way, but later
                # estimates would prune less)
                with bound_lock:
                    if e < bound[0]:
                        bound[0] = e
                return e

            with ThreadPoolExecutor(
                max_workers=min(self._n_threads, len(candidates))
            ) as pool:
                ests = list(pool.map(est_one, candidates))
        else:
            ests = []
            for c0, c1, is_rc in candidates:
                gid = self.map_segments[(c0, c1)]
                ests.append(
                    self.v_segments[gid].estimate(
                        seg_rc_b if is_rc else seg_dir_b, best_est
                    )
                )
                if ests[-1] < best_est:
                    best_est = ests[-1]

        best_est = seg_size if seg_size < 16 else seg_size - 16
        for (c0, c1, is_rc), est in zip(candidates, ests):
            cand_pk = (c0, c1)
            if (
                est < best_est
                or (est == best_est and cand_pk < best_pk)
                or (est == best_est and cand_pk == best_pk and not is_rc)
            ):
                best_est = est
                best_pk = cand_pk
                best_rc = is_rc
        if best_pk == PK_EMPTY:
            return one_sided()
        return best_pk, best_rc

    def _find_missing_middle(
        self, kmer1: Kmer, kmer2: Kmer, segment_dir: np.ndarray, segment_rc: np.ndarray
    ) -> tuple[int, int]:
        """reference: find_cand_segment_with_missing_middle_splitter (1502-1627)."""
        t1 = self.terminators.get(kmer1.data())
        t2 = self.terminators.get(kmer2.data())
        if not t1 or not t2:
            return EMPTY, 0
        shared = sorted((set(t1) & set(t2)) - {EMPTY})
        if not shared:
            return EMPTY, 0
        middle = shared[0]
        gid1 = self.map_segments[
            (min(kmer1.data(), middle), max(kmer1.data(), middle))
        ]
        gid2 = self.map_segments[
            (min(middle, kmer2.data()), max(middle, kmer2.data()))
        ]
        self._ensure_groups_ready((gid1, gid2))
        seg1 = self.v_segments[gid1]
        seg2 = self.v_segments[gid2]
        n = len(segment_dir)
        if n == 0:
            return EMPTY, 0
        # byte views built lazily: each walk reads ONE orientation, so
        # eagerly rendering both wastes a full-segment copy per call
        _views: dict[bool, bytes] = {}

        def bview(rc: bool) -> bytes:
            v = _views.get(rc)
            if v is None:
                src = segment_rc if rc else segment_dir
                v = _views[rc] = src.astype(np.uint8, copy=False).tobytes()
            return v

        # reference parity: groups still PACKED from appending_init report
        # ref_size 0 and contribute no cost vector (segment.cpp:103); one
        # packed side ⇒ length mismatch ⇒ no middle (agc_compressor.cpp:
        # 1605-1608), both packed ⇒ empty sums ⇒ split position 0
        e1 = seg1.get_ref_size() == 0
        e2 = seg2.get_ref_size() == 0
        if e1 or e2:
            return (middle, 0) if (e1 and e2) else (EMPTY, 0)

        # The device split search RETURNS the decision: its coverage-model
        # argmin replaces the host's exact cost walk and can move the
        # split point. AGC_TPU_DEVICE_MATCH=1 forces it; under auto it
        # also needs AGC_TPU_DEVICE_SPLIT=1 (agc_tpu's gate).
        mode = os.environ.get("AGC_TPU_DEVICE_MATCH", "auto")
        split_opt_in = os.environ.get("AGC_TPU_DEVICE_SPLIT", "0") == "1"
        if mode != "0" and (
            mode == "1"
            or (split_opt_in and n * 2 >= self._DEVICE_MATCH_MIN_SYMS)
        ):
            if self._match_bank is None:
                self._match_bank = _match.RefBank(self.p.min_match_len - 3, device=self.device)
            with self.timers.stage("device_match", 2 * n):
                pos = _match.split_point_device(
                    segment_dir, self._match_bank,
                    gid1, not (kmer1.data() < middle),
                    gid2, not (middle < kmer2.data()),
                    self._ref_codes_of,
                )
            if pos is not None:
                best_pos = pos
                if best_pos < self.k + 1:
                    best_pos = 0
                if best_pos + self.k + 1 > n:
                    best_pos = n
                return middle, best_pos

        seg1.ensure_ref()
        seg2.ensure_ref()
        lz1, lz2 = seg1.lz, seg2.lz
        if lz1._ctx is not None and lz2._ctx is not None:
            # fused native path: both cost walks + cumulative sums +
            # argmin in one GIL-free call (no intermediate vectors)
            seg1._ensure_unpacked()
            seg2._ensure_unpacked()
            if kmer1.data() < middle:
                t1, pc1, rev1 = bview(False), 1, 0
            else:
                t1, pc1, rev1 = bview(True), 0, 1
            if middle < kmer2.data():
                t2, mode2 = bview(False), 0
            else:
                t2, mode2 = bview(True), 1
            best_pos = int(
                lz1._lib.lz_split_point(
                    lz1._ctx, t1, pc1, rev1, lz2._ctx, t2, mode2, n
                )
            )
        else:
            if kmer1.data() < middle:
                v1 = seg1.get_coding_cost(bview(False), True)
            else:
                v1 = seg1.get_coding_cost(bview(True), False)[::-1]
            v1 = np.cumsum(v1.astype(np.int64))

            if middle < kmer2.data():
                v2 = seg2.get_coding_cost(bview(False), False).astype(np.int64)
                v2 = np.cumsum(v2[::-1])[::-1]
            else:
                v2 = seg2.get_coding_cost(bview(True), True).astype(np.int64)
                v2 = np.cumsum(v2)[::-1]

            if len(v1) != len(v2):
                return EMPTY, 0
            sums = v1 + v2
            best_pos = int(np.argmin(sums))
        if best_pos < self.k + 1:
            best_pos = 0
        if best_pos + self.k + 1 > n:
            best_pos = n
        return middle, best_pos


    def _find_cand_fallback(
        self, segment: np.ndarray, max_val: int
    ) -> tuple[tuple[int, int], bool]:
        """reference: find_cand_segment_using_fallback_minimizers
        (agc_compressor.cpp:1812-1963). The segment's k-mers come from one
        kmer_dir_rc launch (the dense scan without a set); a heavy
        estimate sweep is ranked on the device first (the shortlist)."""
        max_num_to_estimate = 10
        short_segments = self.p.segment_size <= 10000
        if len(segment) < self.k or not self.map_fallback:
            return PK_EMPTY, False
        canon, udir, urc, valid, _ = scan_contig(segment, self.k, None, self.device)
        cand_counts: dict[tuple[int, int], set[int]] = {}
        for p in np.flatnonzero(valid).tolist():
            d = int(canon[p])
            if not self.fallback_filter(d):
                continue
            lst = self.map_fallback.get(d)
            if not lst:
                continue
            is_dir = bool(udir[p] <= urc[p])
            for y0, y1 in lst:
                if y0 == EMPTY or y1 == EMPTY:
                    continue
                pair = (y0, y1) if is_dir else (y1, y0)
                cand_counts.setdefault(pair, set()).add(d)
        pruned = [
            (len(v), pair) for pair, v in cand_counts.items() if len(v) >= max_val
        ]
        if not pruned:
            return PK_EMPTY, False
        pruned.sort(key=lambda x: (-x[0], tuple(-p for p in x[1])))
        pruned = pruned[:max_num_to_estimate]
        while pruned and pruned[-1][0] * 2 < pruned[0][0]:
            pruned.pop()

        # device shortlist of the estimate sweep (ops/match.py): one batch
        # ranks the surviving candidate groups, the host exact-estimates
        # the shortlist. Only for heavy sweeps (segment x candidates);
        # short_segments never estimates, so it stays on the host.
        mode = os.environ.get("AGC_TPU_DEVICE_MATCH", "auto")
        if (
            mode != "0"
            and not short_segments
            and len(pruned) >= 2
            and (
                mode == "1"
                or len(segment) * len(pruned) >= self._DEVICE_MATCH_MIN_SYMS
            )
        ):
            dev_cands = []
            dev_idx = []
            for i, (_cnt, pair) in enumerate(pruned):
                is_seg_rc = pair[0] > pair[1]
                key = (pair[1], pair[0]) if is_seg_rc else pair
                gid = self.map_segments.get(key)
                if gid is not None:
                    dev_cands.append((gid, is_seg_rc))
                    dev_idx.append(i)
            if len(dev_cands) >= 2:
                if self._match_bank is None:
                    self._match_bank = _match.RefBank(
                        self.p.min_match_len - 3, device=self.device)
                mq = _match.MatchQuery(segment, dev_cands)
                with self.timers.stage("device_match", len(segment) * len(dev_cands)):
                    _match.estimate_batch([mq], self._match_bank, self._ref_codes_of)
                margin = float(os.environ.get("AGC_TPU_MATCH_MARGIN", "0.15"))
                keep = {
                    dev_idx[j]
                    for j in _match.shortlist(mq.ests, margin=margin, extra=1)
                }
                pruned = [
                    e for i, e in enumerate(pruned)
                    if i in keep or i not in dev_idx
                ]

        seg_b = segment.astype(np.uint8, copy=False).tobytes()
        _rc_cache: list[bytes | None] = [None]

        def _seg_rc_b() -> bytes:
            # lazy: only RC-oriented candidates pay the full-segment RC
            # pass + copy (and the short-segment early path pays nothing)
            if _rc_cache[0] is None:
                _rc_cache[0] = (
                    _rc_numeric(segment).astype(np.uint8, copy=False).tobytes()
                )
            return _rc_cache[0]
        self._ensure_groups_ready(
            gid
            for gid in (
                self.map_segments.get(
                    (p[1], p[0]) if p[0] > p[1] else p
                )
                for _, p in pruned
            )
            if gid is not None
        )
        best_pair = PK_EMPTY
        best_es = len(segment)
        scored = []  # (es, members, pair) for the near-tie re-rank below
        for cnt, pair in pruned:
            is_seg_rc = pair[0] > pair[1]
            key = (pair[1], pair[0]) if is_seg_rc else pair
            gid = self.map_segments.get(key)
            es = 0
            if gid is not None:
                if short_segments:
                    best_pair = pair
                    best_es = 0
                    break
                bound = best_es
                es = self.v_segments[gid].estimate(
                    _seg_rc_b() if is_seg_rc else seg_b, bound
                )
                if es:
                    # es > bound means the estimate early-exited at the
                    # pruning bound (lz.py Estimate) — the TRUE cost may be
                    # far larger, so flag it untrusted for the re-rank
                    scored.append(
                        (es, self.v_segments[gid].no_seqs, pair,
                         es <= bound, gid, is_seg_rc)
                    )
            if es and es < best_es:
                best_es = es
                best_pair = pair
        if (
            best_pair != PK_EMPTY
            and best_es
            and len(scored) > 1
        ):
            window = 1.01  # agc_tpu's default tie window, always re-ranked
            # a bound-truncated estimate just above best_es is
            # indistinguishable from a genuine near-tie; re-estimate those
            # few with a bound wide enough to certify window membership
            limit = int(best_es * window) + 1
            certified = []
            for es, members, pair, trusted, gid, is_seg_rc in scored:
                if not trusted and es <= limit:
                    es = self.v_segments[gid].estimate(
                        _seg_rc_b() if is_seg_rc else seg_b, limit
                    )
                    if not es:
                        continue
                certified.append((es, members, pair))
            best_es, _, best_pair = rerank_near_ties(certified, window)
        if self.p.adaptive_compression:
            if short_segments:
                if best_es >= len(segment) * 0.9:
                    return PK_EMPTY, False
            else:
                if best_es >= len(segment) * 0.2:
                    return PK_EMPTY, False
        if best_pair == PK_EMPTY:
            return PK_EMPTY, False
        if best_pair[0] <= best_pair[1]:
            return best_pair, False
        return (best_pair[1], best_pair[0]), True

    # ==================================================================
    # registration + storage (reference: register_segments/store_segments)
    # ==================================================================

    def _register_segments(self) -> None:
        """Assign ids to new groups (deterministic by splitter pair) and
        merge into the known buffers (reference: process_new,
        agc_compressor.h:384-415).

        Does NOT join in-flight stores: new groups get fresh ids, members
        for existing groups queue behind earlier store jobs on the single
        FIFO worker, and placements are applied at the next join point
        (metadata batch / estimate-readiness / close) — so barrier stores
        pipeline across samples instead of serializing each barrier."""
        if self._buf_new:
            new_pks = sorted({(k1, k2) for k1, k2, _ in self._buf_new})
            assigned: dict[tuple[int, int], int] = {}
            for pk in new_pks:
                gid = self.no_segments
                self.no_segments += 1
                assigned[pk] = gid
                self.writer.register_stream(ss_ref_name(self.archive_version, gid))
                self.writer.register_stream(ss_delta_name(self.archive_version, gid))
                self.v_segments.append(None)
                prev = self.map_segments.get(pk)
                if prev is None or prev > gid:
                    self.map_segments[pk] = gid
                k1, k2 = pk
                if k1 != EMPTY and k2 != EMPTY:
                    lst = self.terminators.setdefault(k1, [])
                    lst.append(k2)
                    lst.sort()
                    if k1 != k2:
                        lst = self.terminators.setdefault(k2, [])
                        lst.append(k1)
                        lst.sort()
            for k1, k2, pend in self._buf_new:
                self._buf_known.setdefault(assigned[(k1, k2)], []).append(pend)
            self._buf_new = []

        # round-robin redistribution of raw group 0 (reference:
        # distribute_segments, agc_compressor.h:417-435)
        raw0 = self._buf_known.get(0)
        if raw0:
            raw0.sort(key=lambda s: (s.sample, s.contig, s.part_no))
            keep = []
            dest = 0
            for item in raw0:
                if dest != 0:
                    self._buf_known.setdefault(dest, []).append(item)
                else:
                    keep.append(item)
                dest = (dest + 1) % NO_RAW_GROUPS
            self._buf_known[0] = keep

    def _join_pending_store(self) -> None:
        """Wait for ALL in-flight barrier stores and apply their
        placements to the collection (in submission order)."""
        if not self._pending_store:
            return
        futures = self._pending_store
        self._pending_store = None
        for fut in futures:
            with self.timers.stage("wait_store"):
                placed = fut.result()
            for args in placed:
                self.collection.add_segment_placed(*args)

    def _join_oldest_store(self) -> None:
        """Backpressure: land the oldest in-flight store."""
        if not self._pending_store:
            return
        fut = self._pending_store.pop(0)
        if not self._pending_store:
            self._pending_store = None
        with self.timers.stage("wait_store"):
            placed = fut.result()
        for args in placed:
            self.collection.add_segment_placed(*args)

    def _ensure_groups_ready(self, gids) -> None:
        """Fine-grained store join: estimates only read a group's
        REFERENCE (member 0) and its match index — both immutable once
        set — so the pending store must be joined only when a needed
        group's reference is not there yet (i.e. the group was created at
        the immediately-preceding barrier). The C++ index build is
        mutex-guarded, so concurrent estimate/encode on a ready group is
        safe. Append mode keeps the blanket join (writers rehydrate
        lazily there)."""
        if self._pending_store is None:
            return
        if self._mode == "append":
            self._join_pending_store()
            return
        for gid in gids:
            seg = self.v_segments[gid]
            if seg is None or seg.ref_size == 0:
                self._join_pending_store()
                return

    def _store_segments(self, async_ok: bool = False) -> None:
        """Drain the per-group buffers: LZ-encode + store members, record
        placements (reference: store_segments, agc_compressor.cpp:974-1050).

        Groups are independent, so they are encoded on a worker pool; the
        native LZ and zstd calls release the GIL. With ``async_ok`` the
        jobs run PAST the barrier, overlapping the
        next sample's device scans; they are joined before anything reads
        the group writers again (_register_segments / first _add_segment /
        metadata batches / close). Placements are applied serially (the
        collection registry is not concurrent)."""
        buf = self._buf_known
        self._buf_known = {}
        groups = sorted(buf)

        def anchor_prepass():
            """Device leg of the anchor LZ mode: batched dispatches give
            every member's anchor diagonal set against its group's
            reference; store_group's adds then tile and emit tokens on the
            host (lz_encode_anchored). Bytes are the same with or without
            this prepass: it is an engine choice."""
            if self._lz_mode() != "anchor" or not self._device_lz_enabled():
                return
            pairs = []
            for gid in groups:
                if gid < NO_RAW_GROUPS:
                    continue
                seg = self.v_segments[gid]
                if seg is None:
                    continue  # the sync path creates writers lazily
                items = buf[gid]
                items.sort(key=lambda s: (s.sample, s.contig, s.part_no))
                start = 1 if seg.no_seqs == 0 else 0
                for it in items[start:]:
                    pairs.append((gid, it))
            if not pairs:
                return
            if self._anchor_bank is None:
                self._anchor_bank = _match.AnchorCodeBank(self.device)
            with self.timers.stage("device_lz_tables"):
                tabs = _match.anchor_diag_sets(
                    [it.materialize() for _, it in pairs],
                    [gid for gid, _ in pairs],
                    self._anchor_bank,
                    self._ref_codes_of,
                    self.p.min_match_len - 3,
                )
                for (_gid, it), tab in zip(pairs, tabs):
                    it.anchor_tab = tab

        def store_group(gid):
            items = buf[gid]
            items.sort(key=lambda s: (s.sample, s.contig, s.part_no))
            seg = self.v_segments[gid]
            if seg is None:
                seg = self._make_writer(gid)
                self.v_segments[gid] = seg
            placements = []
            # timed with add(), not stage(): a span a group costs the
            # encode pool ~15 us of the interpreter lock each, thousands
            # a create, while a profiler runs
            t0 = time.perf_counter()
            for it in items:
                data = it.materialize()
                if gid < NO_RAW_GROUPS:
                    in_group_id = seg.add_raw(data)
                else:
                    in_group_id = seg.add(
                        data, anchor_tab=it.anchor_tab,
                        delta_hint=it.delta_hint,
                        ref_blob_hint=it.ref_blob_hint,
                    )
                placements.append(
                    (it.sample, it.contig, it.part_no, gid, in_group_id,
                     it.is_rc, len(data))
                )
            self.timers.add("store_encode", time.perf_counter() - t0)
            return placements

        use_async = async_ok and bool(groups)
        if use_async:
            # pre-set LZ references for groups born this barrier (lazy:
            # only ref_size is recorded on the main thread; the two
            # reference copies + LZ prepare run at first use, normally on
            # the store worker): the matcher can then estimate against
            # them without joining the in-flight store
            for gid in groups:
                if gid >= NO_RAW_GROUPS and self.v_segments[gid] is None:
                    items = buf[gid]
                    items.sort(key=lambda s: (s.sample, s.contig, s.part_no))
                    seg = self._make_writer(gid)
                    seg.preset_ref_lazy(items[0])
                    self.v_segments[gid] = seg
            if self._store_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                # one worker owns each barrier's store job, in order, so
                # the job overlaps the next sample's scans; inside the job
                # (and the close's finish) the groups fan across a pool
                # of _n_threads (_fans)
                self._store_pool = ThreadPoolExecutor(max_workers=1)

            def store_all(groups=groups):
                with self.timers.stage("store_barrier"):
                    anchor_prepass()
                    out = []
                    if self._fans(len(groups)):
                        # ordered results keep placements deterministic
                        from concurrent.futures import (
                            ThreadPoolExecutor as _TPE,
                        )

                        with _TPE(max_workers=self._n_threads) as pool:
                            for placements in pool.map(store_group, groups):
                                out.extend(placements)
                    else:
                        for g in groups:
                            out.extend(store_group(g))
                    if self._entropy_batcher is not None:
                        # one batched device dispatch for this barrier's parts
                        self._entropy_batcher.flush()
                    return out

            if self._pending_store is None:
                self._pending_store = []
            # the job closure holds every buffered segment's bytes until
            # stored; record the volume so the backlog can be bounded by
            # BYTES, not barrier count (8 barriers of 500 MB assemblies
            # held up to 4 GB — part of the round-4 5 Gbase RSS gap).
            # Computed BEFORE submit: the worker sorts buf[g] in place
            # and materialize() clears _PendingSeg.raw, so touching the
            # buffers after submit races the job (size() could observe
            # data=None then raw=None mid-publish).
            job_bytes = sum(it.size() for g in groups for it in buf[g])
            fut = self._store_pool.submit(store_all)
            fut._agc_bytes = job_bytes
            self._pending_store.append(fut)
            # bound the in-flight queue (memory + placement lag)
            while len(self._pending_store) > 8 or (
                len(self._pending_store) > 1
                and sum(
                    getattr(f, "_agc_bytes", 0)
                    for f in self._pending_store
                )
                > _STORE_BACKLOG_BYTES
            ):
                self.timers.count("store_backpressure_joins")
                self._join_oldest_store()
            return
        anchor_prepass()
        if len(groups) > 4 and self._n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self._n_threads) as pool:
                results = list(pool.map(store_group, groups))
        else:
            results = [store_group(g) for g in groups]
        if self._entropy_batcher is not None:
            self._entropy_batcher.flush()
        for placements in results:
            for args in placements:
                self.collection.add_segment_placed(*args)

    # ==================================================================
    # finalization (reference: close_compression, store_metadata)
    # ==================================================================

    def abort(self) -> None:
        """Best-effort teardown after a failed create/append: stop the
        store pool, close handles, and REMOVE the partial output — a
        footerless .agc at the user's path is unreadable but easily
        mistaken for a finished archive (the reference leaves one
        behind; we do not)."""
        if self._closed:
            return
        self._closed = True
        import contextlib
        import os as _os

        if self._store_pool is not None:
            with contextlib.suppress(Exception):
                self._store_pool.shutdown(wait=True, cancel_futures=True)
        if self._match_pool is not None:
            with contextlib.suppress(Exception):
                self._match_pool.stop(timeout=5.0)
            self._match_pool = None
        with contextlib.suppress(Exception):
            self.writer.close()
        src = getattr(self, "_append_src", None)
        if src is not None:
            with contextlib.suppress(Exception):
                src.close()
        with contextlib.suppress(Exception):
            _os.unlink(self.writer._path)

    def close(self) -> bool:
        if self._closed:
            return False
        try:
            return self._close()
        except BaseException:
            # a failed finish (a store job's error surfaces here) leaves no
            # partial archive: abort() tears down as for any other failure
            self._closed = False
            self.abort()
            raise

    def _close(self) -> bool:
        self._closed = True
        with self.timers.stage("close_finalize"):
            self._finalize()
        if self.p.verbosity > 0:
            print(self.timers.report(), file=sys.stderr)
        return True

    def _finalize(self) -> None:
        self._ensure_splitters()
        self._join_pending_store()
        # finalize partial packs on the store worker while this thread
        # serializes the remaining metadata (zstd releases the GIL)
        live = [seg for seg in self.v_segments if seg is not None]
        # stream ids follow registration order: register the finish's
        # streams here, in group order, before any worker or metadata
        # part can register one
        for seg in live:
            seg.register_finish_stream()
        finish_fut = None
        if self._store_pool is not None and live:
            def finish_all():
                with self.timers.stage("store_finish"):
                    self._finish_groups(live)

            finish_fut = self._store_pool.submit(finish_all)
        else:
            self._finish_groups(live)

        # earlier metadata batches were compressed on the same worker
        # queue; their parts must land before the partial batch below
        if self._pending_meta:
            with self.timers.stage("wait_store"):
                for fut in self._pending_meta:
                    fut.result()
        self._pending_meta = []

        if self.archive_version >= 3000:
            # remaining partial metadata batch
            ps = self.processed_samples
            if ps % self.p.pack_cardinality != 0:
                self.collection.store_contig_batch(
                    self.writer,
                    (ps // self.p.pack_cardinality) * self.p.pack_cardinality,
                    ps,
                )
            self._store_metadata()
            self.collection.complete_serialization(self.writer)
        else:
            # legacy formats re-serialize the whole collection at close
            # (reference: store_metadata_impl_v1/v2, agc_compressor.cpp:
            # 81-168; zstd levels 19 / 15+19)
            self._store_metadata()
            if self.archive_version < 2000:
                blob = self.collection.serialize_v1()
                self.writer.add_part(
                    "collection-desc", _zstd_level(19).compress(blob), len(blob)
                )
            else:
                main, details = self.collection.serialize_v2(
                    self.p.pack_cardinality * 5
                )
                self.writer.add_part(
                    "collection-main", _zstd_level(15).compress(main), len(main)
                )
                for det in details:
                    self.writer.add_part(
                        "collection-details",
                        _zstd_level(19).compress(det),
                        len(det),
                    )
        if finish_fut is not None:
            with self.timers.stage("wait_store"):
                finish_fut.result()
        if self._store_pool is not None:
            self._store_pool.shutdown(wait=True)
            self._store_pool = None
        if self._match_pool is not None:
            # stop, not just drain: releases the worker thread, which a
            # process creating many Compressors would otherwise leak
            self._match_pool.stop(timeout=10.0)
            self._match_pool = None
        self.writer.flush_buffers()
        if self.p.verbosity > 0:
            # all parts (incl. async-finished packs and buffered writes)
            # have landed; stream sizes are final now
            self._print_component_sizes()
        self._store_file_type_info()
        self.writer.close()
        if self._mode == "append":
            self._append_src.close()

    def _fans(self, n_groups: int) -> bool:
        """Whether a store job's groups fan across a pool of _n_threads
        workers: on a multi-core host groups are independent until the
        archive append, and LZ/zstd release the GIL. The tpu-rans sink
        defers and flushes on one thread, in order."""
        return (
            self._entropy_batcher is None
            and self._n_threads > 1
            and n_groups > 4
        )

    def _finish_groups(self, live: list) -> None:
        """Finish every live group's last packs, fanned as a barrier's
        encodes are (_fans), in turn otherwise. Each group writes only its
        own, already registered stream, in its own order: the archive is
        the serial loop's to the byte."""
        fanned = self._fans(len(live))
        if fanned:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self._n_threads) as pool:
                list(pool.map(lambda seg: seg.finish(), live))
        else:
            for seg in live:
                seg.finish()
            if self._entropy_batcher is not None:
                self._entropy_batcher.flush()
        self.timers.count("store_finish_fanned", len(live) if fanned else 0)

    def _store_metadata(self) -> None:
        """reference: store_metadata (agc_compressor.cpp:175-284)."""
        params = bytearray()
        params += fixed_u32(self.k)
        params += fixed_u32(self.p.min_match_len)
        params += fixed_u32(self.p.pack_cardinality)
        if self.archive_version >= 2000:
            # format 1.x has no segment_size field (agc_compressor.cpp:213)
            params += fixed_u32(self.p.segment_size)
        self.writer.add_part("params", bytes(params), 0)

        v_tmp = bytearray()
        splitters_sorted = sorted(self._splitter_set)
        for x in splitters_sorted:
            v_tmp += fixed_u64(x)
        self.writer.add_part("splitters", bytes(v_tmp), len(splitters_sorted))

        v_tmp = bytearray()
        entries = sorted(self.map_segments.items())
        for (k1, k2), gid in entries:
            v_tmp += fixed_u64(k1)
            v_tmp += fixed_u64(k2)
            v_tmp += fixed_u32(gid)
        self.writer.add_part("segment-splitters", bytes(v_tmp), len(entries))

    def _print_component_sizes(self) -> None:
        """Verbose component-size breakdown (reference: store_metadata,
        agc_compressor.cpp:254-283)."""

        w = self.writer
        av = self.archive_version
        total_ref = total_delta = total_only_ref = 0
        n_only_ref = 0
        n_one_side = sum(
            1 for (k1, k2) in self.map_segments if k1 == EMPTY or k2 == EMPTY
        )
        for gid in range(self.no_segments):
            rs = w.stream_packed_size(ss_ref_name(av, gid))
            ds = w.stream_packed_size(ss_delta_name(av, gid))
            total_ref += rs
            total_delta += ds
            if w.n_parts(ss_delta_name(av, gid)) == 0:
                n_only_ref += 1
                total_only_ref += rs
        total_raw = sum(
            w.stream_packed_size(ss_delta_name(av, g)) for g in range(NO_RAW_GROUPS)
        )
        err = sys.stderr
        print("*** Component sizes ***", file=err)
        print(f"Reference sequences    : {total_ref}", file=err)
        print(f"   (only ref)          : {total_only_ref}", file=err)
        print(f"Raw sequences          : {total_raw}", file=err)
        print(f"Delta sequences        : {total_delta - total_raw}", file=err)
        print(
            f"Params                 : {w.stream_packed_size('params')}", file=err
        )
        print(
            f"Splitters              : {w.stream_packed_size('splitters')}",
            file=err,
        )
        print(
            "Segment splitters      : "
            f"{w.stream_packed_size('segment-splitters')}",
            file=err,
        )
        coll = sum(
            w.stream_packed_size(s)
            for s in (
                "collection-samples",
                "collection-contigs",
                "collection-details",
            )
        )
        print(f"Collection desc.       : {coll}", file=err)
        print("*** Stats ***", file=err)
        print(f"No. segments           : {self.no_segments}", file=err)
        print(f"No. one-side segments  : {n_one_side}", file=err)
        print(f"No. only ref. segments : {n_only_ref}", file=err)

    def _store_file_type_info(self) -> None:
        v = bytearray()
        for key in sorted(self.file_type_info):
            v += key.encode() + b"\x00"
            v += self.file_type_info[key].encode() + b"\x00"
        self.writer.add_part("file_type_info", bytes(v), len(self.file_type_info))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# high-level entry points (parity with CLI create/append)
# ---------------------------------------------------------------------------


def create_archive(
    out_path: str,
    input_files: list[str],
    params: CompressorParams | None = None,
    cmd_line: str | None = None,
    device="cuda",
) -> StageTimers:
    """``agc create``: first input is the reference (reference:
    main.cpp:76-120); device work runs on ``device``. Returns the run's
    stage timers."""
    # de-duplicate, preserving order (reference: sanitize_input_file_names)
    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    with device_trace("create"):
        comp = Compressor(
            out_path, params, reference_file=files[0], device=device
        )
        try:
            if cmd_line:
                comp.add_cmd_line(cmd_line)
            sample_files = [(sample_name_from_path(f), f) for f in files]
            comp.add_sample_files(sample_files)
            comp.close()
        except BaseException:
            comp.abort()
            raise
    return comp.timers


def append_archive(
    in_path: str,
    out_path: str,
    input_files: list[str],
    params: CompressorParams | None = None,
    cmd_line: str | None = None,
    device="cuda",
) -> StageTimers:
    """``agc append``: add samples to ``in_path``, writing ``out_path``;
    device work runs on ``device``. Returns the run's stage timers."""
    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    with device_trace("append"):
        comp = Compressor(out_path, params, in_path=in_path, device=device)
        try:
            if cmd_line:
                comp.add_cmd_line(cmd_line)
            sample_files = [(sample_name_from_path(f), f) for f in files]
            comp.add_sample_files(sample_files)
            comp.close()
        except BaseException:
            comp.abort()
            raise
    return comp.timers
