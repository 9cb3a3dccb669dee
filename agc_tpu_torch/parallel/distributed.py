"""Sharded collection compression: data-parallel over samples with a
deterministic archive merge (counterpart of
``agc_tpu/parallel/distributed.py``).

- The splitter set is determined once from the reference genome (the
  boot engine's discovery, on ``device``) and replicated to every shard.
- Samples are partitioned round-robin across shards; each shard scans
  and cuts its samples on ``device`` (``_CapturingCompressor``) and
  captures the segments with their boundary k-mers.
- The merge (on the writer) replays the real matcher over every captured
  segment in global sample order against the global group inventory, so
  N-shard archives stay within 2% of 1-shard ones, then stores them.
- Collection metadata is rebuilt globally in the user-specified sample
  order, so extraction output is independent of the shard count.

Shards run as threads of this process (sharing its device) or as spawned
processes, each of which opens ``device`` itself; on several hosts each
shard is one process of ``parallel/torchdist.py``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..core.archive import ArchiveWriter
from ..core.collection import CollectionV3
from ..core.compressor import (
    Compressor,
    CompressorParams,
    Kmer,
    _FallbackFilter,
    _rc_numeric,
)
from ..core.genome_io import sample_name_from_path
from ..core.lz import LZDiff
from ..core.segment import store_ref_blob


@dataclass
class _ShardResult:
    """Everything a shard produces for the merge step.

    Shards SCAN AND CUT; the writer MATCHES AND STORES: each captured
    segment carries its boundary k-mers, and the merge replays the real
    matcher (_add_segment) against the GLOBAL group inventory in global
    sample order. Shard-local matching would make group choices (one-
    splitter pairings, missing-middle splits) depend on each shard's
    private inventory; replay keeps N-shard archives within 2% of
    1-shard (tests/test_torch_distributed.py)."""

    shard_id: int
    sample_names: list
    # sample -> ordered [(contig, ord, data_bytes, (kf_dir, kf_rc,
    # kf_full), (kb_dir, kb_rc, kb_full)[, delta_bytes, ref_hash])] in
    # contig/segment order
    segments: dict = field(default_factory=dict)
    splitter_set: set = field(default_factory=set)
    # sample -> fallback-minimizer records collected while scanning it
    # (merged at that sample's barrier, mirroring the plain schedule)
    fallback_by_sample: dict = field(default_factory=dict)
    # sample (or -c input path) -> ordered full contig names, so the merge
    # never re-parses the input FASTA just to recover names
    contig_names: dict = field(default_factory=dict)


class _NullWriter:
    """The archive a shard never writes."""

    def register_stream(self, name):
        return 0

    def add_part_buffered(self, *a, **k):
        pass

    def add_part(self, *a, **k):
        pass

    def flush_buffers(self):
        pass


class _CapturingCompressor(Compressor):
    """Compressor that captures segment members instead of writing them.

    Reuses the scan and cut pipeline on ``device``; ``_add_segment``
    records each cut segment (in order) so the merge step can replay it
    into the global archive."""

    def __init__(
        self,
        params,
        splitter_set,
        shard_id,
        fallback_records=(),
        cand_singletons=None,
        cand_duplicated=None,
        exchanger=None,
        inventory=None,
        device="cuda",
    ):
        # the engine's whole state, an archive that is never written
        self._init_state(params, device)
        self.writer = _NullWriter()
        self._mode = "shard"
        self.collection = CollectionV3(
            self.p.pack_cardinality, self.p.segment_size, self.k
        )
        # Discovery's fallback records, with plain-create timing (the
        # reference merges them at the FIRST registration barrier,
        # agc_compressor.cpp:1126): shard 0's first sample IS the
        # reference, so it keeps them pending until its first barrier;
        # every other shard's first sample followed that barrier in the
        # single-host order, so those shards pre-merge before compressing.
        self._pending_fallback = list(fallback_records)
        if shard_id != 0:
            self._merge_fallback_mappings()
        # adaptive mode: the discovery's candidate tables (reference
        # singletons + duplicated k-mers, sorted flipped int64) gate which
        # k-mers a splitterless contig may promote (find_new_splitters,
        # agc_compressor.cpp:2054)
        if cand_singletons is not None:
            self.cand_singletons = cand_singletons.to(self.device)
        if cand_duplicated is not None:
            self.cand_duplicated = cand_duplicated.to(self.device)
        # cross-shard new-splitter exchanger (torchdist); None = shard-local
        self._exchanger = exchanger
        self._splitter_set = set(splitter_set)
        self._refresh_splitter_table()
        self.shard_id = shard_id
        self.captured_segments: dict[str, list] = {}
        self.fallback_by_sample: dict[str, list] = {}
        self._current_sample = None
        # -c mode: capture keys + per-file contig order (the merge
        # replays the GLOBAL contig stream in file order). Keys come
        # from the contig->file map, NOT the file currently being
        # ingested: -c batches hold pack_cardinality contigs and SPAN
        # file boundaries, so by the time a batch's segments are cut
        # the ingestion cursor may already be on a later file.
        self._cur_cfile: str | None = None
        self._cfile_contigs: dict[str, list[str]] = {}
        self._ccontig_file: dict[str, str] = {}
        # boot-broadcast group-reference inventory: pk -> (stored ref
        # bytes, blake2b-16). Two-splitter segments whose pk is here get
        # their LZ delta computed SHARD-SIDE against the true global
        # group reference (groups born in the reference sample are
        # created from exactly these bytes at the writer); the writer
        # verifies the hash before reuse, so a wrong guess only costs a
        # local re-encode, never archive bytes.
        self._inventory = inventory or {}
        self._inv_lz: dict = {}

    def _synchronize(self) -> None:
        """Shard-local barrier: adaptive splitter merges only (matching
        and storing happen at the global merge). Fallback records are
        banked per sample so the merge can replay them at that sample's
        barrier, mirroring the plain-create schedule."""
        if self.p.adaptive_compression:
            self._adaptive_barrier()
        if self._pending_fallback:
            key = self._current_sample
            self.fallback_by_sample.setdefault(key, []).extend(
                self._pending_fallback
            )
            self._pending_fallback = []
        self.processed_samples += 1

    def _exchange_new_splitters(self, pending):
        if self._exchanger is None:
            return pending
        return self._exchanger.exchange(pending)

    def _add_segment(
        self, sample, contig, part_no, segment, kmer_front, kmer_back,
        device_hint=None,
    ) -> int:
        """Capture the cut segment + its boundary k-mers; the MERGE runs
        the real matcher against the global inventory (see _ShardResult).
        Always returns 0: splits are the merge's decision, so shard-side
        part numbers are per-segment ordinals."""
        key = sample or self._ccontig_file.get(contig) or self._cur_cfile or ""
        self._current_sample = key
        rec = (
            contig,
            part_no,
            segment.astype(np.uint8, copy=False).tobytes(),
            (kmer_front.dir, kmer_front.rc, kmer_front.full),
            (kmer_back.dir, kmer_back.rc, kmer_back.full),
        )
        if (
            kmer_front.full
            and kmer_back.full
            and self._inventory
            and self._lz_mode() == "classic"
        ):
            a, b = kmer_front.data(), kmer_back.data()
            pk = (a, b) if a < b else (b, a)
            inv = self._inventory.get(pk)
            if inv is not None:
                ref_b, ref_h = inv
                stored = (
                    rec[2]
                    if a < b
                    else _rc_numeric(segment)
                    .astype(np.uint8, copy=False)
                    .tobytes()
                )
                lz = self._inv_lz.get(pk)
                if lz is None:
                    lz = LZDiff(
                        self.p.min_match_len,
                        v1_grammar=self.archive_version < 2000,
                    )
                    lz.prepare(ref_b)
                    self._inv_lz[pk] = lz
                rec = rec + (lz.encode(stored), ref_h)
        self.captured_segments.setdefault(key, []).append(rec)
        return 0

    def _device_match_prepass(self, codes, cuts, cut_kmers) -> dict:
        return {}  # no shard-side matching: nothing to rank

    def _store_segments(self, async_ok: bool = False) -> None:
        self._buf_known = {}  # raw-group buffers (nothing is staged)

    # -c capture hooks (base: no-ops). Segments and contig order are
    # keyed by input FILE so the merge can replay the global contig
    # stream with the plain -c barrier schedule.
    def _concat_file_begin(self, fname: str) -> None:
        self._cur_cfile = fname
        self._cfile_contigs.setdefault(fname, [])

    def _concat_contig_registered(self, fname: str, cid: str) -> None:
        self._cfile_contigs[fname].append(cid)
        self._ccontig_file[cid] = fname

    def result(self) -> _ShardResult:
        res = _ShardResult(self.shard_id, [s.name for s in self.collection.samples])
        res.segments = self.captured_segments
        res.fallback_by_sample = self.fallback_by_sample
        res.splitter_set = self._splitter_set
        if self.p.concatenated_genomes:
            # -c: contigs keyed per input file PATH, in ingestion order
            res.contig_names = {
                f: list(c) for f, c in self._cfile_contigs.items()
            }
        else:
            res.contig_names = {
                s.name: [c.name for c in s.contigs]
                for s in self.collection.samples
            }
        return res


def _run_shard_task(args):
    """One shard's compression (module-level: runs in worker PROCESSES).

    The splitter set is the replicated state; the returned _ShardResult is
    what travels to the writer (plain picklable data). The device travels
    in the task: a spawned worker opens it itself."""
    (params, splitter_set, shard_id, shard_files, fallback_records,
     cand_singletons, cand_duplicated, inventory, device) = args
    comp = _CapturingCompressor(
        params, splitter_set, shard_id, fallback_records,
        cand_singletons=cand_singletons, cand_duplicated=cand_duplicated,
        inventory=inventory, device=device,
    )
    comp.add_sample_files(shard_files)
    return comp.result()


def _inventory(params, splitter_set, fallback_records, cand_singletons,
               cand_duplicated, reference, device):
    """Group-reference inventory of the reference sample: scan and cut it
    with the boot splitters; every two-splitter pk it yields will be
    created at the writer from exactly these bytes (the merge replays
    samples in global order, reference first). Returns ({pk: (ref_bytes,
    hash)}, {pk: (blob, meta, hash)}); the blobs (zstd profile only) are
    the reference parts precompressed on a thread pool, which the writer
    stores directly after a hash check."""
    inv_comp = _CapturingCompressor(
        params, splitter_set, 0, fallback_records,
        cand_singletons=cand_singletons, cand_duplicated=cand_duplicated,
        device=device,
    )
    inv_comp.add_sample_files([reference])
    inventory = {}
    for segs in inv_comp.captured_segments.values():
        for rec in segs:
            kf, kb = rec[3], rec[4]
            if not (kf[2] and kb[2]):
                continue
            a, b = min(kf[0], kf[1]), min(kb[0], kb[1])
            pk = (a, b) if a < b else (b, a)
            if pk in inventory:
                continue
            stored = rec[2]
            if a >= b:
                stored = (
                    _rc_numeric(np.frombuffer(stored, dtype=np.uint8))
                    .astype(np.uint8, copy=False)
                    .tobytes()
                )
            inventory[pk] = (stored, hashlib.blake2b(stored, digest_size=16).digest())
    inv_ref_blobs = {}
    if params.profile == "zstd":
        # the reference parts' zstd (most of the merge's store wall when
        # left to it) on the cores: zstd releases the GIL
        def blob(item):
            pk, (stored, h) = item
            return pk, (*store_ref_blob(stored, params.profile), h)

        with ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) // 2)) as pool:
            inv_ref_blobs = dict(pool.map(blob, inventory.items()))
    return inventory, inv_ref_blobs


def create_archive_sharded(
    out_path: str,
    input_files: list[str],
    params: CompressorParams | None = None,
    n_shards: int = 2,
    worker: str = "thread",
    device="cuda",
) -> None:
    """Data-parallel create: shard samples, compress, merge into one archive.

    Extraction output is byte-identical regardless of ``n_shards``.
    ``worker="process"`` runs each shard in its own spawned OS process
    (independent runtimes, each opening ``device``; results shipped to the
    writer by value); ``"thread"`` shares this process's device.
    """
    params = params or CompressorParams()
    if params.concatenated_genomes and (
        params.adaptive_compression or params.fallback_frac > 0
    ):
        # -c sharding replays the global contig stream at the writer
        # (byte-identical to 1-shard), but adaptive/-f grow state at the
        # plain schedule's CONTIG-BLOCK barriers, which shard-local
        # ingestion cannot reproduce (blocks span file boundaries)
        raise NotImplementedError(
            "sharded -c supports neither adaptive mode nor -f: their "
            "barrier state follows the plain create's contig-block "
            "schedule, which is not reproducible shard-side"
        )
    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    timings = {"t_boot": time.perf_counter()}

    # Phase 1: splitters (and -f fallback records; adaptive candidate
    # tables) from the reference genome, shared by every shard
    boot = Compressor(out_path + ".tmp0", params, reference_file=files[0], device=device)
    try:
        splitter_set = set(boot.splitter_set_snapshot())
        fallback_records = list(boot._pending_fallback)
        cand_singletons = boot.cand_singletons
        cand_duplicated = boot.cand_duplicated
    finally:
        boot.writer.close()
        with contextlib.suppress(OSError):
            os.unlink(out_path + ".tmp0")
    del boot

    # Phase 1b: the group-reference inventory (a pure optimization: the
    # writer hash-checks every shipped delta and blob)
    inventory, inv_ref_blobs = {}, {}
    if os.environ.get("AGC_TPU_SHARD_INV", "1") != "0":
        inventory, inv_ref_blobs = _inventory(
            params, splitter_set, fallback_records, cand_singletons,
            cand_duplicated, sample_files[0], device,
        )

    # Phase 2: shard the samples round-robin and compress independently.
    # Adaptive mode here is SHARD-LOCAL: each shard grows its own splitter
    # table from its splitterless contigs (deterministic for a given shard
    # count, identical between thread and process workers); torchdist
    # instead exchanges new splitters at every sample barrier.
    spawn = n_shards > 1 and worker == "process"
    if spawn:
        # tensors travel to spawned workers from host memory
        cand_singletons, cand_duplicated = cand_singletons.cpu(), cand_duplicated.cpu()
    shards: list[list] = [[] for _ in range(n_shards)]
    for i, sf in enumerate(sample_files):
        shards[i % n_shards].append(sf)
    tasks = [
        (params, splitter_set, sid, shards[sid], fallback_records,
         cand_singletons, cand_duplicated, inventory, str(device))
        for sid in range(n_shards)
    ]

    timings["t_shards"] = time.perf_counter()
    if spawn:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawn (not fork): each worker initializes its own runtime and
        # opens the device itself, as a process on another host would; a
        # worker that dies fails the create (BrokenProcessPool)
        with ProcessPoolExecutor(n_shards, mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_run_shard_task, tasks))
    elif n_shards > 1:
        with ThreadPoolExecutor(max_workers=n_shards) as pool:
            results = list(pool.map(_run_shard_task, tasks))
    else:
        results = [_run_shard_task(tasks[0])]
    timings["t_merge"] = time.perf_counter()

    # Phase 3: deterministic merge on the writer. On failure remove the
    # partial output: a footerless .agc at the user's path reads as a
    # finished archive (same policy as Compressor.abort)
    try:
        merge_split = _merge_shards(
            out_path, params, sample_files, splitter_set, results,
            inv_ref_blobs=inv_ref_blobs, device=device,
        )
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(out_path)
        raise
    timings["t_end"] = time.perf_counter()
    if os.environ.get("AGC_TPU_SHARD_TIMINGS"):
        out = {
            "n_shards": n_shards,
            "worker": worker,
            "boot_s": round(timings["t_shards"] - timings["t_boot"], 2),
            "shards_s": round(timings["t_merge"] - timings["t_shards"], 2),
            "merge_s": round(timings["t_end"] - timings["t_merge"], 2),
            **{k: round(v, 2) for k, v in merge_split.items()},
        }
        print("AGC_TPU_SHARD_TIMINGS " + json.dumps(out), file=sys.stderr)


def _hint_of(rec):
    """(pk, delta_bytes, ref_hash) from a 7-wide captured record, or
    None. pk is recomputed from the boundary k-mers with the same rule
    _add_segment uses, so the hint attaches only when the matcher's
    final pk agrees (Compressor._add_segment)."""
    if len(rec) < 7:
        return None
    kf, kb = rec[3], rec[4]
    if not (kf[2] and kb[2]):
        return None
    a, b = min(kf[0], kf[1]), min(kb[0], kb[1])
    pk = (a, b) if a < b else (b, a)
    return (pk, rec[5], rec[6])


def _merge_shards(out_path, params, sample_files, splitter_set, results,
                  inv_ref_blobs=None, device="cuda"):
    """Replay every shard's captured segments into one archive at
    ``out_path``; returns the merge's seconds split into matching, store
    and close."""
    merged = Compressor.__new__(Compressor)
    merged._init_state(params, device)
    merged.writer = ArchiveWriter(out_path)
    # collection streams (ids 0/1/2) and the raw groups, as a plain create
    merged._init_create(None)
    merged._inv_ref_blobs = inv_ref_blobs or {}
    # adaptive shards grow their tables; the archive's splitters stream is
    # the union (stored sorted, so shard order is immaterial). Non-adaptive
    # shards all hold exactly the boot set.
    merged._splitter_set = set(splitter_set)
    for res in results:
        merged._splitter_set |= res.splitter_set
    merged._refresh_splitter_table()
    # the replay matches by the captured boundary k-mers: no -f matching
    # and no candidate tables at the writer (agc_tpu's merge)
    merged.fallback_filter = _FallbackFilter(0.0)

    # Replay: the writer runs the REAL matcher over every captured
    # segment in global sample order against the growing global
    # inventory: group pairing, one-splitter estimation and missing-middle
    # splits happen HERE, exactly as a plain create would do them.
    per_sample: dict[str, list] = {}
    fb_per_sample: dict[str, list] = {}
    contig_names: dict[str, list[str]] = {}
    for res in sorted(results, key=lambda r: r.shard_id):
        for sample, segs in res.segments.items():
            per_sample[sample] = segs
        for sample, recs in res.fallback_by_sample.items():
            fb_per_sample.setdefault(sample, []).extend(recs)
        contig_names.update(res.contig_names)

    split = {"merge_match_s": 0.0, "merge_store_s": 0.0, "merge_close_s": 0.0}

    if params.concatenated_genomes:
        # -c replay: the global contig stream in input-file order with
        # the plain create's schedule (one barrier per pack_cardinality
        # contigs, blocks spanning file boundaries: add_sample_files'
        # concatenated branch), so the archive is byte-identical to a
        # 1-shard -c create. Each contig registers as its own
        # collection sample (collection.register_sample_contig("", cid)).
        n_in_batch = 0
        for _sample_name, path in sample_files:
            merged.collection.reset_prev_sample_name()
            segs_by_contig: dict[str, list] = {}
            for rec in per_sample.get(path, []):
                segs_by_contig.setdefault(rec[0], []).append(rec)
            for cid in contig_names.get(path, []):
                if not merged.collection.register_sample_contig("", cid):
                    print(
                        f"Error: Pair sample_name:contig_name {cid}:{cid}"
                        " is already in the archive!",
                        file=sys.stderr,
                    )
                    continue
                t0 = time.perf_counter()
                part_no = 0
                for rec in segs_by_contig.get(cid, []):
                    contig, _ord, data, kf, kb = rec[:5]
                    extra = merged._add_segment(
                        "", contig, part_no, np.frombuffer(data, dtype=np.uint8),
                        Kmer(*kf), Kmer(*kb), delta_hint=_hint_of(rec),
                    )
                    part_no += 1 + extra
                split["merge_match_s"] += time.perf_counter() - t0
                n_in_batch += 1
                if n_in_batch >= params.pack_cardinality:
                    t1 = time.perf_counter()
                    merged._synchronize()
                    split["merge_store_s"] += time.perf_counter() - t1
                    n_in_batch = 0
        t1 = time.perf_counter()
        merged._synchronize()
        split["merge_store_s"] += time.perf_counter() - t1
        t2 = time.perf_counter()
        merged.close()
        split["merge_close_s"] = time.perf_counter() - t2
        return split

    for sample_name, _path in sample_files:
        merged.collection.reset_prev_sample_name()
        for cid in contig_names.get(sample_name, []):
            merged.collection.register_sample_contig(sample_name, cid)
        part_no: dict[str, int] = {}
        t0 = time.perf_counter()
        for rec in per_sample.get(sample_name, []):
            contig, _ord, data, kf, kb = rec[:5]
            pn = part_no.get(contig, 0)
            extra = merged._add_segment(
                sample_name, contig, pn, np.frombuffer(data, dtype=np.uint8),
                Kmer(*kf), Kmer(*kb), delta_hint=_hint_of(rec),
            )
            part_no[contig] = pn + 1 + extra
        t1 = time.perf_counter()
        split["merge_match_s"] += t1 - t0
        merged._register_segments()
        # async: zstd/LZ release the GIL, so this sample's store overlaps
        # the NEXT sample's matching replay on the writer (the same
        # store-worker pipeline the plain create uses); close() joins
        merged._store_segments(async_ok=True)
        merged._pending_fallback.extend(fb_per_sample.get(sample_name, []))
        merged._merge_fallback_mappings()
        merged.processed_samples += 1
        if merged.processed_samples % params.pack_cardinality == 0:
            # batch metadata serializes placements: in-flight async
            # stores must land first (same join the plain barrier does)
            merged._join_pending_store()
            merged.collection.store_contig_batch(
                merged.writer,
                merged.processed_samples - params.pack_cardinality,
                merged.processed_samples,
            )
        merged.writer.flush_buffers()
        split["merge_store_s"] += time.perf_counter() - t1

    t2 = time.perf_counter()
    merged.close()
    split["merge_close_s"] = time.perf_counter() - t2
    return split
