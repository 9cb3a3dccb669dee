"""Decompression engine: archive -> contigs/samples/collection.

reference: src/common/agc_decompressor_lib.{h,cpp} and
src/core/agc_decompressor.{h,cpp}.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .archive import ArchiveReader
from .codecs import fixed_u32, ss_base
from .collection import CollectionV3, SegmentDesc, extract_contig_name
from .genome_io import (
    CNV_NUM,
    FastaWriter,
    contig_to_ascii,
    contig_to_fasta_body,
)
from .segment import SegmentReader, zstd_decompress_tolerant

NO_RAW_GROUPS = 16  # reference: agc_basic.h:81

# contig query grammar (reference: agc_decompressor_lib.h:127-130)
_RE_CSR = re.compile(r"^(.+)@(.+):(.+)-(.+)$")
_RE_CS = re.compile(r"^(.+)@(.+)$")
_RE_CR = re.compile(r"^(.+):(.+)-(.+)$")

_RC_MAP = np.arange(256, dtype=np.uint8)
_RC_MAP[0:4] = [3, 2, 1, 0]


def reverse_complement(ctg: np.ndarray) -> np.ndarray:
    """reference: agc_basic.cpp:257-279 (codes >= 4 left as-is).

    Single native pass when the fast library is available (rc_numeric,
    GIL-free) — this is the hottest op of the getcol path after LZ decode
    since roughly half of all stored segments are reverse-oriented."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None and ctg.flags.c_contiguous and ctg.dtype == np.uint8:
        import ctypes

        out = np.empty(len(ctg), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rc_numeric(
            ctg.ctypes.data_as(u8p), len(ctg), out.ctypes.data_as(u8p)
        )
        return out
    return _RC_MAP[ctg[::-1]]


def _atoll(s: str) -> int:
    """C atoll semantics: parse leading integer, else 0."""
    m = re.match(r"^\s*[+-]?\d+", s)
    return int(m.group(0)) if m else 0


@dataclass
class ContigQuery:
    name: str
    sample: str
    from_: int
    to: int


def analyze_contig_query(query: str) -> ContigQuery:
    """reference: agc_decompressor_lib.cpp:64-101."""
    m = _RE_CSR.match(query)
    if m:
        return ContigQuery(m.group(1), m.group(2), _atoll(m.group(3)), _atoll(m.group(4)))
    m = _RE_CS.match(query)
    if m:
        return ContigQuery(m.group(1), m.group(2), -1, -1)
    m = _RE_CR.match(query)
    if m:
        return ContigQuery(m.group(1), "", _atoll(m.group(2)), _atoll(m.group(3)))
    return ContigQuery(query, "", -1, -1)


class _StreamSink:
    """Incremental FASTA writer with line-wrap continuation state
    (reference: CStreamWrapper, agc_decompressor_lib.h:70-125)."""

    def __init__(self, file_name: str | None, line_length: int, gzip_level: int):
        import gzip as _gzip
        import sys as _sys

        if file_name:
            raw = open(file_name, "wb")
            self._own = True
        else:
            raw = _sys.stdout.buffer
            self._own = False
        if gzip_level:
            self.f = _gzip.GzipFile(
                fileobj=raw, mode="wb", compresslevel=gzip_level, mtime=0
            )
            self._raw = raw
        else:
            self.f = raw
            self._raw = None
        self.line_length = line_length
        self._in_line = 0

    def start_contig(self, name: str) -> None:
        self.f.write(b">" + name.encode("utf-8") + b"\n")
        self._in_line = 0

    def append(self, piece: np.ndarray) -> None:
        data = CNV_NUM[piece]
        ll = self.line_length
        if ll == 0:
            self.f.write(data.tobytes())
            return
        out = bytearray()
        pos = 0
        n = len(data)
        while pos < n:
            room = ll - self._in_line
            take = min(room, n - pos)
            out += data[pos : pos + take].tobytes()
            pos += take
            self._in_line += take
            if self._in_line == ll:
                out += b"\n"
                self._in_line = 0
        self.f.write(bytes(out))

    def complete_contig(self) -> None:
        if self.line_length and self._in_line:
            self.f.write(b"\n")
            self._in_line = 0
        elif self.line_length == 0:
            self.f.write(b"\n")

    def close(self) -> None:
        if self._raw is not None:
            self.f.close()
            if self._own:
                self._raw.close()
        elif self._own:
            self.f.close()
        else:
            self.f.flush()


class Decompressor:
    """Open an .agc archive for queries and extraction."""

    # CLI sets this: range-clamp warnings print only in app mode, like
    # the reference's is_app_mode (agc_decompressor_lib.cpp:199-213)
    app_warnings = False

    def __init__(self, path: str, prefetch: bool = True):
        self.reader = ArchiveReader(path, prefetch=prefetch)
        self.file_type_info = self._load_file_type_info()
        maj = int(self.file_type_info.get("file_version_major", "3"))
        mino = int(self.file_type_info.get("file_version_minor", "0"))
        self.archive_version = maj * 1000 + mino
        if self.archive_version >= 4000:
            raise ValueError(
                f"unsupported archive version {maj}.{mino}; "
                "please use a newer agc-tpu"
            )
        self._load_params()
        if self.archive_version >= 3000:
            self.collection = CollectionV3.from_archive(
                self.reader, self.pack_cardinality, self.segment_size,
                self.kmer_length,
            )
        elif self.archive_version >= 2000:
            from .collection import CollectionLegacy

            self.collection = CollectionLegacy.from_archive_v2(self.reader)
        else:
            from .collection import CollectionLegacy

            self.collection = CollectionLegacy.from_archive_v1(self.reader)
        self._segment_cache: dict[int, SegmentReader] = {}
        import threading

        self._segment_cache_lock = threading.Lock()

    # ------------------------------------------------------------------

    def _load_file_type_info(self) -> dict[str, str]:
        part = self.reader.get_part("file_type_info", 0)
        if part is None:
            raise ValueError("not an AGC archive: missing file_type_info stream")
        data, n_items = part
        info = {}
        pos = 0
        for _ in range(n_items):
            end = data.index(0, pos)
            key = data[pos:end].decode()
            pos = end + 1
            end = data.index(0, pos)
            val = data[pos:end].decode()
            pos = end + 1
            info[key] = val
        return info

    def _load_params(self) -> None:
        part = self.reader.get_part("params", 0)
        if part is None:
            raise ValueError("archive does not contain parameters section")
        data = part[0]
        self.kmer_length = int.from_bytes(data[0:4], "little")
        self.min_match_len = int.from_bytes(data[4:8], "little")
        self.pack_cardinality = int.from_bytes(data[8:12], "little")
        self.segment_size = (
            int.from_bytes(data[12:16], "little") if len(data) >= 16 else 0
        )
        if (
            self.pack_cardinality < 1
            or not (1 <= self.kmer_length <= 32)
            or not (12 <= self.min_match_len <= 32)
        ):
            # a valid writer clamps all of these (k <= 32: two bits per
            # base in a u64; mml 15..32 is the format's range — 12 is
            # the defensive floor shared with the C API, whose LZ index
            # key math needs >= 8-symbol keys); anything else is damage
            raise ValueError("Corrupted archive! (invalid params stream)")

    # ------------------------------------------------------------------
    # segment access
    # ------------------------------------------------------------------

    def _segment(self, group_id: int) -> SegmentReader:
        seg = self._segment_cache.get(group_id)
        if seg is None:
            with self._segment_cache_lock:
                seg = self._segment_cache.get(group_id)
                if seg is None:
                    seg = SegmentReader(
                        ss_base(self.archive_version, group_id),
                        self.reader,
                        self.pack_cardinality,
                        self.min_match_len,
                        self.archive_version,
                    )
                    self._segment_cache[group_id] = seg
        return seg

    def decompress_segment(self, group_id: int, in_group_id: int) -> bytes:
        seg = self._segment(group_id)
        if group_id < NO_RAW_GROUPS:
            return seg.get_raw(in_group_id)
        return seg.get(in_group_id)

    # ------------------------------------------------------------------
    # contig assembly (reference: agc_decompressor_lib.cpp:172-286)
    # ------------------------------------------------------------------

    def decompress_contig(
        self, segments: list[SegmentDesc], from_: int = -1, to: int = -1
    ) -> np.ndarray:
        import sys

        k = self.kmer_length
        if from_ < 0 and to < 0:
            from_, to = 0, (1 << 62)
        else:
            # range-clamp warnings match the reference's app mode
            # (agc_decompressor_lib.cpp:189-217)
            if from_ < 0:
                if self.app_warnings:
                    print(
                        f"Warning: Start of range ({from_}) is below 0, "
                        "so changed to 0", file=sys.stderr,
                    )
                from_ = 0
            if to < 0:
                if self.app_warnings:
                    print(
                        f"Warning: End of range ({to}) is below 0, "
                        "so changed to max value", file=sys.stderr,
                    )
                to = 1 << 62
            if from_ > to:
                if self.app_warnings:
                    print(
                        f"Warning: End of range ({to}) is prior to start "
                        f"of range ({from_}) so changed to whole contig",
                        file=sys.stderr,
                    )
                from_, to = 0, 1 << 62

        parts: list[np.ndarray] = []
        curr_pos = 0
        for seg in segments:
            seg_len = seg.raw_length
            if curr_pos + seg_len < from_:
                from_ -= seg_len - k
                to -= seg_len - k
                continue
            if curr_pos > to:
                break
            raw = self.decompress_segment(seg.group_id, seg.in_group_id)
            ctg = np.frombuffer(raw, dtype=np.uint8)
            if seg.is_rev_comp:
                ctg = reverse_complement(ctg)
            parts.append(ctg)
            curr_pos += seg_len - k

        if not parts:
            return np.empty(0, dtype=np.uint8)
        pieces = [parts[0]]
        for p in parts[1:]:
            pieces.append(p[k:])  # drop k-overlap
        ctg = np.concatenate(pieces) if len(pieces) > 1 else pieces[0]
        if len(ctg) > to + 1:
            ctg = ctg[: to + 1]
        if from_ != 0:
            ctg = ctg[from_:]
        return ctg

    # ------------------------------------------------------------------
    # public queries (parity with CAGCDecompressorLibrary)
    # ------------------------------------------------------------------

    def list_samples(self, sorted_: bool = True) -> list[str]:
        return self.collection.get_samples_list(sorted_)

    def list_contigs(self, sample_name: str) -> list[str] | None:
        return self.collection.get_contig_list_in_sample(sample_name)

    def get_no_samples(self) -> int:
        return self.collection.get_no_samples()

    def get_no_contigs(self, sample_name: str) -> int:
        return self.collection.get_no_contigs(sample_name)

    def get_reference_sample(self) -> str:
        return self.collection.get_reference_name() or ""

    def get_params(self) -> dict:
        return {
            "kmer_length": self.kmer_length,
            "min_match_len": self.min_match_len,
            "pack_cardinality": self.pack_cardinality,
            "segment_size": self.segment_size,
        }

    def _resolve_sample_for_contig(self, contig_name: str) -> str | None:
        cands = self.collection.get_samples_for_contig(contig_name)
        if len(cands) != 1:
            return None
        return cands[0]

    def get_contig_seq(
        self, sample_name: str, contig_name: str, from_: int = -1, to: int = -1
    ) -> bytes | None:
        """Numeric contig -> ASCII string (no line wrapping)."""
        ctg = self.get_contig_numeric(sample_name, contig_name, from_, to)
        if ctg is None:
            return None
        return contig_to_ascii(ctg)

    def get_contig_numeric(
        self, sample_name: str, contig_name: str, from_: int = -1, to: int = -1
    ) -> np.ndarray | None:
        if not sample_name:
            sample_name = self._resolve_sample_for_contig(contig_name)
            if sample_name is None:
                return None
        desc = self.collection.get_contig_desc(sample_name, contig_name)
        if desc is None:
            return None
        _, segments = desc
        return self.decompress_contig(segments, from_, to)

    def get_contig_length(self, sample_name: str, contig_name: str) -> int:
        if not sample_name:
            sample_name = self._resolve_sample_for_contig(contig_name)
            if sample_name is None:
                return -1
        desc = self.collection.get_contig_desc(sample_name, contig_name)
        if desc is None:
            return -1
        _, segments = desc
        if not segments:
            return 0
        total = sum(s.raw_length for s in segments)
        return total - (len(segments) - 1) * self.kmer_length

    # ------------------------------------------------------------------
    # batch extraction (reference: agc_decompressor.cpp)
    # ------------------------------------------------------------------

    def _render_contig(
        self, segments, line_len: int, gzip_writer: FastaWriter | None,
        from_: int = -1, to: int = -1,
    ) -> bytes:
        """Decode + convert + wrap (+ optional gzip); thread-safe worker."""
        ctg = self.decompress_contig(segments, from_, to)
        body = contig_to_fasta_body(ctg, line_len)
        if gzip_writer is not None and gzip_writer.gzip_level:
            body = gzip_writer.gzip_body(body)
        return body

    def _emit_contig(
        self, writer: FastaWriter, name: str, segments, line_len: int,
        from_: int = -1, to: int = -1,
    ) -> None:
        writer.save_contig_directly(
            name, self._render_contig(segments, line_len, writer, from_, to)
        )

    def _emit_contigs_parallel(
        self, writer: FastaWriter, tasks, line_length: int, no_threads: int
    ) -> None:
        """Decode contigs on a worker pool, write in order (the reference's
        worker pool + ordered saver; agc_decompressor.cpp:41-80, 138-189).
        The hot loops (zstd, native LZ decode) release the GIL."""
        if no_threads <= 1 or len(tasks) <= 1:
            for name, segments in tasks:
                self._emit_contig(writer, name, segments, line_length)
            return
        with ThreadPoolExecutor(max_workers=no_threads) as pool:
            # sliding submission window: rendered bodies are held only
            # ~2x no_threads deep, so a slow sink (stdout pipe, gzip)
            # cannot accumulate the whole genome's ASCII in memory (the
            # reference bounds the same way with a fixed-size queue)
            from collections import deque

            window = max(2, 2 * no_threads)
            pending = deque()
            it = iter(tasks)
            for name, segments in it:
                pending.append((
                    name,
                    pool.submit(self._render_contig, segments, line_length, writer),
                ))
                if len(pending) >= window:
                    break
            while pending:
                name, fut = pending.popleft()
                writer.save_contig_directly(name, fut.result())
                for name2, segments2 in it:
                    pending.append((
                        name2,
                        pool.submit(
                            self._render_contig, segments2, line_length, writer
                        ),
                    ))
                    break

    def get_collection_files(
        self,
        out_dir: str,
        line_length: int = 80,
        no_threads: int = 1,
        gzip_level: int = 0,
        no_ref: bool = False,
    ) -> bool:
        """Extract every sample to <dir>/<sample>.fa[.gz] or stdout."""
        if out_dir and not os.path.isdir(out_dir):
            # reference: "Path must point to an existing directory"
            # (agc_decompressor.cpp:122-125)
            raise ValueError("Path must point to an existing directory")
        samples = self.collection.get_samples_list(sorted_=False)
        if no_ref and samples:
            samples = samples[1:]

        def emit_sample(s: str) -> None:
            # sample names come from the archive and are arbitrary bytes:
            # refuse separators / parent refs so a hostile archive cannot
            # write outside out_dir (reference interpolates unchecked)
            if "/" in s or "\\" in s or s in ("", ".", ".."):
                raise ValueError(
                    f"Corrupted archive! (unsafe sample name {s!r})"
                )
            suffix = ".fa.gz" if gzip_level else ".fa"
            path = f"{out_dir.rstrip('/')}/{s}{suffix}"
            writer = FastaWriter(path, gzip_level)
            desc = self.collection.get_sample_desc(s)
            for name, segments in desc:
                self._emit_contig(writer, name, segments, line_length)
            writer.close()

        if out_dir and no_threads > 1 and len(samples) > 1:
            # whole samples decode+write in parallel (decode and file IO
            # release the GIL); stdout output stays ordered/serial
            with ThreadPoolExecutor(max_workers=no_threads) as pool:
                list(pool.map(emit_sample, samples))
            return True
        for s in samples:
            if out_dir:
                emit_sample(s)
                continue
            writer = FastaWriter(None, gzip_level)
            desc = self.collection.get_sample_desc(s)
            self._emit_contigs_parallel(writer, desc, line_length, no_threads)
            writer.close()
        return True

    def get_sample_file(
        self,
        file_name: str | None,
        sample_names: list[str],
        line_length: int = 80,
        no_threads: int = 1,
        gzip_level: int = 0,
    ) -> bool:
        tasks = []
        for s in sample_names:
            desc = self.collection.get_sample_desc(s)
            if desc is None:
                raise KeyError(f"There is no sample {s}")
            tasks.extend(desc)
        writer = FastaWriter(file_name, gzip_level)
        self._emit_contigs_parallel(writer, tasks, line_length, no_threads)
        writer.close()
        return True

    def get_contig_file(
        self,
        file_name: str | None,
        contig_queries: list[str],
        line_length: int = 80,
        no_threads: int = 1,
        gzip_level: int = 0,
    ) -> bool:
        writer = FastaWriter(file_name, gzip_level)
        for q in contig_queries:
            cq = analyze_contig_query(q)
            sample = cq.sample
            if not sample:
                sample = self._resolve_sample_for_contig(cq.name)
                if sample is None:
                    raise KeyError(f"Cannot resolve sample for contig {cq.name}")
            desc = self.collection.get_contig_desc(sample, cq.name)
            if desc is None:
                raise KeyError(f"There is no contig {cq.name} in sample {sample}")
            full_name, segments = desc
            out_name = full_name
            if cq.from_ >= 0 and cq.to >= 0:
                out_name = f"{full_name}:{cq.from_}-{cq.to}"
            self._emit_contig(
                writer, out_name, segments, line_length, cq.from_, cq.to
            )
        writer.close()
        return True

    # ------------------------------------------------------------------
    # streaming extraction: constant memory, one segment at a time
    # (reference: decompress_contig_streaming, agc_decompressor_lib.cpp:289-396,
    #  CStreamWrapper agc_decompressor_lib.h:70-125)
    # ------------------------------------------------------------------

    def _stream_contig(self, segments, sink, from_: int = -1, to: int = -1) -> None:
        k = self.kmer_length
        if from_ < 0:
            from_ = 0
        if to < 0:
            to = 1 << 62
        if from_ > to:
            from_, to = 0, 1 << 62
        logical_pos = 0  # position of next emitted base in contig coordinates
        first = True
        for seg in segments:
            start = logical_pos
            if start > to:
                break  # everything from here is past the range
            # segments before the range skip via raw_length without
            # decoding (same as the batch path, decompress_contig)
            piece_len = seg.raw_length if first else seg.raw_length - k
            if start + piece_len <= from_:
                logical_pos = start + piece_len
                first = False
                continue
            raw = self.decompress_segment(seg.group_id, seg.in_group_id)
            ctg = np.frombuffer(raw, dtype=np.uint8)
            if seg.is_rev_comp:
                ctg = reverse_complement(ctg)
            piece = ctg if first else ctg[k:]
            first = False
            end = start + len(piece)
            logical_pos = end
            lo = max(start, from_)
            hi = min(end, to + 1)
            if hi > lo:
                sink.append(piece[lo - start : hi - start])
        sink.complete_contig()

    def get_streaming(
        self,
        file_name: str | None,
        sample_names: list[str] | None = None,
        contig_queries: list[str] | None = None,
        line_length: int = 80,
        gzip_level: int = 0,
    ) -> bool:
        """``getset -s`` / ``getctg -s``: constant-memory extraction."""
        sink = _StreamSink(file_name, line_length, gzip_level)
        try:
            if sample_names:
                for s in sample_names:
                    desc = self.collection.get_sample_desc(s)
                    if desc is None:
                        raise KeyError(f"There is no sample {s}")
                    for contig_name, segments in desc:
                        sink.start_contig(contig_name)
                        self._stream_contig(segments, sink)
            for q in contig_queries or []:
                cq = analyze_contig_query(q)
                sample = cq.sample or self._resolve_sample_for_contig(cq.name)
                if sample is None:
                    raise KeyError(f"Cannot resolve sample for contig {cq.name}")
                desc = self.collection.get_contig_desc(sample, cq.name)
                if desc is None:
                    raise KeyError(f"No contig {cq.name} in sample {sample}")
                full_name, segments = desc
                name = full_name
                if cq.from_ >= 0 and cq.to >= 0:
                    name = f"{full_name}:{cq.from_}-{cq.to}"
                sink.start_contig(name)
                self._stream_contig(segments, sink, cq.from_, cq.to)
        finally:
            sink.close()
        return True

    def get_sample_sequences(self, sample_name: str) -> list[tuple[str, np.ndarray]]:
        """In-memory decode of a whole sample (used by adaptive append;
        reference: agc_decompressor.cpp:405-475)."""
        desc = self.collection.get_sample_desc(sample_name)
        out = []
        for contig_name, segments in desc:
            out.append((contig_name, self.decompress_contig(segments)))
        return out

    def close(self) -> None:
        self.reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
