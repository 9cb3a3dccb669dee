"""Collection metadata: sample -> contig -> segment placements.

Implements the reference's V3 batched lazy metadata format
(reference: src/common/collection_v3.{h,cpp}) bit-compatibly:

- stream "collection-samples": one zstd-19 part; raw = <n><name\\0>*
- stream "collection-contigs": one zstd-18 part per batch of
  ``batch_size`` (= pack_cardinality) samples; contig names are
  space-tokenized and delta-coded vs the previous contig name
  (collection_v3.cpp:369-465).
- stream "collection-details": one part per batch; 5 independently
  zstd-19'd substreams (counts / group_id / in_group_id / raw_length /
  is_rev_comp) with a prefix-varint header of (raw, packed) sizes
  (collection_v3.cpp:230-320, 539-679).

Part metadata for samples/contigs parts is the raw (uncompressed) size;
for details parts it is 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .zstd import zstandard

from .codecs import (
    dec_prefix_varint,
    enc_prefix_varint,
    read_cstr,
    zigzag_decode,
    zigzag_decode_pred,
    zigzag_encode,
    zigzag_encode_pred,
)

SAME_COMPONENT_MARKER = 0x81  # signed char -127 (collection_v3.cpp:377)


def _zstd_c(data: bytes, level: int, profile: str = "zstd") -> bytes:
    from .segment import part_compress

    return part_compress(data, level, profile)


def _zstd_d(data: bytes, raw_size: int) -> bytes:
    if raw_size == 0 and not data:
        return b""
    from .segment import zstd_decompress_tolerant

    return zstd_decompress_tolerant(data)


def extract_contig_name(s: str) -> str:
    """First whitespace-delimited word (reference: collection.cpp:19-28)."""
    for i, ch in enumerate(s):
        if ch in (" ", "\n", "\r", "\t"):
            return s[:i]
    return s


@dataclass
class SegmentDesc:
    group_id: int
    in_group_id: int
    is_rev_comp: bool
    raw_length: int


@dataclass
class _Contig:
    name: str
    segments: list = field(default_factory=list)


@dataclass
class _Sample:
    name: str
    contigs: list = field(default_factory=list)
    contigs_loaded: bool = False
    details_loaded: bool = False
    # lazy contig-name -> index map (placement would otherwise scan the
    # contig list once per segment: quadratic for scaffold-heavy samples)
    contig_ids: dict | None = None

    def contig_index(self, name: str) -> int | None:
        if self.contig_ids is None or len(self.contig_ids) != len(self.contigs):
            self.contig_ids = {c.name: i for i, c in enumerate(self.contigs)}
        return self.contig_ids.get(name)


# ---------------------------------------------------------------------------
# contig-name split/delta codec (collection_v3.cpp:350-465)
# ---------------------------------------------------------------------------


def _decode_name(raw: bytes) -> str:
    """Archive names are raw byte strings in the format; decode UTF-8 with a
    latin-1 fallback so malformed (e.g. binary) names never crash reads."""
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("latin-1")


def _split_tokens(s: bytes) -> list[bytes]:
    return s.split(b" ")


def _encode_split(prev: list[bytes], curr: list[bytes]) -> bytes:
    enc = bytearray()
    for p_tok, c_tok in zip(prev, curr):
        if p_tok == c_tok:
            enc.append(SAME_COMPONENT_MARKER)
        elif len(p_tok) != len(c_tok):
            enc.extend(c_tok)
        else:
            cnt = 0
            for j in range(len(c_tok)):
                if p_tok[j] == c_tok[j]:
                    if cnt == 100:
                        enc.append(256 - cnt)  # repetition marker (-cnt)
                        cnt = 1
                    else:
                        cnt += 1
                else:
                    if cnt:
                        enc.append(256 - cnt)
                        cnt = 0
                    enc.append(c_tok[j])
            if cnt:
                enc.append(256 - cnt)
        enc.append(ord(" "))
    if enc:
        enc.pop()
    return bytes(enc)


def _decode_split(prev: list[bytes], curr: list[bytes]) -> tuple[bytes, list[bytes]]:
    dec = bytearray()
    out_tokens: list[bytes] = []
    for p_tok, c_tok in zip(prev, curr):
        if len(c_tok) == 1 and c_tok[0] == SAME_COMPONENT_MARKER:
            dec.extend(p_tok)
            out_tokens.append(p_tok)
        else:
            cmp = bytearray()
            p_pos = 0
            for c in c_tok:
                if c < 0x80:
                    cmp.append(c)
                    p_pos += 1
                else:
                    n = 256 - c
                    cmp.extend(p_tok[p_pos : p_pos + n])
                    p_pos += n
            dec.extend(cmp)
            out_tokens.append(bytes(cmp))
        dec.append(ord(" "))
    if dec:
        dec.pop()
    return bytes(dec), out_tokens


class CollectionLegacy:
    """Read-only support for AGC 1.x / 2.x collection metadata, needed to
    extract from archives produced by old reference versions.

    - v1: single zstd blob in stream "collection-desc"; per segment the
      4 fields are interleaved with plain-zigzag deltas
      (reference: collection_v1.cpp:14-157).
    - v2: "collection-main" (names + per-contig segment counts + cmd
      lines) and per-batch "collection-details" parts of 4 concatenated
      substreams using zigzag-vs-prediction deltas
      (reference: collection_v2.cpp:14-173, collection_v1.cpp:424-530).

    Presents the same query interface as CollectionV3.
    """

    def __init__(self):
        self.samples: list[_Sample] = []
        self.sample_ids: dict[str, int] = {}
        self.cmd_lines: list[tuple[str, str]] = []
        self.batch_size = 1

    # -- shared varint walkers -----------------------------------------

    @staticmethod
    def _read_str(data, pos):
        raw, pos = read_cstr(data, pos)
        return _decode_name(raw), pos

    @classmethod
    def from_archive_v1(cls, reader) -> "CollectionLegacy":
        part = reader.get_part("collection-desc", 0)
        if part is None:
            raise ValueError("v1 archive missing collection-desc stream")
        data = _zstd_d(part[0], part[1])
        coll = cls()
        pos = 0
        n_samples, pos = dec_prefix_varint(data, pos)
        for i in range(n_samples):
            name, pos = cls._read_str(data, pos)
            coll.sample_ids[name] = i
            sample = _Sample(name=name, contigs_loaded=True, details_loaded=True)
            n_contigs, pos = dec_prefix_varint(data, pos)
            for _ in range(n_contigs):
                cname, pos = cls._read_str(data, pos)
                n_seg, pos = dec_prefix_varint(data, pos)
                ctg = _Contig(name=cname)
                pg = pig = prl = 0
                for _ in range(n_seg):
                    eg, pos = dec_prefix_varint(data, pos)
                    ei, pos = dec_prefix_varint(data, pos)
                    er, pos = dec_prefix_varint(data, pos)
                    eo, pos = dec_prefix_varint(data, pos)
                    pg = pg + zigzag_decode(eg)
                    pig = pig + zigzag_decode(ei)
                    prl = prl + zigzag_decode(er)
                    ctg.segments.append(SegmentDesc(pg, pig, bool(eo), prl))
                sample.contigs.append(ctg)
            coll.samples.append(sample)
        n_cmds, pos = dec_prefix_varint(data, pos)
        for _ in range(n_cmds):
            cmd, pos = cls._read_str(data, pos)
            when, pos = cls._read_str(data, pos)
            coll.cmd_lines.append((cmd, when))
        return coll

    @classmethod
    def from_archive_v2(cls, reader) -> "CollectionLegacy":
        part = reader.get_part("collection-main", 0)
        if part is None:
            raise ValueError("v2 archive missing collection-main stream")
        data = _zstd_d(part[0], part[1])
        coll = cls()
        pos = 0
        batch_size, pos = dec_prefix_varint(data, pos)
        coll.batch_size = max(1, batch_size)
        n_samples, pos = dec_prefix_varint(data, pos)
        seg_counts: list[list[int]] = []
        for i in range(n_samples):
            name, pos = cls._read_str(data, pos)
            coll.sample_ids[name] = i
            sample = _Sample(name=name, contigs_loaded=True, details_loaded=True)
            n_contigs, pos = dec_prefix_varint(data, pos)
            counts = []
            for _ in range(n_contigs):
                cname, pos = cls._read_str(data, pos)
                n_seg, pos = dec_prefix_varint(data, pos)
                counts.append(n_seg)
                sample.contigs.append(_Contig(name=cname))
            seg_counts.append(counts)
            coll.samples.append(sample)
        n_cmds, pos = dec_prefix_varint(data, pos)
        for _ in range(n_cmds):
            cmd, pos = cls._read_str(data, pos)
            when, pos = cls._read_str(data, pos)
            coll.cmd_lines.append((cmd, when))

        # details: one part per batch of batch_size samples
        part_id = 0
        base = 0
        while base < n_samples:
            part = reader.get_part("collection-details", part_id)
            if part is None:
                break
            det = _zstd_d(part[0], part[1])
            hi = min(base + coll.batch_size, n_samples)
            batch_samples = coll.samples[base:hi]
            batch_counts = seg_counts[base:hi]
            # allocate
            for s, counts in zip(batch_samples, batch_counts):
                for ctg, n_seg in zip(s.contigs, counts):
                    ctg.segments = [
                        SegmentDesc(0, 0, False, 0) for _ in range(n_seg)
                    ]
            dpos = 0
            for field in range(4):
                for s in batch_samples:
                    for ctg in s.contigs:
                        prev = 0
                        for seg in ctg.segments:
                            v, dpos = dec_prefix_varint(det, dpos)
                            if field == 0:
                                seg.group_id = zigzag_decode_pred(v, prev)
                                prev = seg.group_id
                            elif field == 1:
                                seg.in_group_id = zigzag_decode_pred(v, prev)
                                prev = seg.in_group_id
                            elif field == 2:
                                seg.raw_length = zigzag_decode_pred(v, prev)
                                prev = seg.raw_length
                            else:
                                seg.is_rev_comp = bool(v)
            base = hi
            part_id += 1
        return coll

    # -- queries (same surface as CollectionV3) -------------------------

    def get_no_samples(self) -> int:
        return len(self.samples)

    def get_reference_name(self) -> str | None:
        return self.samples[0].name if self.samples else None

    def get_samples_list(self, sorted_: bool = True) -> list[str]:
        names = [s.name for s in self.samples]
        if sorted_:
            names.sort()
        return names

    def get_contig_list_in_sample(self, sample_name: str) -> list[str] | None:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        return [c.name for c in self.samples[sid].contigs]

    def get_no_contigs(self, sample_name: str) -> int:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return -1
        return len(self.samples[sid].contigs)

    def get_sample_desc(self, sample_name: str):
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        return [(c.name, c.segments) for c in self.samples[sid].contigs]

    def get_contig_desc(self, sample_name: str, contig_name: str):
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        short = extract_contig_name(contig_name)
        for c in self.samples[sid].contigs:
            if extract_contig_name(c.name) == short:
                return c.name, c.segments
        return None

    def is_contig_desc(self, sample_name: str, contig_name: str) -> bool:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return False
        return any(
            extract_contig_name(c.name) == contig_name
            for c in self.samples[sid].contigs
        )

    def get_samples_for_contig(self, contig_name: str) -> list[str]:
        short = extract_contig_name(contig_name)
        return [
            s.name
            for s in self.samples
            if any(extract_contig_name(c.name) == short for c in s.contigs)
        ]

    # ------------------------------------------------------------------
    # appending / write side (reference supports appending to 1.x / 2.x
    # archives, re-serializing the whole collection in the original
    # format at close: store_metadata_impl_v1/v2,
    # agc_compressor.cpp:81-168)
    # ------------------------------------------------------------------

    _prev_sample_name: str | None = None

    def reset_prev_sample_name(self) -> None:
        self._prev_sample_name = None

    def register_sample_contig(self, sample_name: str, contig_name: str) -> bool:
        stored = sample_name if sample_name else extract_contig_name(contig_name)
        if stored != self._prev_sample_name:
            if stored in self.sample_ids:
                return False
            self.sample_ids[stored] = len(self.samples)
            self.samples.append(
                _Sample(name=stored, contigs_loaded=True, details_loaded=True)
            )
            self._prev_sample_name = stored
        self.samples[-1].contigs.append(_Contig(name=contig_name))
        return True

    def add_segment_placed(
        self,
        sample_name: str,
        contig_name: str,
        place: int,
        group_id: int,
        in_group_id: int,
        is_rev_comp: bool,
        raw_length: int,
    ) -> None:
        stored = sample_name if sample_name else extract_contig_name(contig_name)
        sample = self.samples[self.sample_ids[stored]]
        ci = sample.contig_index(contig_name)
        if ci is None:
            return
        ctg = sample.contigs[ci]
        if place >= len(ctg.segments):
            ctg.segments.extend(
                None for _ in range(place + 1 - len(ctg.segments))
            )
        ctg.segments[place] = SegmentDesc(
            group_id, in_group_id, is_rev_comp, raw_length
        )

    def add_cmd_line(self, cmd: str) -> None:
        self.cmd_lines.append((cmd, ""))

    @staticmethod
    def _write_str(out: bytearray, s: str) -> None:
        out.extend(s.encode("utf-8") + b"\x00")

    def serialize_v1(self) -> bytes:
        """reference: CCollection_V1::serialize (collection_v1.cpp; dates
        always stored empty, matching serialize(..., false))."""
        out = bytearray()
        enc_prefix_varint(out, len(self.samples))
        for s in self.samples:
            self._write_str(out, s.name)
            enc_prefix_varint(out, len(s.contigs))
            for ctg in s.contigs:
                self._write_str(out, ctg.name)
                enc_prefix_varint(out, len(ctg.segments))
                pg = pig = prl = 0
                for seg in ctg.segments:
                    enc_prefix_varint(out, zigzag_encode(seg.group_id - pg))
                    enc_prefix_varint(
                        out, zigzag_encode(seg.in_group_id - pig)
                    )
                    enc_prefix_varint(
                        out, zigzag_encode(seg.raw_length - prl)
                    )
                    enc_prefix_varint(out, int(seg.is_rev_comp))
                    pg, pig, prl = seg.group_id, seg.in_group_id, seg.raw_length
        enc_prefix_varint(out, len(self.cmd_lines))
        for cmd, _ in self.cmd_lines:
            self._write_str(out, cmd)
            self._write_str(out, "")
        return bytes(out)

    def serialize_v2(
        self, details_batch_size: int
    ) -> tuple[bytes, list[bytes]]:
        """reference: CCollection_V2::serialize (collection_v2.cpp:
        main = names/counts/cmds; details = per-batch field-major
        zigzag-vs-prediction streams)."""
        main = bytearray()
        enc_prefix_varint(main, details_batch_size)
        enc_prefix_varint(main, len(self.samples))
        for s in self.samples:
            self._write_str(main, s.name)
            enc_prefix_varint(main, len(s.contigs))
            for ctg in s.contigs:
                self._write_str(main, ctg.name)
                enc_prefix_varint(main, len(ctg.segments))
        details: list[bytes] = []
        for base in range(0, len(self.samples), details_batch_size):
            batch = self.samples[base : base + details_batch_size]
            det = bytearray()
            for field in range(4):
                for s in batch:
                    for ctg in s.contigs:
                        prev = 0
                        for seg in ctg.segments:
                            if field == 0:
                                v = zigzag_encode_pred(seg.group_id, prev)
                                prev = seg.group_id
                            elif field == 1:
                                v = zigzag_encode_pred(seg.in_group_id, prev)
                                prev = seg.in_group_id
                            elif field == 2:
                                v = zigzag_encode_pred(seg.raw_length, prev)
                                prev = seg.raw_length
                            else:
                                v = int(seg.is_rev_comp)
                            enc_prefix_varint(det, v)
            details.append(bytes(det))
        enc_prefix_varint(main, len(self.cmd_lines))
        for cmd, _ in self.cmd_lines:
            self._write_str(main, cmd)
            self._write_str(main, "")
        return bytes(main), details


class CollectionV3:
    """Writer + reader of V3 collection metadata."""

    def __init__(self, batch_size: int, segment_size: int, kmer_length: int):
        self.profile = "zstd"  # archive profile; set by the compressor
        self.batch_size = max(1, batch_size)
        self.segment_size = segment_size
        self.kmer_length = kmer_length
        self.samples: list[_Sample] = []
        self.sample_ids: dict[str, int] = {}
        self._prev_sample_name: str | None = None
        self._cur_contig_names: set[str] = set()  # short names, current sample
        self._reader = None  # ArchiveReader for lazy loads
        self._loaded_batch: int | None = None
        # getcol/getset worker threads hit _ensure_sample concurrently for
        # samples of the same batch; zstd releases the GIL mid-load, so an
        # unguarded double-load would interleave contig-list appends
        self._load_lock = __import__("threading").RLock()

    # ------------------------------------------------------------------
    # registration / placement (compression side)
    # ------------------------------------------------------------------

    def reset_prev_sample_name(self) -> None:
        self._prev_sample_name = None

    def register_sample_contig(self, sample_name: str, contig_name: str) -> bool:
        """reference: collection_v3.cpp:706-732. Unlike the reference we
        also reject a DUPLICATE FULL CONTIG NAME within one sample: the
        reference accepts it and then silently corrupts both copies at
        extraction (placements funnel to one index), so refusing the
        second copy (caller prints the 'already in the archive' error and
        skips it) is the strictly safer behavior. Contigs that share only
        the short (first-word) name stay accepted, as in the reference —
        placement and batch extraction key on the full name; only
        short-name queries are ambiguous (first match wins, both tools)."""
        stored = sample_name if sample_name else extract_contig_name(contig_name)
        if stored != self._prev_sample_name:
            if stored in self.sample_ids:
                return False
            self.sample_ids[stored] = len(self.samples)
            self.samples.append(_Sample(name=stored, contigs_loaded=True, details_loaded=True))
            self._prev_sample_name = stored
            self._cur_contig_names = set()
        if contig_name in self._cur_contig_names:
            return False
        self._cur_contig_names.add(contig_name)
        self.samples[-1].contigs.append(_Contig(name=contig_name))
        return True

    def add_segment_placed(
        self,
        sample_name: str,
        contig_name: str,
        place: int,
        group_id: int,
        in_group_id: int,
        is_rev_comp: bool,
        raw_length: int,
    ) -> None:
        stored = sample_name if sample_name else extract_contig_name(contig_name)
        sample = self.samples[self.sample_ids[stored]]
        ci = sample.contig_index(contig_name)
        if ci is not None:
            ctg = sample.contigs[ci]
            if place >= len(ctg.segments):
                ctg.segments.extend(
                    None for _ in range(place + 1 - len(ctg.segments))
                )
            ctg.segments[place] = SegmentDesc(
                group_id, in_group_id, is_rev_comp, raw_length
            )
            return

    # ------------------------------------------------------------------
    # serialization (compression side)
    # ------------------------------------------------------------------

    def serialize_sample_names(self) -> bytes:
        out = bytearray()
        enc_prefix_varint(out, len(self.samples))
        for s in self.samples:
            out.extend(s.name.encode("utf-8") + b"\x00")
        return bytes(out)

    def serialize_contig_names(self, id_from: int, id_to: int) -> bytes:
        out = bytearray()
        enc_prefix_varint(out, id_to - id_from)
        for s in self.samples[id_from:id_to]:
            enc_prefix_varint(out, len(s.contigs))
            prev_split: list[bytes] = []
            for ctg in s.contigs:
                raw = ctg.name.encode("utf-8")
                curr_split = _split_tokens(raw)
                if len(curr_split) != len(prev_split):
                    emitted = raw
                else:
                    emitted = _encode_split(prev_split, curr_split)
                if any(b >= 0x80 for b in emitted):
                    # the format (ours AND the reference's,
                    # collection_v3.cpp:423-468) interprets bytes >= 0x80
                    # as copy/same markers whenever the stored token count
                    # matches the previous name's — a name emitting such
                    # bytes can round-trip only if the decode happens to
                    # reproduce it. Verify; refuse rather than corrupt
                    # (the reference silently mis-decodes here).
                    try:
                        sim = _split_tokens(emitted)
                        if len(sim) != len(prev_split):
                            decoded = emitted
                        else:
                            decoded, _ = _decode_split(prev_split, sim)
                    except Exception:
                        decoded = None
                    if decoded != raw:
                        raise ValueError(
                            f"contig name {ctg.name!r} cannot be stored "
                            "losslessly in the AGC collection format "
                            "(non-ASCII byte where the name delta coder "
                            "reads markers); rename the contig"
                        )
                out.extend(emitted + b"\x00")
                prev_split = curr_split
        return bytes(out)

    def serialize_contig_details(self, id_from: int, id_to: int) -> list[bytes]:
        v_data = [bytearray() for _ in range(5)]
        enc_prefix_varint(v_data[0], id_to - id_from)
        in_group_state: dict[int, int] = {}
        for s in self.samples[id_from:id_to]:
            enc_prefix_varint(v_data[0], len(s.contigs))
            pred_raw_length = self.segment_size + self.kmer_length
            for ctg in s.contigs:
                enc_prefix_varint(v_data[0], len(ctg.segments))
                for seg in ctg.segments:
                    prev = in_group_state.get(seg.group_id, -1)
                    if prev == -1:
                        e_in_group = seg.in_group_id
                    elif seg.in_group_id == 0:
                        e_in_group = 0
                    elif seg.in_group_id == prev + 1:
                        e_in_group = 1
                    else:
                        e_in_group = zigzag_encode_pred(seg.in_group_id, prev + 1) + 1
                    e_raw_length = zigzag_encode_pred(seg.raw_length, pred_raw_length)
                    enc_prefix_varint(v_data[1], seg.group_id)
                    enc_prefix_varint(v_data[2], e_in_group)
                    enc_prefix_varint(v_data[3], e_raw_length)
                    enc_prefix_varint(v_data[4], 1 if seg.is_rev_comp else 0)
                    if seg.in_group_id > prev and seg.in_group_id > 0:
                        in_group_state[seg.group_id] = seg.in_group_id
        return [bytes(d) for d in v_data]

    def store_contig_batch(self, writer, id_from: int, id_to: int,
                           executor=None, evict: bool = False):
        """Write one batch of contig names + details (collection_v3.cpp:682-703).

        Serialization (which reads live collection state) happens HERE,
        synchronously; the zstd compression + archive writes run on
        ``executor`` when given (the reference also compresses batches on
        async futures; collection_v3.cpp:242-249). Returns the future (or
        None) — callers must join it before closing the archive.
        """
        names_raw = self.serialize_contig_names(id_from, id_to)
        v_data = self.serialize_contig_details(id_from, id_to)
        if evict:
            # create-side eviction, like the reference's stored-batch
            # release (collection_v3.cpp): the serialized bytes above are
            # the only thing the archive still needs from these samples
            for s in self.samples[id_from:id_to]:
                s.contigs = []
                s.contig_ids = None

        def finish():
            writer.add_part_buffered(
                "collection-contigs",
                _zstd_c(names_raw, 18, self.profile),
                len(names_raw),
            )
            v_packed = [_zstd_c(d, 19, self.profile) for d in v_data]
            stream = bytearray()
            for raw, packed in zip(v_data, v_packed):
                enc_prefix_varint(stream, len(raw))
                enc_prefix_varint(stream, len(packed))
            for packed in v_packed:
                stream.extend(packed)
            writer.add_part_buffered("collection-details", bytes(stream), 0)

        if executor is not None:
            return executor.submit(finish)
        finish()
        return None

    def complete_serialization(self, writer) -> None:
        raw = self.serialize_sample_names()
        writer.add_part_buffered(
            "collection-samples", _zstd_c(raw, 19, self.profile), len(raw)
        )

    # ------------------------------------------------------------------
    # deserialization (decompression side)
    # ------------------------------------------------------------------

    @classmethod
    def from_archive(
        cls, reader, batch_size: int, segment_size: int, kmer_length: int
    ) -> "CollectionV3":
        coll = cls(batch_size, segment_size, kmer_length)
        coll._reader = reader
        part = reader.get_part("collection-samples", 0)
        if part is None:
            raise ValueError("archive missing collection-samples stream")
        data = _zstd_d(part[0], part[1])
        pos = 0
        n_samples, pos = dec_prefix_varint(data, pos)
        for i in range(n_samples):
            name, pos = read_cstr(data, pos)
            name = _decode_name(name)
            coll.sample_ids[name] = i
            coll.samples.append(_Sample(name=name))
        return coll

    def _load_batch_contig_names(self, batch_id: int) -> None:
        part = self._reader.get_part("collection-contigs", batch_id)
        if part is None:
            raise ValueError(
                f"Corrupted archive! (missing collection-contigs batch {batch_id})"
            )
        data = _zstd_d(part[0], part[1])
        pos = 0
        n_samples, pos = dec_prefix_varint(data, pos)
        base = batch_id * self.batch_size
        for i in range(n_samples):
            n_contigs, pos = dec_prefix_varint(data, pos)
            sample = self.samples[base + i]
            sample.contigs = []
            prev_split: list[bytes] = []
            for _ in range(n_contigs):
                enc, pos = read_cstr(data, pos)
                curr_split = _split_tokens(enc)
                if len(curr_split) != len(prev_split):
                    name_bytes = enc
                    prev_split = curr_split
                else:
                    name_bytes, prev_split = _decode_split(prev_split, curr_split)
                sample.contigs.append(_Contig(name=_decode_name(name_bytes)))
            sample.contigs_loaded = True
        self.no_samples_in_last_batch = n_samples

    def _load_batch_contig_details(self, batch_id: int) -> None:
        part = self._reader.get_part("collection-details", batch_id)
        if part is None:
            raise ValueError(
                f"Corrupted archive! (missing collection-details batch {batch_id})"
            )
        stream = part[0]
        pos = 0
        sizes = []
        for _ in range(5):
            raw, pos = dec_prefix_varint(stream, pos)
            packed, pos = dec_prefix_varint(stream, pos)
            sizes.append((raw, packed))
        v_data = []
        for raw, packed in sizes:
            v_data.append(_zstd_d(stream[pos : pos + packed], raw))
            pos += packed

        base_check = batch_id * self.batch_size
        if not self.samples[base_check].contigs_loaded:
            self._load_batch_contig_names(batch_id)

        # counts substream
        d0 = v_data[0]
        p0 = 0
        n_samples, p0 = dec_prefix_varint(d0, p0)
        base = batch_id * self.batch_size
        seg_counts: list[list[int]] = []
        total = 0
        for i in range(n_samples):
            n_contigs, p0 = dec_prefix_varint(d0, p0)
            counts = []
            for _ in range(n_contigs):
                n_segs, p0 = dec_prefix_varint(d0, p0)
                counts.append(n_segs)
                total += n_segs
            seg_counts.append(counts)

        dets = []
        for i in range(1, 5):
            vals = []
            p = 0
            d = v_data[i]
            for _ in range(total):
                v, p = dec_prefix_varint(d, p)
                vals.append(v)
            dets.append(vals)

        idx = 0
        in_group_state: dict[int, int] = {}
        pred_raw_length = self.segment_size + self.kmer_length
        for i in range(n_samples):
            sample = self.samples[base + i]
            for j, n_segs in enumerate(seg_counts[i]):
                ctg = sample.contigs[j]
                ctg.segments = []
                for _ in range(n_segs):
                    group_id = dets[0][idx]
                    e_in_group = dets[1][idx]
                    prev = in_group_state.get(group_id, -1)
                    if prev == -1:
                        in_group = e_in_group
                    elif e_in_group == 0:
                        in_group = 0
                    elif e_in_group == 1:
                        in_group = prev + 1
                    else:
                        in_group = zigzag_decode_pred(e_in_group - 1, prev + 1)
                    raw_length = zigzag_decode_pred(dets[2][idx], pred_raw_length)
                    is_rc = bool(dets[3][idx])
                    ctg.segments.append(
                        SegmentDesc(group_id, in_group, is_rc, raw_length)
                    )
                    if in_group > prev and in_group > 0:
                        in_group_state[group_id] = in_group
                    idx += 1
            sample.details_loaded = True

    def _ensure_sample(self, sid: int, details: bool = False) -> None:
        if self._reader is None:
            return
        s = self.samples[sid]
        if s.contigs_loaded and (not details or s.details_loaded):
            return  # fast path without the lock: flags flip only inside it
        with self._load_lock:
            batch_id = sid // self.batch_size
            if not s.contigs_loaded:
                self._load_batch_contig_names(batch_id)
            if details and not s.details_loaded:
                self._load_batch_contig_details(batch_id)

    # ------------------------------------------------------------------
    # queries (reference: collection_v3.cpp:808-994)
    # ------------------------------------------------------------------

    def get_no_samples(self) -> int:
        return len(self.samples)

    def get_reference_name(self) -> str | None:
        return self.samples[0].name if self.samples else None

    def get_samples_list(self, sorted_: bool = True) -> list[str]:
        names = [s.name for s in self.samples]
        if sorted_:
            names.sort()
        return names

    def get_contig_list_in_sample(self, sample_name: str) -> list[str] | None:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        self._ensure_sample(sid)
        return [c.name for c in self.samples[sid].contigs]

    def get_no_contigs(self, sample_name: str) -> int:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return -1
        self._ensure_sample(sid)
        return len(self.samples[sid].contigs)

    def get_sample_desc(
        self, sample_name: str
    ) -> list[tuple[str, list[SegmentDesc]]] | None:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        self._ensure_sample(sid, details=True)
        return [(c.name, c.segments) for c in self.samples[sid].contigs]

    def get_contig_desc(
        self, sample_name: str, contig_name: str
    ) -> tuple[str, list[SegmentDesc]] | None:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return None
        self._ensure_sample(sid, details=True)
        short = extract_contig_name(contig_name)
        for c in self.samples[sid].contigs:
            if extract_contig_name(c.name) == short:
                return c.name, c.segments
        return None

    def is_contig_desc(self, sample_name: str, contig_name: str) -> bool:
        sid = self.sample_ids.get(sample_name)
        if sid is None:
            return False
        self._ensure_sample(sid)
        return any(
            extract_contig_name(c.name) == contig_name
            for c in self.samples[sid].contigs
        )

    def get_samples_for_contig(self, contig_name: str) -> list[str]:
        short = extract_contig_name(contig_name)
        out = []
        for sid, s in enumerate(self.samples):
            self._ensure_sample(sid)
            if any(extract_contig_name(c.name) == short for c in s.contigs):
                out.append(s.name)
        return out
