"""Segment group store: per-group reference + LZ-delta packs.

Bit-compatible with the reference's CSegment on-archive layout
(reference: src/common/segment.{h,cpp}):

- ref stream  "x<b64>r": single part; data = zstd(payload) + 1 marker byte
  (0 = plain, 1 = "tuples" repacked); metadata = raw size, or raw bytes with
  metadata 0 when compression does not pay (segment.h:172-255).
- delta stream "x<b64>d": parts of ``pack_cardinality`` members, each
  member's token stream terminated by 0xFF; zstd-17 + marker byte 0,
  metadata = raw pack size (or raw, metadata 0).
- raw groups (group_id < 16) store raw symbol streams in the delta stream
  via the same pack framing (segment.cpp:14-31).
"""

from __future__ import annotations

import numpy as np
from .zstd import zstandard

from .codecs import ss_delta_ext, ss_ref_ext
from .lz import LZDiff, decode_v1, decode_v2

CONTIG_SEPARATOR = 0xFF


_zstd_d_tls = __import__("threading").local()


def zstd_decompress_tolerant(data: bytes) -> bytes:
    """Decompress one frame, ignoring trailing bytes (the reference
    appends a marker byte after the frame and passes the full buffer to
    ZSTD_decompressDCtx; segment.cpp:304). Frames are self-identifying —
    zstd starts 0x28 B5 2F FD, the tpu-rans profile's blobs start 0xA9 —
    so every reader serves both archive profiles without knowing which
    one produced the part."""
    if len(data) >= 2 and data[0] == 0xA9:
        from .entropy import decompress as _rans_d

        return _rans_d(data)
    d = getattr(_zstd_d_tls, "d", None)
    if d is None:
        d = _zstd_d_tls.d = zstandard.ZstdDecompressor()
    return d.decompressobj().decompress(bytes(data))


def part_compress(data: bytes, level: int, profile: str = "zstd") -> bytes:
    """Profile dispatch for one compressed part: the default profile uses
    zstd at the reference's pinned level; the "tpu-rans" profile uses the
    lane-interleaved rANS stage (core/entropy.py) instead."""
    if profile == "tpu-rans":
        from .entropy import compress as _rans_c

        return _rans_c(data)
    return _zstd_level(level).compress(data)


# ---------------------------------------------------------------------------
# tuples repacking (reference: segment.h:73-169)
# ---------------------------------------------------------------------------

_TUPLE_PARAMS = {4: 4, 3: 6, 2: 16}


def bytes2tuples(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    me = int(arr.max()) if len(arr) else 0
    if me < 4:
        nb, mult = 4, 4
    elif me < 6:
        nb, mult = 3, 6
    elif me < 16:
        nb, mult = 2, 16
    else:
        return data + b"\x10"
    n_full = len(arr) // nb
    main = arr[: n_full * nb].reshape(n_full, nb).astype(np.uint32)
    packed = np.zeros(n_full, dtype=np.uint32)
    for j in range(nb):
        packed = packed * mult + main[:, j]
    tail = arr[n_full * nb :]
    c = 0
    for v in tail.tolist():
        c = c * mult + v
    out = packed.astype(np.uint8).tobytes() + bytes([c])
    marker = (nb << 4) | (len(arr) % nb)
    return out + bytes([marker])


def tuples2bytes(data: bytes) -> bytes:
    if not data:
        raise ValueError("Corrupted archive! (empty tuples part)")
    marker = data[-1]
    nb = marker >> 4
    trailing = marker & 0xF
    if nb == 1:
        return data[:-1]
    if nb not in _TUPLE_PARAMS or len(data) < 2 or trailing >= nb:
        raise ValueError("Corrupted archive! (invalid tuples marker)")
    mult = _TUPLE_PARAMS[nb]
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        out = np.empty((len(data) - 2) * nb + trailing, dtype=np.uint8)
        m = lib.tuples_to_bytes(
            data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        return out[:m].tobytes()
    output_size = (len(data) - 2) * nb + trailing
    tuples = np.frombuffer(data, dtype=np.uint8)
    main = tuples[: len(data) - 2].astype(np.uint32)
    cols = []
    rem = main
    for _ in range(nb):
        cols.append(rem % mult)
        rem = rem // mult
    out = np.stack(cols[::-1], axis=1).astype(np.uint8).reshape(-1)
    res = bytearray(out.tobytes())
    if trailing:
        c = int(tuples[len(data) - 2])
        tail = bytearray(trailing)
        for k in range(trailing - 1, -1, -1):
            tail[k] = c % mult
            c //= mult
        res.extend(tail)
    else:
        pass  # the pre-marker byte is a filler zero (see bytes2tuples)
    return bytes(res[:output_size])


# ---------------------------------------------------------------------------
# decode-side segment access
# ---------------------------------------------------------------------------


class SegmentReader:
    """Random access to one segment group of an open archive.

    Caches the decoded reference and the last decoded delta packs
    (mirrors the reference's ``fast`` mode prefetch; segment.h:59-61).
    """

    def __init__(
        self,
        name: str,
        reader,
        pack_cardinality: int,
        min_match_len: int,
        archive_version: int,
    ):
        import threading

        self.name = name
        self.reader = reader
        self.pack = pack_cardinality
        self.min_match_len = min_match_len
        self.archive_version = archive_version
        self._ref: bytes | None = None
        self._pack_cache: dict[int, list[bytes]] = {}
        self._pack_cache_max = 2
        self._lock = threading.Lock()

    def _ref_stream(self) -> str:
        return self.name + ss_ref_ext(self.archive_version)

    def _delta_stream(self) -> str:
        return self.name + ss_delta_ext(self.archive_version)

    def _load_ref(self) -> bytes:
        if self._ref is not None:
            return self._ref
        with self._lock:
            if self._ref is not None:
                return self._ref
            part = self.reader.get_part(self._ref_stream(), 0)
            if part is None:
                raise KeyError(f"missing ref stream {self._ref_stream()}")
            data, raw_size = part
            if raw_size == 0:
                ref = bytes(data)
            else:
                payload = zstd_decompress_tolerant(data[:-1])
                if data[-1] == 1:
                    ref = tuples2bytes(payload)
                else:
                    ref = payload
            self._ref = ref
            return ref

    def _load_pack(self, part_id: int) -> list[bytes]:
        with self._lock:
            cached = self._pack_cache.get(part_id)
            if cached is not None:
                return cached
        part = self.reader.get_part(self._delta_stream(), part_id)
        if part is None:
            raise KeyError(f"missing delta part {self._delta_stream()}[{part_id}]")
        data, raw_size = part
        if raw_size == 0:
            pack = bytes(data)
        else:
            pack = zstd_decompress_tolerant(data)
        items = pack.split(b"\xff")[:-1]
        with self._lock:
            if len(self._pack_cache) >= self._pack_cache_max:
                self._pack_cache.pop(next(iter(self._pack_cache)))
            self._pack_cache[part_id] = items
        return items

    def get_raw(self, in_group_id: int) -> bytes:
        """Raw-group member (reference: segment.cpp:136-217)."""
        part_id = in_group_id // self.pack
        idx = in_group_id % self.pack
        return self._load_pack(part_id)[idx]

    def get(self, in_group_id: int) -> bytes:
        """LZ-group member (reference: segment.cpp:220-399)."""
        ref = self._load_ref()
        if in_group_id == 0:
            return ref
        part_id = (in_group_id - 1) // self.pack
        idx = (in_group_id - 1) % self.pack
        delta = self._load_pack(part_id)[idx]
        if self.archive_version < 2000:
            return decode_v1(ref, delta, self.min_match_len)
        return decode_v2(ref, delta, self.min_match_len)


# ---------------------------------------------------------------------------
# encode-side segment store
# ---------------------------------------------------------------------------


_zstd_tls = __import__("threading").local()


def _zstd_level(level: int):
    """Per-thread compressor cache: context setup costs real time at the
    levels the format mandates (13/17/19), and members are compressed one
    60 kb block at a time."""
    cache = getattr(_zstd_tls, "c", None)
    if cache is None:
        cache = _zstd_tls.c = {}
    c = cache.get(level)
    if c is None:
        c = cache[level] = zstandard.ZstdCompressor(level=level)
    return c


def ref_payload(data: bytes) -> tuple[bytes, int, int]:
    """The reference-part repack decision (autocorrelation probe ->
    tuples), without the compression: -> (payload_to_compress, zstd_level,
    marker byte). reference: segment.h:218-255. One GIL-free native call
    (probe + repack) when available; the numpy twin below is the spec."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None and data:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = len(data)
        out = np.empty(n + 2, dtype=np.uint8)
        marker = ctypes.c_int32(0)
        m = lib.ref_payload_tuples(
            np.frombuffer(data, dtype=np.uint8).ctypes.data_as(u8p),
            n,
            out.ctypes.data_as(u8p),
            ctypes.byref(marker),
        )
        if m < 0:
            return data, 19, 0
        return out[:m].tobytes(), 13, int(marker.value)
    arr = np.frombuffer(data[:8192], dtype=np.uint8)
    best_frac = 0.0
    acgt = arr < 4
    for lag in range(4, 32):
        if lag >= len(arr):
            break
        cnt = int(np.count_nonzero(arr[:-lag] == arr[lag:]))
        cur = int(np.count_nonzero(acgt[:-lag]))
        frac = cnt / cur if cur else 0.0
        if frac > best_frac:
            best_frac = frac
            if best_frac >= 0.5:
                break
    if best_frac < 0.5:
        return bytes2tuples(data), 13, 1
    return data, 19, 0


def store_ref_blob(data: bytes, profile: str = "zstd") -> tuple[bytes, int]:
    """The full reference-part store decision (probe -> tuples repack ->
    compress -> raw fallback), shared by SegmentWriter and the profile
    converter so a converted archive is part-identical to a direct
    create. reference: segment.h:218-255."""
    payload, level, marker = ref_payload(data)
    z = part_compress(payload, level, profile) + bytes([marker])
    if len(z) < len(data):
        return z, len(data)
    return data, 0


def store_pack_blob(pack: bytes, profile: str = "zstd") -> tuple[bytes, int]:
    """Delta-pack store decision (compress -> raw fallback), shared with
    the profile converter."""
    z = part_compress(pack, 17, profile) + b"\x00"
    if len(z) < len(pack):
        return z, len(pack)
    return pack, 0


class SegmentWriter:
    """Accumulates one group's members and writes packs to the archive."""

    def __init__(
        self,
        name: str,
        writer,
        pack_cardinality: int,
        min_match_len: int,
        archive_version: int,
    ):
        self.name = name
        self.writer = writer
        self.pack = pack_cardinality
        self.min_match_len = min_match_len
        self.archive_version = archive_version
        self.profile = "zstd"  # archive profile; set by the compressor
        self.lz_mode = "classic"  # LZ decision rule; set by the compressor
        # tpu-rans deferred-entropy sink (entropy.EntropyBatcher); when
        # set, part payloads queue there for batched device encoding
        # instead of compressing inline
        self.entropy_batcher = None
        self.lz = LZDiff(min_match_len, v1_grammar=archive_version < 2000)
        self.no_seqs = 0
        self.v_lzp: list[bytes] = []
        self.v_raw: list[bytes] = []
        self.ref_size = 0
        self._ref_preset = False
        self._ref_hash = None  # blake2b-16 of the prepared reference
        self._ref_pending = None  # lazy preset (see preset_ref_lazy)
        self._ref_pending_lock = __import__("threading").Lock()
        # appending-mode rehydration state
        self._packed_ref: tuple[bytes, int] | None = None
        self._packed_delta: tuple[bytes, int] | None = None
        self._unpacked = True

    # -- store helpers ---------------------------------------------------

    def _store_ref(self, data: bytes) -> None:
        """reference: segment.h:218-255 (autocorrelation probe -> tuples).
        The 8 KiB probe sample in store_ref_blob decides the repacking
        mode as reliably as the whole segment and caps the probe at O(1)
        (reference probes the full segment: segment.h:218)."""
        stream = self.name + ss_ref_ext(self.archive_version)
        if self.entropy_batcher is not None:
            payload, _, marker = ref_payload(data)
            self.entropy_batcher.defer(stream, payload, marker, data)
            return
        blob, meta = store_ref_blob(data, self.profile)
        self.writer.add_part_buffered(stream, blob, meta)

    def _store_pack(self, items: list[bytes]) -> None:
        stream = self.name + ss_delta_ext(self.archive_version)
        pack = b"\xff".join(items) + b"\xff"
        if self.entropy_batcher is not None:
            self.entropy_batcher.defer(stream, pack, 0, pack)
            return
        blob, meta = store_pack_blob(pack, self.profile)
        self.writer.add_part_buffered(stream, blob, meta)

    # -- public ----------------------------------------------------------

    def add_raw(self, seq: bytes) -> int:
        self._ensure_unpacked()
        if len(self.v_raw) == self.pack:
            self._store_pack(self.v_raw)
            self.v_raw = []
        self.no_seqs += 1
        self.v_raw.append(bytes(seq))
        return self.no_seqs - 1

    def preset_ref(self, seq: bytes) -> None:
        """Prepare the LZ reference ahead of the store worker (cheap: one
        copy), so the matcher can estimate against this group without
        waiting for the async store. add() must NOT re-prepare afterwards
        (the matcher may be estimating concurrently)."""
        self.lz.prepare(seq)
        self.ref_size = len(seq) + 1
        self._ref_preset = True
        self._ref_hash = None

    def preset_ref_lazy(self, pending) -> None:
        """Zero-copy variant of preset_ref: record the group's reference
        WITHOUT materializing or preparing the LZ context. The matcher
        only needs ref_size immediately (readiness checks / candidate
        ranking by size); the two reference copies (materialize +
        lz.prepare) happen at first actual use — normally on the store
        worker, off the matcher's thread. ``pending`` is any object with
        ``materialize() -> bytes`` and ``size() -> int``."""
        self._ref_pending = pending
        self.ref_size = pending.size() + 1
        self._ref_preset = True
        self._ref_hash = None

    def ensure_ref(self) -> None:
        """Prepare the LZ reference from a lazy preset, once, from any
        thread (first user wins; the store worker and the matcher may
        race here). The pending marker is cleared only AFTER prepare
        completes: the native prepare releases the GIL, so a lock-free
        fast-path reader observing an early clear would use a
        half-prepared LZ context."""
        if self._ref_pending is None:
            return
        with self._ref_pending_lock:
            p = self._ref_pending
            if p is not None:
                self.lz.prepare(p.materialize())
                self._ref_pending = None

    def ref_bytes_for_index(self) -> bytes | None:
        """Reference codes for the device match bank without forcing the
        LZ context to prepare (a lazy preset materializes its bytes
        only)."""
        p = self._ref_pending
        if p is not None:
            return p.materialize()
        return self.lz.ref_bytes()

    def _ref_hash_now(self):
        """blake2b-16 of the prepared reference bytes (computed once per
        prepared reference; used to validate shard-shipped deltas)."""
        if self._ref_hash is None:
            import hashlib

            rb = self.lz.ref_bytes()
            if rb is None:
                return None
            self._ref_hash = hashlib.blake2b(rb, digest_size=16).digest()
        return self._ref_hash

    def add(self, seq: bytes, anchor_tab=None, delta_hint=None,
            ref_blob_hint=None) -> int:
        """LZ-encode vs the group reference (reference: segment.cpp:34-80).

        ``anchor_tab``: device-computed anchor tables for the anchor LZ
        mode (ops/match.py::anchor_tables); the emitted bytes are
        identical whether the tables come from the device or the host
        twin, so this argument never changes the archive.

        ``delta_hint``: (delta_bytes, ref_hash) computed by a shard
        against the boot-broadcast group reference; used instead of
        re-encoding ONLY when ref_hash matches this group's actual
        prepared reference (the delta is then the pure function of the
        same inputs, so the archive bytes are unchanged).

        ``ref_blob_hint``: (blob, meta, ref_hash) - the boot-
        precompressed reference part for this group's pk; stored
        directly iff this first member's bytes hash-match (store_ref_
        blob is deterministic, so the archive bytes are unchanged).
        Skipped under a deferred-entropy sink (tpu-rans profile)."""
        self._ensure_unpacked()
        if self.no_seqs == 0:
            self.ensure_ref()
            if not self._ref_preset:
                self.lz.prepare(seq)
                self._ref_hash = None
            seq_b = bytes(seq)
            used_blob = False
            if ref_blob_hint is not None and self.entropy_batcher is None:
                blob, meta, rh = ref_blob_hint
                if rh == self._ref_hash_now():
                    stream = self.name + ss_ref_ext(self.archive_version)
                    self.writer.add_part_buffered(stream, blob, meta)
                    used_blob = True
            if not used_blob:
                self._store_ref(seq_b)
            self.ref_size = len(seq) + 1
            self.no_seqs = 1
            return 0
        if len(self.v_lzp) == self.pack:
            self._store_pack(self.v_lzp)
            self.v_lzp = []
        delta = None
        if delta_hint is not None:
            self.ensure_ref()
            if delta_hint[1] == self._ref_hash_now():
                delta = delta_hint[0]
        if delta is None and self.lz_mode == "anchor":
            self.ensure_ref()
            delta = self.lz.encode_anchor(bytes(seq), tables=anchor_tab)
        if delta is None:
            delta = self.lz.encode(bytes(seq))
        if not delta:  # identical to reference
            return 0
        try:
            prev = self.v_lzp.index(delta)
            return self.no_seqs - (len(self.v_lzp) - prev)
        except ValueError:
            pass
        self.v_lzp.append(delta)
        self.no_seqs += 1
        return self.no_seqs - 1

    def estimate(self, seq: bytes, bound: int) -> int:
        # reference parity: a group still packed from appending_init has
        # ref_size 0 and estimates as 0 WITHOUT unpacking (CSegment::
        # estimate, segment.cpp:83-85) — the candidate searches see the
        # same zero the reference's do; pinned by
        # test_packed_group_costs_mirror_reference
        if self.ref_size == 0:
            return 0
        self._ensure_unpacked()
        self.ensure_ref()
        return self.lz.estimate(bytes(seq), bound)

    def get_coding_cost(self, seq: bytes, prefix_costs: bool) -> np.ndarray:
        # reference parity: a group still packed from appending_init has
        # ref_size 0 and yields NO costs (CSegment::get_coding_cost,
        # segment.cpp:103 — ref_size is only set by unpack); the
        # missing-middle search then bails / splits at 0 rather than
        # paying the unpack (agc_compressor.cpp:1605-1608)
        if self.ref_size == 0:
            return np.empty(0, dtype=np.uint32)
        self._ensure_unpacked()
        self.ensure_ref()
        return self.lz.get_coding_cost_vector(bytes(seq), prefix_costs)

    def get_ref_size(self) -> int:
        return self.ref_size

    def register_finish_stream(self) -> None:
        """Register the delta stream that finish() will write to, if it
        writes one. An appended group whose last pack is its only delta
        part has no registered stream until its finish: registering here,
        in group order, keeps stream ids independent of which thread's
        finish runs first."""
        if self.v_lzp or self.v_raw or self._packed_delta is not None:
            self.writer.register_stream(
                self.name + ss_delta_ext(self.archive_version)
            )

    def finish(self) -> None:
        self._ensure_unpacked()
        if self.v_lzp:
            self._store_pack(self.v_lzp)
            self.v_lzp = []
        if self.v_raw:
            self._store_pack(self.v_raw)
            self.v_raw = []

    # -- appending-mode rehydration (reference: segment.cpp:418-577) ----

    def appending_init(self, reader) -> None:
        ref_stream = self.name + ss_ref_ext(self.archive_version)
        delta_stream = self.name + ss_delta_ext(self.archive_version)
        have_ref = reader.has_stream(ref_stream)
        have_delta = reader.has_stream(delta_stream)
        if have_ref:
            data, meta = reader.get_part(ref_stream, 0)
            self.writer.add_part(ref_stream, data, meta)
            self._packed_ref = (data, meta)
            self.no_seqs = 1
        if have_delta:
            n = reader.n_parts(delta_stream)
            for i in range(n - 1):
                data, meta = reader.get_part(delta_stream, i)
                self.writer.add_part(delta_stream, data, meta)
                self.no_seqs += self.pack
            if n > 0:
                self._packed_delta = reader.get_part(delta_stream, n - 1)
        self._unpacked = False

    def _ensure_unpacked(self) -> None:
        if self._unpacked:
            return
        self._unpacked = True
        if self._packed_ref is not None:
            data, raw_size = self._packed_ref
            if raw_size == 0:
                ref = bytes(data)
            else:
                payload = zstd_decompress_tolerant(data[:-1])
                ref = tuples2bytes(payload) if data[-1] == 1 else payload
            self._packed_ref = None
            self.lz.prepare(ref)
            self.ref_size = len(ref) + 1
            self._ref_hash = None
        if self._packed_delta is not None:
            data, raw_size = self._packed_delta
            pack = bytes(data) if raw_size == 0 else zstd_decompress_tolerant(data)
            items = pack.split(b"\xff")[:-1]
            self._packed_delta = None
            if self.ref_size == 0:
                self.v_raw = items
            else:
                self.v_lzp = items
            self.no_seqs += len(items)
