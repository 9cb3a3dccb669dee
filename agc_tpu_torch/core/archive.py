"""AGC archive container: named streams of parts with a trailing footer index.

Bit-compatible with the reference container (reference: src/common/archive.{h,cpp})
so archives interoperate with the reference tool in both directions:

File layout (reference: archive.cpp:280-293, 142-214):
    [part]* [footer] [footer_size: 8-byte little-endian]
    part   = <metadata: be-varint> <blob bytes>
    footer = <n_streams: be-varint>
             for each stream:
                <name: NUL-terminated> <n_parts: be-varint> <raw_size: be-varint>
                for each part: <offset: be-varint> <size: be-varint>
    be-varint = 1 length byte + big-endian payload (codecs.enc_be_varint)

Part ``size`` excludes the metadata varint; ``offset`` points at the metadata.
A part with size == 0 is read back with metadata treated as 0
(reference: archive.cpp:389-396).
"""

from __future__ import annotations

import io
import os
import threading
from dataclasses import dataclass, field

from .codecs import dec_be_varint, enc_be_varint, read_cstr


@dataclass
class _Stream:
    name: str
    parts: list = field(default_factory=list)  # list[(offset, size)]
    raw_size: int = 0
    packed_size: int = 0
    packed_data_size: int = 0


class ArchiveReader:
    """Random access reader for AGC archives.

    ``prefetch=True`` buffers the whole file in memory (reference: io.h:77-78,
    agc_basic.cpp:57).
    """

    def __init__(self, path: str, prefetch: bool = True):
        self._path = path
        self._lock = threading.Lock()
        if prefetch:
            with open(path, "rb") as f:
                self._buf = f.read()
            self._f = None
        else:
            self._f = open(path, "rb")
            self._buf = None
        self._streams: list[_Stream] = []
        self._by_name: dict[str, int] = {}
        self._deserialize()

    # -- low-level --

    def _read_at(self, offset: int, size: int) -> bytes:
        if self._buf is not None:
            return self._buf[offset : offset + size]
        with self._lock:
            self._f.seek(offset)
            return self._f.read(size)

    def _file_size(self) -> int:
        if self._buf is not None:
            return len(self._buf)
        return os.fstat(self._f.fileno()).st_size

    def _deserialize(self) -> None:
        fsize = self._file_size()
        if fsize < 8:
            raise ValueError(f"{self._path}: not an AGC archive (too small)")
        footer_size = int.from_bytes(self._read_at(fsize - 8, 8), "little")
        if footer_size + 8 > fsize:
            raise ValueError(f"{self._path}: corrupted archive footer")
        footer = self._read_at(fsize - 8 - footer_size, footer_size)
        pos = 0
        n_streams, pos = dec_be_varint(footer, pos)
        for _ in range(n_streams):
            raw_name, pos = read_cstr(footer, pos)
            n_parts, pos = dec_be_varint(footer, pos)
            raw_size, pos = dec_be_varint(footer, pos)
            parts = []
            for _ in range(n_parts):
                off, pos = dec_be_varint(footer, pos)
                sz, pos = dec_be_varint(footer, pos)
                parts.append((off, sz))
            s = _Stream(name=raw_name.decode("latin-1"), parts=parts, raw_size=raw_size)
            self._by_name[s.name] = len(self._streams)
            self._streams.append(s)

    # -- public --

    def stream_names(self) -> list[str]:
        return [s.name for s in self._streams]

    def has_stream(self, name: str) -> bool:
        return name in self._by_name

    def n_parts(self, name: str) -> int:
        sid = self._by_name.get(name)
        if sid is None:
            return 0
        return len(self._streams[sid].parts)

    def get_part(self, name: str, part_id: int) -> tuple[bytes, int] | None:
        """Return (data, metadata) for the given part, or None.

        Random-access only (the reference's sequential-cursor mode,
        archive.cpp:378-403, had no callers here and its unlocked cursor
        would race under the threaded decode pools)."""
        sid = self._by_name.get(name)
        if sid is None:
            return None
        s = self._streams[sid]
        if part_id >= len(s.parts):
            return None
        off, size = s.parts[part_id]
        if size == 0:
            return b"", 0
        # metadata varint precedes the blob; max 9 bytes
        head = self._read_at(off, min(9 + size, self._file_size() - off))
        metadata, mpos = dec_be_varint(head, 0)
        if mpos + size <= len(head):
            data = head[mpos : mpos + size]
        else:
            data = self._read_at(off + mpos, size)
        return bytes(data), metadata

    def stream_packed_size(self, name: str) -> int:
        """Total on-disk bytes of a stream's parts (data + metadata varints)."""
        sid = self._by_name.get(name)
        if sid is None:
            return 0
        total = 0
        for off, size in self._streams[sid].parts:
            if size == 0:
                continue
            head = self._read_at(off, 9)
            _, mpos = dec_be_varint(head, 0)
            total += mpos + size
        return total

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArchiveWriter:
    """Append-only archive writer (reference: archive.cpp output mode).

    Thread-safe; ``add_part_buffered`` defers writes so they can be flushed
    in deterministic stream order at barriers (reference: archive.cpp:332-359).
    """

    def __init__(self, path: str, buffer_size: int = 32 << 20):
        self._path = path
        self._f = open(path, "wb", buffering=buffer_size)
        self._lock = threading.Lock()
        self._offset = 0
        self._streams: list[_Stream] = []
        self._by_name: dict[str, int] = {}
        self._buffered: dict[int, list[tuple[bytes, int]]] = {}
        self._closed = False

    def register_stream(self, name: str) -> int:
        with self._lock:
            return self._register(name)

    def _register(self, name: str) -> int:
        sid = self._by_name.get(name)
        if sid is not None:
            return sid
        sid = len(self._streams)
        self._streams.append(_Stream(name=name))
        self._by_name[name] = sid
        return sid

    def get_stream_id(self, name: str) -> int:
        with self._lock:
            return self._by_name.get(name, -1)

    def _add_part(self, sid: int, data: bytes, metadata: int) -> None:
        s = self._streams[sid]
        s.parts.append((self._offset, len(data)))
        meta = enc_be_varint(metadata)
        self._f.write(meta)
        self._f.write(data)
        written = len(meta) + len(data)
        self._offset += written
        s.packed_size += written
        s.packed_data_size += len(data)

    def add_part(self, name_or_id, data: bytes, metadata: int = 0) -> None:
        with self._lock:
            sid = self._register(name_or_id) if isinstance(name_or_id, str) else name_or_id
            self._add_part(sid, data, metadata)

    def add_part_buffered(self, name_or_id, data: bytes, metadata: int = 0) -> None:
        with self._lock:
            sid = self._register(name_or_id) if isinstance(name_or_id, str) else name_or_id
            self._buffered.setdefault(sid, []).append((bytes(data), metadata))

    def flush_buffers(self) -> None:
        with self._lock:
            for sid in sorted(self._buffered):
                for data, metadata in self._buffered[sid]:
                    self._add_part(sid, data, metadata)
            self._buffered.clear()

    def n_parts(self, name: str) -> int:
        with self._lock:
            sid = self._by_name.get(name)
            if sid is None:
                return 0
            n = len(self._streams[sid].parts)
            n += len(self._buffered.get(sid, ()))
            return n

    def stream_packed_size(self, name: str) -> int:
        with self._lock:
            sid = self._by_name.get(name)
            return self._streams[sid].packed_size if sid is not None else 0

    def close(self) -> None:
        if self._closed:
            return
        self.flush_buffers()
        with self._lock:
            footer = io.BytesIO()
            footer.write(enc_be_varint(len(self._streams)))
            for s in self._streams:
                footer.write(s.name.encode("latin-1") + b"\x00")
                footer.write(enc_be_varint(len(s.parts)))
                footer.write(enc_be_varint(s.raw_size))
                for off, size in s.parts:
                    footer.write(enc_be_varint(off))
                    footer.write(enc_be_varint(size))
            blob = footer.getvalue()
            self._f.write(blob)
            self._f.write(len(blob).to_bytes(8, "little"))
            self._f.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
