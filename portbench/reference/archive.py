"""A frozen, standalone reader of AGC v3 archives (the zstd profile).

A copy of the container, collection and segment readers and of the LZ
decoder of the AGC format (AGC's src/common/archive.cpp, collection_v3.cpp,
segment.cpp and lz_diff.cpp, as the program under test also implements
them), kept here so that what decides ``correct`` does not move when the
program changes. It imports nothing of the program: zstd comes from the
system's ``libzstd.so.1`` and the LZ decoder is plain Python.

Besides the samples, it answers how the file's bytes are laid out
(``Container.unaccounted``), so the bytes that ``archive_ratio`` divides by
are known to be the archive's and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

NO_RAW_GROUPS = 16
N_CODE = 4
N_RUN_STARTER = 0x1E
MIN_NRUN_LEN = 4
SAME_COMPONENT_MARKER = 0x81
_B64 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_#"
_TUPLE_MULT = {4: 4, 3: 6, 2: 16}


class Corrupt(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def _zstd():
    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    return lib


def unzstd(data: bytes) -> bytes:
    """The first zstd frame of ``data`` (a marker byte may follow it)."""
    lib = _zstd()
    frame = lib.ZSTD_findFrameCompressedSize(data, len(data))
    if lib.ZSTD_isError(frame):
        raise Corrupt("not a zstd frame")
    size = lib.ZSTD_getFrameContentSize(data, frame)
    if size >= (1 << 64) - 2:
        raise Corrupt("zstd frame without a content size")
    dst = ctypes.create_string_buffer(max(1, size))
    got = lib.ZSTD_decompress(dst, size, data, frame)
    if lib.ZSTD_isError(got) or got != size:
        raise Corrupt("zstd frame does not decode")
    return dst.raw[:size]


def be_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = buf[pos]
    if n > 8 or pos + 1 + n > len(buf):
        raise Corrupt("truncated varint")
    return int.from_bytes(buf[pos + 1 : pos + 1 + n], "big"), pos + 1 + n


def prefix_varint(buf: bytes, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 - 0x80) << 8) + buf[pos + 1] + 0x80, pos + 2
    if b0 < 0xE0:
        return ((b0 - 0xC0) << 16) + int.from_bytes(buf[pos + 1 : pos + 3], "big") + 0x4080, pos + 3
    if b0 < 0xF0:
        return ((b0 - 0xE0) << 24) + int.from_bytes(buf[pos + 1 : pos + 4], "big") + 0x204080, pos + 4
    return int.from_bytes(buf[pos + 1 : pos + 5], "big") + 0x10204080, pos + 5


def cstr(buf: bytes, pos: int) -> tuple[bytes, int]:
    end = buf.index(0, pos)
    return buf[pos:end], end + 1


def zigzag_pred(x: int, prev: int) -> int:
    if x >= 2 * prev:
        return x
    if x & 1:
        return (2 * prev - x) // 2
    return (x + 2 * prev) // 2


class Container:
    """Named streams of parts with the footer index at the file's end."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        size = len(self.buf)
        if size < 8:
            raise Corrupt("too small")
        footer_size = int.from_bytes(self.buf[-8:], "little")
        if footer_size + 8 > size:
            raise Corrupt("footer")
        self.body_end = size - 8 - footer_size
        footer = self.buf[self.body_end : size - 8]
        self.streams: dict[str, list] = {}
        n_streams, pos = be_varint(footer, 0)
        for _ in range(n_streams):
            name, pos = cstr(footer, pos)
            n_parts, pos = be_varint(footer, pos)
            _raw, pos = be_varint(footer, pos)
            parts = []
            for _ in range(n_parts):
                off, pos = be_varint(footer, pos)
                sz, pos = be_varint(footer, pos)
                parts.append((off, sz))
            self.streams[name.decode("latin-1")] = parts
        if pos != len(footer):
            raise Corrupt("footer length")

    def part(self, name: str, i: int) -> tuple[bytes, int]:
        parts = self.streams.get(name)
        if parts is None or i >= len(parts):
            raise Corrupt(f"missing part {name}[{i}]")
        off, size = parts[i]
        if size == 0:
            return b"", 0
        meta, pos = be_varint(self.buf, off)
        if pos + size > self.body_end:
            raise Corrupt(f"part {name}[{i}] runs past the parts")
        return self.buf[pos : pos + size], meta

    def unaccounted(self) -> int:
        """Bytes before the footer that no part covers, plus bytes that two
        parts both claim: 0 when the parts tile the file exactly."""
        spans = []
        for parts in self.streams.values():
            for off, size in parts:
                if size:
                    _meta, pos = be_varint(self.buf, off)
                    spans.append((off, pos + size))
        spans.sort()
        bad, cur = 0, 0
        for start, end in spans:
            if start > cur:
                bad += start - cur
            elif start < cur:
                bad += min(cur, end) - start
            cur = max(cur, end)
        return bad + abs(self.body_end - cur)


def tuples_to_bytes(data: bytes) -> bytes:
    marker = data[-1]
    nb, trailing = marker >> 4, marker & 0xF
    if nb == 1:
        return data[:-1]
    if nb not in _TUPLE_MULT or len(data) < 2 or trailing >= nb:
        raise Corrupt("tuples marker")
    mult = _TUPLE_MULT[nb]
    packed = np.frombuffer(data, dtype=np.uint8)[: len(data) - 2].astype(np.uint32)
    cols = []
    for _ in range(nb):
        cols.append(packed % mult)
        packed = packed // mult
    out = np.stack(cols[::-1], axis=1).astype(np.uint8).reshape(-1).tobytes()
    c, tail = data[-2], bytearray(trailing)
    for j in range(trailing - 1, -1, -1):
        tail[j] = c % mult
        c //= mult
    return out + bytes(tail)


def _number(enc: bytes, i: int) -> tuple[int, int]:
    j = i
    while j < len(enc) and 0x30 <= enc[j] <= 0x39:
        j += 1
    if j == i:
        raise Corrupt("LZ token")
    return int(enc[i:j]), j


def lz_decode(ref: bytes, enc: bytes, min_match: int) -> bytes:
    """Replay an LZ-diff (V2 grammar) token stream against ``ref``."""
    out = bytearray()
    pred = 0
    i, n = 0, len(enc)
    while i < n:
        c = enc[i]
        if 0x41 <= c <= 0x55:  # literal symbol code
            out.append(c - 0x41)
            pred += 1
            i += 1
        elif c == 0x21:  # literal equal to the reference's symbol
            if pred >= len(ref):
                raise Corrupt("LZ literal past the reference")
            out.append(ref[pred])
            pred += 1
            i += 1
        elif c == N_RUN_STARTER:
            v, i = _number(enc, i + 1)
            if i >= n or enc[i] != N_CODE:
                raise Corrupt("N run")
            out.extend(bytes([N_CODE]) * (v + MIN_NRUN_LEN))
            i += 1
        else:
            neg = c == 0x2D
            v, i = _number(enc, i + 1 if neg else i)
            start = pred - v if neg else pred + v
            if i < n and enc[i] == 0x2C:
                ln, i = _number(enc, i + 1)
                ln += min_match
            else:
                ln = len(ref) - start
            if start < 0 or ln < 0 or start + ln > len(ref) or i >= n or enc[i] != 0x2E:
                raise Corrupt("LZ match")
            i += 1
            out.extend(ref[start : start + ln])
            pred = start + ln
    return bytes(out)


def _decode_split(prev: list, curr: list) -> tuple[bytes, list]:
    tokens = []
    for p, c in zip(prev, curr):
        if len(c) == 1 and c[0] == SAME_COMPONENT_MARKER:
            tokens.append(p)
            continue
        tok, at = bytearray(), 0
        for b in c:
            if b < 0x80:
                tok.append(b)
                at += 1
            else:
                tok.extend(p[at : at + 256 - b])
                at += 256 - b
        tokens.append(bytes(tok))
    return b" ".join(tokens), tokens


class Archive:
    """Samples, contigs, segments and splitters of one archive."""

    def __init__(self, path: str):
        self.c = Container(path)
        info, n_items = self.c.part("file_type_info", 0)
        fields = info.split(b"\x00")
        self.info = {fields[2 * i].decode(): fields[2 * i + 1].decode()
                     for i in range(n_items)}
        if self.info.get("file_version_major") != "3":
            raise Corrupt("not a v3 archive")
        params, _ = self.c.part("params", 0)
        self.k, self.min_match, self.pack, self.segment_size = (
            int.from_bytes(params[4 * i : 4 * i + 4], "little") for i in range(4))
        data, _ = self.c.part("collection-samples", 0)
        data = unzstd(data)
        n, pos = prefix_varint(data, 0)
        self.samples = []
        for _ in range(n):
            name, pos = cstr(data, pos)
            self.samples.append(name.decode())
        self._refs: dict[int, bytes] = {}
        self._packs: dict[tuple[int, int], list] = {}

    def splitters(self) -> np.ndarray:
        data, n = self.c.part("splitters", 0)
        if len(data) != 8 * n:
            raise Corrupt("splitters stream")
        return np.frombuffer(data, dtype="<u8").astype(np.uint64)

    def batch(self, b: int) -> list:
        """[(sample, [(contig, [(group, in_group, rc, raw_length)])])] of
        metadata batch ``b``."""
        data, _ = self.c.part("collection-contigs", b)
        data = unzstd(data)
        n_samples, pos = prefix_varint(data, 0)
        names = []
        for _ in range(n_samples):
            n_contigs, pos = prefix_varint(data, pos)
            prev, ctgs = [], []
            for _ in range(n_contigs):
                enc, pos = cstr(data, pos)
                curr = enc.split(b" ")
                if len(curr) != len(prev):
                    name, prev = enc, curr
                else:
                    name, prev = _decode_split(prev, curr)
                ctgs.append(name.decode())
            names.append(ctgs)
        stream, _ = self.c.part("collection-details", b)
        sizes, pos = [], 0
        for _ in range(5):
            raw, pos = prefix_varint(stream, pos)
            packed, pos = prefix_varint(stream, pos)
            sizes.append((raw, packed))
        subs = []
        for raw, packed in sizes:
            subs.append(unzstd(stream[pos : pos + packed]) if packed else b"")
            pos += packed
        counts, p0 = [], 0
        n, p0 = prefix_varint(subs[0], p0)
        for _ in range(n):
            nc, p0 = prefix_varint(subs[0], p0)
            row = []
            for _ in range(nc):
                ns, p0 = prefix_varint(subs[0], p0)
                row.append(ns)
            counts.append(row)
        total = sum(map(sum, counts))
        cols = []
        for d in subs[1:]:
            vals, p = [], 0
            for _ in range(total):
                v, p = prefix_varint(d, p)
                vals.append(v)
            cols.append(vals)
        out, idx, last = [], 0, {}
        pred_len = self.segment_size + self.k
        for s, row in enumerate(counts):
            ctgs = []
            for c, n_segs in enumerate(row):
                segs = []
                for _ in range(n_segs):
                    g, e = cols[0][idx], cols[1][idx]
                    prev = last.get(g, -1)
                    if prev == -1:
                        ig = e
                    elif e == 0:
                        ig = 0
                    elif e == 1:
                        ig = prev + 1
                    else:
                        ig = zigzag_pred(e - 1, prev + 1)
                    segs.append((g, ig, bool(cols[3][idx]), zigzag_pred(cols[2][idx], pred_len)))
                    if ig > prev and ig > 0:
                        last[g] = ig
                    idx += 1
                ctgs.append((names[s][c], segs))
            out.append(ctgs)
        return out

    def sample_layout(self) -> dict:
        """{sample: [(contig, segments)]} over every metadata batch."""
        out = {}
        for b in range(len(self.c.streams.get("collection-contigs", []))):
            for i, ctgs in enumerate(self.batch(b)):
                out[self.samples[b * self.pack + i]] = ctgs
        return out

    def _stream(self, g: int) -> str:
        digits, n = [], g
        while True:
            digits.append(_B64[n & 0x3F])
            n //= 64
            if not n:
                return "x" + "".join(digits)

    def _ref(self, g: int) -> bytes:
        if g not in self._refs:
            data, raw = self.c.part(self._stream(g) + "r", 0)
            if raw:
                payload = unzstd(data[:-1])
                data = tuples_to_bytes(payload) if data[-1] == 1 else payload
            self._refs[g] = data
        return self._refs[g]

    def _pack_items(self, g: int, part: int) -> list:
        key = (g, part)
        if key not in self._packs:
            data, raw = self.c.part(self._stream(g) + "d", part)
            pack = unzstd(data) if raw else data
            self._packs[key] = pack.split(b"\xff")[:-1]
        return self._packs[key]

    def segment(self, g: int, ig: int) -> bytes:
        if g < NO_RAW_GROUPS:
            return self._pack_items(g, ig // self.pack)[ig % self.pack]
        if ig == 0:
            return self._ref(g)
        delta = self._pack_items(g, (ig - 1) // self.pack)[(ig - 1) % self.pack]
        return lz_decode(self._ref(g), delta, self.min_match)

    def contig(self, segments) -> np.ndarray:
        """The contig that ``segments`` assemble: k symbols of overlap."""
        pieces = []
        for g, ig, rc, _raw_len in segments:
            s = np.frombuffer(self.segment(g, ig), dtype=np.uint8)
            if rc:
                s = s[::-1].copy()
                acgt = s < 4
                s[acgt] = 3 - s[acgt]
            pieces.append(s if not pieces else s[self.k:])
        return np.concatenate(pieces) if pieces else np.empty(0, np.uint8)
