"""FASTA input/output (plain and gzip), numeric symbol conversion.

reference: src/core/genome_io.{h,cpp}, src/common/agc_basic.h:40-50,
src/common/agc_decompressor_lib.cpp:532-645.

Sequences are held numerically: A,C,G,T=0..3, N=4, IUPAC ambiguity codes
5..15, anything else = 30.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
import zlib

import numpy as np

# numeric -> ascii (reference: agc_basic.h:40-50)
CNV_NUM = np.full(128, ord(" "), dtype=np.uint8)
for _i, _c in enumerate("ACGTNRYSWKMBDHVU"):
    CNV_NUM[_i] = ord(_c)

# ascii -> numeric for bytes >= 64 (preprocessing drops bytes < 64 and
# refuses any code > 15 — see preprocess_raw_contig). 255 marks bytes the
# reference's table doesn't cover (>= 128): also refused.
CNV_ASCII = np.full(256, 255, dtype=np.uint8)
# reference cnv_num row for bytes 64..95 / 96..127 (agc_basic.h:40-50):
# IUPAC letters map to 0..15, non-IUPAC letters to 30, '@'/'`' to 32
_REF_ROW = [
    ord(" "), 0, 11, 1, 12, 30, 30, 2, 13, 30, 30, 9, 30, 10, 4, 30,
    30, 30, 5, 7, 3, 15, 14, 8, 30, 6, 30, 30, 30, 30, 30, 30,
]
for _o in range(32):
    CNV_ASCII[64 + _o] = _REF_ROW[_o]
    CNV_ASCII[96 + _o] = _REF_ROW[_o]


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_contigs_raw(path: str):
    """Yield (id, raw_bytes) per contig; id = full header line after '>'
    (reference: genome_io.cpp:208-252). Raw bytes still contain newlines."""
    with _open_maybe_gz(path) as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        # find header start
        nl = data.find(b"\n", pos)
        line_end = nl if nl >= 0 else n
        header = data[pos:line_end]
        if header.endswith(b"\r"):
            header = header[:-1]
        if not header.startswith(b">"):
            # skip garbage until next '>'
            nxt = data.find(b">", pos)
            if nxt < 0:
                return
            pos = nxt
            continue
        cid = header[1:].decode("utf-8", "replace")
        body_start = line_end + 1
        # ANY '>' ends the record, even mid-line — exact reference parity
        # (CGenomeIO::find_contig_end scans for the bare character,
        # genome_io.cpp:261-264), so malformed bodies split identically
        nxt = data.find(b">", body_start)
        body_end = nxt if nxt >= 0 else n
        pos = body_end
        if cid and body_end > body_start:
            # zero-copy view; preprocess_raw_contig handles ndarray input
            yield cid, np.frombuffer(
                data, dtype=np.uint8, count=body_end - body_start,
                offset=body_start,
            )


def preprocess_raw_contig(raw, label: str = "") -> np.ndarray:
    """ASCII FASTA body (bytes or uint8 ndarray view) -> numeric codes;
    keeps only bytes >= 64 (reference: agc_compressor.cpp:907-951). Uses
    the GIL-free C++ fast path when the native library is available.

    Rejects symbols outside the 16-letter IUPAC alphabet with a clean
    error: the archive format cannot represent the reference's
    catch-all code 30 in an LZ delta (literal tokens span codes 0..20,
    lz_diff.h:193), so the reference tool writes such input silently and
    then CRASHES extracting it (verified: heap overflow under ASan).
    Refusing at create time is the only lossless behavior."""
    from ..native import get_lib

    arr = (
        raw
        if isinstance(raw, np.ndarray)
        else np.frombuffer(raw, dtype=np.uint8)
    )
    lib = get_lib()
    if lib is not None:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = len(arr)
        out = np.empty(n, dtype=np.uint8)
        bad = ctypes.c_int64(-1)
        m = lib.fasta_preprocess2(
            arr.ctypes.data_as(u8p),
            n,
            CNV_ASCII.ctypes.data_as(u8p),
            out.ctypes.data_as(u8p),
            ctypes.byref(bad),
        )
        if bad.value < 0:
            return out[:m]
        idx = int(bad.value)  # validity check fused into the native pass
    else:
        codes = CNV_ASCII[arr[arr >= 64]]
        if not len(codes) or int(codes.max()) <= 15:
            return codes
        idx = int(np.argmax(codes > 15))
    orig = int(arr[arr >= 64][idx])
    where = f" in contig {label!r}" if label else ""
    raise ValueError(
        f"symbol {chr(orig)!r} at position {idx}{where} is outside "
        "the IUPAC alphabet (ACGTNRYSWKMBDHVU/acgtn...); the AGC "
        "format cannot store it losslessly (the reference tool "
        "crashes extracting such archives) - clean the input"
    )


def contig_to_ascii(ctg: np.ndarray) -> bytes:
    return CNV_NUM[ctg & 0x7F].tobytes()


def contig_to_fasta_body(ctg: np.ndarray, line_len: int) -> bytes:
    """Numeric contig -> line-wrapped ASCII body in one pass (GIL-free C++
    when available; reference: convert_and_split_into_lines,
    agc_decompressor_lib.cpp:562-645)."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        n = len(ctg)
        cap = n + (n // max(line_len, 1) if line_len else 0) + 2
        out = np.empty(cap, dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        m = lib.numeric_to_fasta(
            np.ascontiguousarray(ctg).ctypes.data_as(u8p),
            n,
            CNV_NUM.ctypes.data_as(u8p),
            line_len,
            out.ctypes.data_as(u8p),
        )
        return out[:m].tobytes()
    return wrap_lines(contig_to_ascii(ctg), line_len)


def wrap_lines(seq_ascii: bytes, line_len: int) -> bytes:
    """Split into lines of ``line_len``, each (incl. the last) newline-
    terminated (reference: agc_decompressor_lib.cpp:562-645).

    Vectorized: full lines are emitted via one (rows, line_len+1) matrix
    write instead of a per-line Python loop."""
    if not seq_ascii:
        return b""
    if line_len == 0:
        # unwrapped body still ends with one newline (matches the native
        # numeric_to_fasta and the streaming sink)
        return seq_ascii + b"\n"
    arr = np.frombuffer(seq_ascii, dtype=np.uint8)
    n = len(arr)
    rows = n // line_len
    body = b""
    if rows:
        mat = np.empty((rows, line_len + 1), dtype=np.uint8)
        mat[:, :line_len] = arr[: rows * line_len].reshape(rows, line_len)
        mat[:, line_len] = ord("\n")
        body = mat.tobytes()
    tail = arr[rows * line_len :]
    if len(tail):
        body += tail.tobytes() + b"\n"
    return body


class FastaWriter:
    """Writes contigs to a file / stdout, optionally as concatenated gzip
    members (one per header/body, mirroring the reference's -g output;
    agc_decompressor.cpp:29-38, genome_io.cpp:331-351)."""

    def __init__(self, path: str | None, gzip_level: int = 0):
        self.gzip_level = gzip_level
        if path is None or path == "":
            self.f = sys.stdout.buffer
            self._own = False
        else:
            self.f = open(path, "wb")
            self._own = True

    def _gzip_member(self, data: bytes, level: int) -> bytes:
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=max(1, level), mtime=0) as g:
            g.write(data)
        return buf.getvalue()

    def save_contig_directly(self, name: str, body: bytes) -> None:
        header = b">" + name.encode("utf-8") + b"\n"
        if self.gzip_level:
            self.f.write(self._gzip_member(header, 1))
            self.f.write(body)  # body already gzipped by caller
        else:
            self.f.write(header)
            self.f.write(body)

    def gzip_body(self, body: bytes) -> bytes:
        return self._gzip_member(body, self.gzip_level)

    def close(self) -> None:
        if self._own:
            self.f.close()
        else:
            self.f.flush()


def sample_name_from_path(path: str) -> str:
    """File stem with compression/FASTA suffixes stripped
    (reference: application.cpp:606-633, main.cpp:108-110)."""
    name = os.path.basename(path)
    # drop the last extension (path stem), then strip known suffixes
    stem, _, _ = name.rpartition(".")
    if stem:
        name = stem
    while True:
        for suf in (".fna", ".gz", ".fa", ".fasta"):
            if len(name) > len(suf) and name.endswith(suf):
                name = name[: -len(suf)]
                break
        else:
            break
    return name
