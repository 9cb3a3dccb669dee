"""Archive profile conversion: zstd <-> tpu-rans, part-level transcode.

The two profiles share the container (streams / parts / footer — the
reference's CArchive layout, archive.h:27-206) and every raw payload;
only the entropy framing of compressed parts differs. Conversion
therefore never touches the LZ layer: each compressed part is decoded
with the self-identifying tolerant decoder and re-coded with the target
profile's coder at the level the stream's role pins (reference levels:
segment refs 13/19 by tuples marker, delta packs 17, collection streams
18/19; segment.h:252-254, collection_v3.cpp:163/192/246).

Stream ids, part order, part metadata, and raw (uncompressed-fallback)
parts are preserved exactly, so converting tpu-rans -> zstd yields an
archive whose streams are byte-identical to what a direct zstd-profile
run would have produced (tested), and which the reference binary's
layout expectations (collection streams at ids 0/1/2) still hold for.

Exposed on the CLI as ``agc-tpu convert`` (an agc-tpu extension; the
reference tool has no equivalent subcommand).
"""

from __future__ import annotations

from .archive import ArchiveReader, ArchiveWriter
from .segment import (
    part_compress,
    store_pack_blob,
    store_ref_blob,
    tuples2bytes,
    zstd_decompress_tolerant,
)

PROFILES = ("zstd", "tpu-rans")

_COLLECTION_LEVELS = {
    "collection-samples": 19,
    "collection-contigs": 18,
}


def _parse_file_type_info(data: bytes) -> dict[str, str]:
    d: dict[str, str] = {}
    fields = data.split(b"\x00")
    for i in range(0, len(fields) - 1, 2):
        d[fields[i].decode()] = fields[i + 1].decode()
    return d


def _serialize_file_type_info(d: dict[str, str]) -> bytes:
    v = bytearray()
    for key in sorted(d):
        v += key.encode() + b"\x00"
        v += d[key].encode() + b"\x00"
    return bytes(v)


def _transcode_frame(data: bytes, level: int, profile: str) -> bytes:
    return part_compress(zstd_decompress_tolerant(data), level, profile)


def _transcode_details(data: bytes, profile: str) -> bytes:
    """collection-details part: 5 x (raw,packed) prefix-varint headers +
    5 independently coded substreams (collection_v3.cpp:539-586)."""
    from .codecs import dec_prefix_varint, enc_prefix_varint

    pos = 0
    sizes = []
    for _ in range(5):
        raw, pos = dec_prefix_varint(data, pos)
        packed, pos = dec_prefix_varint(data, pos)
        sizes.append((raw, packed))
    blobs = []
    for raw, packed in sizes:
        payload = zstd_decompress_tolerant(data[pos : pos + packed])
        pos += packed
        blobs.append((raw, part_compress(payload, 19, profile)))
    out = bytearray()
    for raw, blob in blobs:
        enc_prefix_varint(out, raw)
        enc_prefix_varint(out, len(blob))
    for _, blob in blobs:
        out.extend(blob)
    return bytes(out)


def convert_archive(in_path: str, out_path: str, profile: str) -> None:
    """Rewrite ``in_path`` as ``out_path`` in the given profile."""
    if profile not in PROFILES:
        raise ValueError(f"unknown archive profile {profile!r}")
    reader = ArchiveReader(in_path, prefetch=True)
    try:
        part = reader.get_part("file_type_info", 0)
        if part is None:
            raise ValueError("not an AGC archive: missing file_type_info")
        fti = _parse_file_type_info(part[0])
        major = int(fti.get("file_version_major", "0"))
        if major < 3:
            raise ValueError(
                "profile conversion supports format 3.x archives only "
                f"(this archive is {major}.x; legacy archives are "
                "zstd-profile by definition)"
            )
        if profile == "zstd":
            fti.pop("compression-profile", None)
        else:
            fti["compression-profile"] = profile

        writer = ArchiveWriter(out_path)
        try:
            for name in reader.stream_names():  # original id order
                writer.register_stream(name)
                for pid in range(reader.n_parts(name)):
                    data, meta = reader.get_part(name, pid)
                    if name == "file_type_info":
                        writer.add_part(
                            name, _serialize_file_type_info(fti), len(fti)
                        )
                    elif name == "collection-details":
                        writer.add_part(
                            name, _transcode_details(data, profile), meta
                        )
                    elif name in _COLLECTION_LEVELS:
                        writer.add_part(
                            name,
                            _transcode_frame(
                                data, _COLLECTION_LEVELS[name], profile
                            ),
                            meta,
                        )
                    elif name.startswith("x") and name.endswith("r"):
                        # recover the reference SEQUENCE, then replay the
                        # writer's full store decision (probe -> tuples ->
                        # compress -> raw fallback): the raw-vs-compressed
                        # outcome can differ between profiles for tiny
                        # parts, and replaying keeps the conversion
                        # part-identical to a direct create
                        if meta == 0 and len(data) > 0:
                            seq = bytes(data)
                        elif meta == 0:
                            writer.add_part(name, data, meta)
                            continue
                        else:
                            payload = zstd_decompress_tolerant(data[:-1])
                            seq = (
                                tuples2bytes(payload)
                                if data[-1] == 1
                                else payload
                            )
                        blob, new_meta = store_ref_blob(seq, profile)
                        writer.add_part(name, blob, new_meta)
                    elif name.startswith("x") and name.endswith("d"):
                        if meta == 0 and len(data) == 0:
                            writer.add_part(name, data, meta)
                            continue
                        pack = (
                            bytes(data)
                            if meta == 0
                            else zstd_decompress_tolerant(data)
                        )
                        blob, new_meta = store_pack_blob(pack, profile)
                        writer.add_part(name, blob, new_meta)
                    else:
                        # params / splitters / segment-splitters / unknown:
                        # raw, copy verbatim
                        writer.add_part(name, data, meta)
        finally:
            writer.close()
    finally:
        reader.close()
