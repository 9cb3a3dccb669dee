"""Byte-level codecs shared across the archive and metadata layers.

Formats are bit-compatible with the reference tool so that archives can be
cross-read (reference: src/common/archive.h:101-157, src/common/collection.h:100-217,
src/common/utils.h:95-145, src/common/utils.cpp:32-102).
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# Archive footer integer codec: 1 length byte + big-endian payload bytes.
# (reference: archive.h write/read templates, archive.h:110-157)
# ---------------------------------------------------------------------------


def enc_be_varint(x: int) -> bytes:
    """Encode as <n_bytes:u8><big-endian bytes>; 0 encodes as a single 0x00."""
    if x == 0:
        return b"\x00"
    payload = x.to_bytes((x.bit_length() + 7) // 8, "big")
    return bytes([len(payload)]) + payload


def dec_be_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Decode; returns (value, new_pos)."""
    n = buf[pos]
    pos += 1
    if n > 8 or pos + n > len(buf):
        # a truncated buffer would silently decode a short slice as a
        # smaller value (int.from_bytes(b'') == 0) — that turns corrupt
        # footers into plausible-looking empty archives
        raise ValueError("Corrupted archive! (truncated varint)")
    x = int.from_bytes(buf[pos : pos + n], "big")
    return x, pos + n


# ---------------------------------------------------------------------------
# Collection prefix varint (reference: collection.h:100-217).
# Thresholds are cumulative: 1/2/3/4/5-byte ranges.
# ---------------------------------------------------------------------------

_THR_1 = 1 << 7
_THR_2 = _THR_1 + (1 << 14)
_THR_3 = _THR_2 + (1 << 21)
_THR_4 = _THR_3 + (1 << 28)

_PREF_2 = 0b1000_0000
_PREF_3 = 0b1100_0000
_PREF_4 = 0b1110_0000
_PREF_5 = 0b1111_0000

_MASK_1 = 0b1000_0000
_MASK_2 = 0b1100_0000
_MASK_3 = 0b1110_0000
_MASK_4 = 0b1111_0000


def enc_prefix_varint(out: bytearray, num: int) -> None:
    """Append the prefix varint encoding of ``num`` (u32) to ``out``."""
    if num < _THR_1:
        out.append(num)
    elif num < _THR_2:
        num -= _THR_1
        out.append(_PREF_2 + (num >> 8))
        out.append(num & 0xFF)
    elif num < _THR_3:
        num -= _THR_2
        out.append(_PREF_3 + (num >> 16))
        out.append((num >> 8) & 0xFF)
        out.append(num & 0xFF)
    elif num < _THR_4:
        num -= _THR_3
        out.append(_PREF_4 + (num >> 24))
        out.append((num >> 16) & 0xFF)
        out.append((num >> 8) & 0xFF)
        out.append(num & 0xFF)
    else:
        num -= _THR_4
        out.append(_PREF_5)
        out.append((num >> 24) & 0xFF)
        out.append((num >> 16) & 0xFF)
        out.append((num >> 8) & 0xFF)
        out.append(num & 0xFF)


def dec_prefix_varint(buf, pos: int) -> tuple[int, int]:
    """Decode a prefix varint at ``pos``; returns (value, new_pos)."""
    b0 = buf[pos]
    if (b0 & _MASK_1) == 0:
        return b0, pos + 1
    if (b0 & _MASK_2) == _PREF_2:
        num = ((b0 - _PREF_2) << 8) + buf[pos + 1] + _THR_1
        return num, pos + 2
    if (b0 & _MASK_3) == _PREF_3:
        num = ((b0 - _PREF_3) << 16) + (buf[pos + 1] << 8) + buf[pos + 2] + _THR_2
        return num, pos + 3
    if (b0 & _MASK_4) == _PREF_4:
        num = (
            ((b0 - _PREF_4) << 24)
            + (buf[pos + 1] << 16)
            + (buf[pos + 2] << 8)
            + buf[pos + 3]
            + _THR_3
        )
        return num, pos + 4
    num = (
        (buf[pos + 1] << 24)
        + (buf[pos + 2] << 16)
        + (buf[pos + 3] << 8)
        + buf[pos + 4]
        + _THR_4
    )
    return num, pos + 5


def read_cstr(buf, pos: int) -> tuple[bytes, int]:
    """Read a NUL-terminated byte string; returns (bytes, new_pos)."""
    end = buf.index(0, pos)
    return bytes(buf[pos:end]), end + 1


# ---------------------------------------------------------------------------
# Zigzag-vs-prediction (reference: utils.h:113-135)
# ---------------------------------------------------------------------------


def zigzag_encode(x: int) -> int:
    """Plain zigzag (reference: utils.h:95-101)."""
    return 2 * x if x >= 0 else 2 * (-x) - 1


def zigzag_decode(x: int) -> int:
    if x & 1:
        return -((x + 1) // 2)
    return x // 2


def zigzag_encode_pred(x_curr: int, x_prev: int) -> int:
    if x_curr < x_prev:
        return 2 * (x_prev - x_curr) - 1
    if x_curr < 2 * x_prev:
        return 2 * (x_curr - x_prev)
    return x_curr


def zigzag_decode_pred(x_val: int, x_prev: int) -> int:
    if x_val >= 2 * x_prev:
        return x_val
    if x_val & 1:
        return (2 * x_prev - x_val) // 2
    return (x_val + 2 * x_prev) // 2


# ---------------------------------------------------------------------------
# Stream naming (reference: utils.cpp:32-102).
# v3 names: "x" + base64(group) + "r"/"d"; v1/v2: "seg-<n>-ref"/"-delta".
# ---------------------------------------------------------------------------

_B64_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_#"


def int_to_base64(n: int) -> str:
    res = []
    while True:
        res.append(_B64_DIGITS[n & 0x3F])
        n //= 64
        if not n:
            break
    return "".join(res)


def ss_prefix(archive_version: int) -> str:
    return "seg-" if archive_version < 3000 else "x"


def ss_base(archive_version: int, n: int) -> str:
    return f"seg-{n}" if archive_version < 3000 else "x" + int_to_base64(n)


def ss_ref_name(archive_version: int, n: int) -> str:
    return ss_base(archive_version, n) + ss_ref_ext(archive_version)


def ss_delta_name(archive_version: int, n: int) -> str:
    return ss_base(archive_version, n) + ss_delta_ext(archive_version)


def ss_ref_ext(archive_version: int) -> str:
    return "-ref" if archive_version < 3000 else "r"


def ss_delta_ext(archive_version: int) -> str:
    return "-delta" if archive_version < 3000 else "d"


# ---------------------------------------------------------------------------
# MurMur3 finalizers (reference: utils.h:148-225)
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def murmur64(h: int) -> int:
    h &= _U64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _U64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _U64
    h ^= h >> 33
    return h


def fixed_u32(x: int) -> bytes:
    return struct.pack("<I", x)


def fixed_u64(x: int) -> bytes:
    return struct.pack("<Q", x)
