"""Minimal ``zstandard`` stand-in over the system ``libzstd.so.1`` (ctypes).

The port's host modules (``core/segment.py``, ``core/collection.py``) use
exactly two call shapes of the ``zstandard`` package:

    zstandard.ZstdCompressor(level=L).compress(data)
    zstandard.ZstdDecompressor().decompressobj().decompress(data)

This module provides those two shapes and nothing else. ``core/zstd.py``
uses it only when the real package cannot be imported. Both write and
read standard zstd frames, so archives stay readable by either.
"""

from __future__ import annotations

import ctypes

__version__ = "libzstd-ctypes"

_lib = ctypes.CDLL("libzstd.so.1")
_lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
_lib.ZSTD_compressBound.restype = ctypes.c_size_t
_lib.ZSTD_compress.argtypes = [
    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
    ctypes.c_int,
]
_lib.ZSTD_compress.restype = ctypes.c_size_t
_lib.ZSTD_decompress.argtypes = [
    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
]
_lib.ZSTD_decompress.restype = ctypes.c_size_t
_lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
_lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
_lib.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
_lib.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
_lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
_lib.ZSTD_isError.restype = ctypes.c_uint
_lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
_lib.ZSTD_getErrorName.restype = ctypes.c_char_p

# ZSTD_CONTENTSIZE_UNKNOWN / _ERROR (zstd.h)
_SIZE_UNKNOWN = (1 << 64) - 1
_SIZE_ERROR = (1 << 64) - 2


class ZstdError(Exception):
    pass


def _check(code: int) -> int:
    if _lib.ZSTD_isError(code):
        raise ZstdError(_lib.ZSTD_getErrorName(code).decode())
    return code


class ZstdCompressor:
    def __init__(self, level: int = 3):
        self._level = int(level)

    def compress(self, data) -> bytes:
        src = bytes(data)
        bound = _lib.ZSTD_compressBound(len(src))
        dst = ctypes.create_string_buffer(bound)
        n = _check(_lib.ZSTD_compress(dst, bound, src, len(src), self._level))
        return dst.raw[:n]


class _DecompressObj:
    def decompress(self, data) -> bytes:
        """Decode the first frame of ``data``; trailing bytes are ignored
        (the reference appends a marker byte after each frame)."""
        src = bytes(data)
        frame = _check(_lib.ZSTD_findFrameCompressedSize(src, len(src)))
        size = _lib.ZSTD_getFrameContentSize(src, frame)
        if size in (_SIZE_UNKNOWN, _SIZE_ERROR):
            raise ZstdError("zstd frame without a content size")
        dst = ctypes.create_string_buffer(max(1, size))
        n = _check(_lib.ZSTD_decompress(dst, size, src, frame))
        return dst.raw[:n]


class ZstdDecompressor:
    def decompressobj(self) -> _DecompressObj:
        return _DecompressObj()
