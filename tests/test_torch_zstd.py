"""The port's libzstd bridge (agc_tpu_torch._zstd), used where the
``zstandard`` package is missing: its frames decode with ``zstandard``
and the other way round, in the two call shapes the host modules use."""

import os

import pytest
import zstandard

from agc_tpu_torch import _zstd

PAYLOADS = [b"", b"A", b"ACGT" * 5000, os.urandom(70000), bytes(range(256)) * 300]


@pytest.mark.parametrize("level", [1, 13, 19])
@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_frames_interoperate(level, i):
    data = PAYLOADS[i]
    ours = _zstd.ZstdCompressor(level=level).compress(data)
    theirs = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(ours) == data
    assert _zstd.ZstdDecompressor().decompressobj().decompress(theirs) == data
    # trailing bytes after the frame are ignored, as the readers need
    assert _zstd.ZstdDecompressor().decompressobj().decompress(theirs + b"\x00") == data


def test_corrupt_frame_raises():
    with pytest.raises(_zstd.ZstdError):
        _zstd.ZstdDecompressor().decompressobj().decompress(b"\x28\xb5\x2f\xfd\xff")
