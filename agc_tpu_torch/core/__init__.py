"""Host layers and engine of the port: the archive container, the
collection, segments, LZ, zstd, FASTA IO, the decompressor and the
compressor. ``ArchiveReader`` and ``Decompressor`` are re-exported so that
callers read archives through one package."""

from .archive import ArchiveReader
from .decompressor import Decompressor

__all__ = ["ArchiveReader", "Decompressor"]
