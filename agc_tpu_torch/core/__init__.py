"""Engine of the port (``compressor``). The archive container and the
decompressor are host code shared with agc_tpu; they are re-exported here
so that callers of the port read archives through one package."""

from agc_tpu.core.archive import ArchiveReader
from agc_tpu.core.decompressor import Decompressor

__all__ = ["ArchiveReader", "Decompressor"]
