"""agc-tpu on PyTorch and CUDA: the create path on an NVIDIA GPU.

The port keeps agc_tpu's archive format and host layers (segment matching,
LZ, zstd, container, collection, decompression) and imports them as they
are; what it rewrites are the device ops (``agc_tpu_torch.ops``) and the
engine class that calls them (``agc_tpu_torch.core.compressor``). It never
imports JAX.

Every entry point takes ``device`` (default ``"cuda"``); ``"cuda"``
without a CUDA device raises, and the CPU runs the kernels' plain PyTorch
versions only when a caller asks for it.
"""

try:
    import zstandard as _zstandard  # noqa: F401
except ImportError:
    # the host modules import zstandard at module level: register the
    # libzstd bridge before anything from agc_tpu.core is imported
    import sys as _sys

    from . import _zstd

    _sys.modules["zstandard"] = _zstd

from agc_tpu.version import (  # noqa: E402
    AGC_FILE_MAJOR,
    AGC_FILE_MINOR,
    PRODUCER,
    PRODUCER_VERSION,
)
from agc_tpu.api import AGCFile  # noqa: E402

__all__ = [
    "AGCFile",
    "AGC_FILE_MAJOR",
    "AGC_FILE_MINOR",
    "PRODUCER",
    "PRODUCER_VERSION",
]
