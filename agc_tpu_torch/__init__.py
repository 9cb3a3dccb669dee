"""agc-tpu on PyTorch and CUDA: the create path on an NVIDIA GPU.

A package of its own beside agc_tpu: it keeps agc_tpu's archive format and
carries its own copies of the host layers (segment matching, LZ, zstd,
container, collection, decompression, the CLI). The device ops
(``agc_tpu_torch.ops``) are hand-written CUDA kernels with plain PyTorch
versions, called by the engine (``agc_tpu_torch.core.compressor``). It
imports neither JAX nor any module of agc_tpu.

Every entry point takes ``device`` (default ``"cuda"``); ``"cuda"``
without a CUDA device raises, and the CPU runs the kernels' plain PyTorch
versions only when a caller asks for it.
"""

# allocator tuning first: large-buffer arena retention (see
# utils/allocator.py; AGC_TPU_MALLOC_TUNE=0 opts out)
from .utils.allocator import tune_allocator as _tune_allocator

_tune_allocator()

from .version import (  # noqa: E402
    AGC_FILE_MAJOR,
    AGC_FILE_MINOR,
    PRODUCER,
    PRODUCER_VERSION,
)
from .api import AGCFile  # noqa: E402

__all__ = [
    "AGCFile",
    "AGC_FILE_MAJOR",
    "AGC_FILE_MINOR",
    "PRODUCER",
    "PRODUCER_VERSION",
]
