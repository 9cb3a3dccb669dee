"""glibc allocator tuning for the compression pipeline.

Every create allocates hundreds of MB of large transient numpy buffers
(code arrays, k-mer pools, pending segment buffers). glibc's default
M_MMAP_THRESHOLD (dynamic, capped at 32 MB) routes them through mmap and
free() munmaps immediately — so every run re-pays first-touch page
faults + kernel page zeroing for its whole working set, gigabytes per
create, with THP/compaction adding jitter. Measured on the bench box
(1 core): host-pinned 134 Mbase creates drifted 2.3–10 s under default
thresholds and sit at 2.3–3.2 s with arena retention; the native canon
kernel (16.7 M positions) measures 0.085 s hot vs 0.6–5 s when paying
faults. Much of what round 4 recorded as "the box's own CPU drift"
(BASELINE.md) was this.

Raising M_MMAP_THRESHOLD keeps big blocks in the main arena, and a large
M_TRIM_THRESHOLD keeps freed arena memory mapped for reuse. Peak RSS is
unchanged (live bytes are identical); the RSS floor between phases rises
toward the high-water mark — the standard allocator-cache tradeoff (the
reference links mimalloc on MSVC builds for the same class of reason,
reference makefile:17).

Both knobs are process-wide import side effects, applied from
agc_tpu_torch/__init__ — the same tradeoff as the reference linking mimalloc:
a library that embeds the compressor gets the allocator behavior the
compressor was measured with. Each has its own opt-out, checked BEFORE
anything is touched: AGC_TPU_MALLOC_TUNE=0 skips the glibc mallopt
thresholds; AGC_TPU_NUMPY_HUGEPAGE=1 keeps numpy's hugepage madvise.
Non-glibc platforms are a silent no-op.
"""

from __future__ import annotations

import ctypes
import os

# glibc mallopt parameter numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done: bool | None = None


def disable_numpy_hugepage_madvise() -> None:
    """Stop numpy from madvise(MADV_HUGEPAGE)-ing large allocations.

    Measured on the bench box (THP enabled=[madvise], defrag=[madvise]):
    first-touch of a fresh 2 GB numpy buffer runs at 0.10-0.14 GB/s with
    the madvise (each 2 MB fault does direct compaction on a fragmented
    host) vs 1.9-2.3 GB/s without — a 15-20x penalty that dominated the
    discovery-pool fill (~40 s of the 2 Gbase create) and most of what
    rounds 3-4 recorded as unexplained "box CPU drift" (the penalty
    appears only once the host's free memory fragments, so it comes and
    goes by the hour). AGC_TPU_NUMPY_HUGEPAGE=1 opts back in for hosts
    where compaction is cheap."""
    if os.environ.get("AGC_TPU_NUMPY_HUGEPAGE", "0") == "1":
        return
    # for numpy imported after us (the env var is read at import time)
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    import sys

    if "numpy" in sys.modules:  # already imported: flip the live policy
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2
        except ImportError:
            try:
                from numpy.core import multiarray as _ma  # numpy 1.x
            except ImportError:
                return
        try:
            _ma._set_madvise_hugepage(False)
        except Exception:
            pass


def tune_allocator() -> bool:
    """Apply the arena-retention thresholds once per process. Returns
    True when glibc accepted both knobs (idempotent)."""
    global _done
    if _done is not None:
        return _done
    disable_numpy_hugepage_madvise()
    if os.environ.get("AGC_TPU_MALLOC_TUNE", "1") == "0":
        _done = False
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
        mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
        mallopt.restype = ctypes.c_int
    except (OSError, AttributeError, TypeError):
        _done = False
        return False
    try:
        ok = bool(mallopt(_M_MMAP_THRESHOLD, 1 << 30)) and bool(
            mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        )
    except Exception:
        ok = False
    _done = ok
    return ok
