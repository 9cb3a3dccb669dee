"""The zstd codec of the port's host layers.

``zstandard`` where that package is installed; otherwise the libzstd
ctypes bridge ``agc_tpu_torch._zstd``, which offers the two call shapes
the host modules use. Both write and read standard zstd frames, so the
archives are the same either way. ``segment`` and ``collection`` import
``zstandard`` from here.
"""

try:
    import zstandard
except ImportError:
    from .. import _zstd as zstandard

__all__ = ["zstandard"]
