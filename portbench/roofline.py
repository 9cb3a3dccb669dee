"""The least time the card could take for the device work a cell's inputs
require: bytes over HBM's bandwidth or int32 operations over the int32
rate, whichever is larger, for each piece of work.

The peaks and the per-piece counts are copies of ``chip_smoke.py``'s
``bound``, ``canon_bound``, ``walk_bound`` and ``index_bound``, kept here so
that a change to that script does not move the yardstick. The count comes
from the inputs (the reference's positions, its k-mer pool and
singletons, the greedy walks' probed positions, the samples' bases), not
from which kernels ran, so fusing or replacing a kernel leaves it alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s of float32
# counts an FMA as two operations on 128 lanes an SM, and an SM has 64
# int32 lanes, so 67e12 / 4 int32 instructions a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4


def bound(n_bytes: float, n_ops: float) -> float:
    """Seconds for a piece that moves ``n_bytes`` (each input read once,
    each output written once) and does ``n_ops`` int32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def canon(positions: int) -> float:
    """Canonical codes: each position's packed symbol (half a byte) read
    once, its 8-byte code written once, 20 int32 operations (both
    orientations rolled in 64 bits, the min, shift and flip)."""
    return bound(8.5 * positions, 20 * positions)


def sort_filter(pool: int) -> float:
    """The pool's sort and singleton filter: the pool read and written once."""
    return bound(16 * pool, 0)


def walk_index(pool: int, singletons: int) -> float:
    """The walk's singleton index: the pool read once, each singleton
    written once (8 bytes), two compares an entry."""
    return bound(8 * pool + 8 * singletons, 2 * pool)


def walk(probed: int, emissions: int) -> float:
    """The greedy walk: each probed position reads its code and one
    lookup of the index (24 bytes, two compares); each emission writes a
    position and a code."""
    return bound(24 * probed + 16 * emissions, 2 * probed)


def scan(bases: int) -> float:
    """A sample's membership scan: each base's packed symbol read once and
    both orientations rolled (20 int32 operations). The hits it writes,
    one about every segment, are left out: their bytes are under a
    thousandth of the operations' time."""
    return bound(0.5 * bases, 20 * bases)


def least_seconds(discovery, sample_bases: int) -> float:
    """One operation: discovery on the reference (``discovery`` None when
    the operation loads its splitters, as an append does) and the scans of
    ``sample_bases``."""
    t = scan(sample_bases)
    if discovery is not None:
        t += (canon(discovery.positions) + sort_filter(discovery.pool)
              + walk_index(discovery.pool, discovery.singletons)
              + walk(discovery.walk_positions, discovery.emissions))
    return t
