"""The port's integer convention for unsigned words in torch tensors.

torch has no usable unsigned 64-bit arithmetic (no shift, add, compare,
minimum or searchsorted on ``torch.uint64``) and cannot shift a
``torch.uint32``. So:

- a k-mer code (unsigned 64-bit) travels as ``int64`` with bit 63
  flipped. Flipping maps unsigned order onto signed order, so ``sort``,
  ``<``, ``minimum`` and ``searchsorted`` on the int64 tensor give the
  unsigned results. The all-ones ``SENTINEL`` becomes ``INT64_MAX`` and
  still sorts last.
- a 32-bit word (XOR-mix, ``dlo``/``dhi`` halves, the scan hit vector)
  travels as the ``int32`` with the same bit pattern.

Values are viewed as ``np.uint64`` / ``np.uint32`` only at the host
boundary (``to_u64``, ``to_u32``), so agc_tpu's host decoders work
unchanged. torch's ``<<`` wraps like an unsigned shift; its ``>>`` is
arithmetic on signed types, so a logical right shift needs a mask after
it (``high32`` relies on the int32 cast dropping the sign-extended bits).
"""

from __future__ import annotations

import numpy as np
import torch

FLIP = -(1 << 63)  # int64 with only bit 63 set
SENTINEL = (1 << 63) - 1  # flipped all-ones u64 == INT64_MAX
M32 = 0xFFFFFFFF


def from_u64(a: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint64 -> flipped int64 tensor on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64) ^ np.int64(FLIP)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """Flipped int64 tensor -> np.uint64 (host copy)."""
    return (t.detach().cpu().numpy() ^ np.int64(FLIP)).view(np.uint64)


def from_u32(a: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint32 -> int32 tensor with the same bit pattern."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> np.uint32 (host copy)."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def flip(x: torch.Tensor) -> torch.Tensor:
    """Raw u64 bit pattern held in int64 <-> flipped convention (an
    involution)."""
    return x ^ FLIP


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < s < 64 (torch's >>
    is arithmetic on signed types)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def low32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 bit pattern, as the int32 with those bits."""
    lo = x & M32
    return torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(torch.int32)


def high32(x: torch.Tensor) -> torch.Tensor:
    """High 32 bits of an int64 bit pattern, as an int32 bit pattern."""
    return (x >> 32).to(torch.int32)
