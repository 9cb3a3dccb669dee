"""The match layer's kernel: ``match_estimate`` and its plain PyTorch version.

Counterpart of agc_tpu's XLA program ``_estimate_kernel``
(``agc_tpu/ops/match.py:363-452``): the approximate LZ token cost of every
(segment row, candidate group) pair, from strided seed-key probes into the
candidate's dual min/max hash-slot tables (``ops/match.py``'s ``RefBank``),
kept as one int64[R, H, 2] bank: a slot's min and max entries side by side.
The CUDA kernel (``csrc/match_estimate.cu``) walks the pairs in bank-row
order on a persistent grid, a block a pair at a time;
``match_estimate_plain`` is the same function as torch ops, the oracle the
kernel is held against and what runs for CPU tensors.

Seed keys here are the raw unsigned 64-bit patterns held in int64 (-1 is
agc_tpu's all-ones SENTINEL), not the flipped convention of ``ops/u64.py``:
the hashes multiply and take top bits, so they need the raw bits. torch's
int64 product keeps the low 64 bits of the unsigned product; its ``>>`` is
arithmetic, so every logical shift is masked after it.
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_kmers import _check_cuda, _count, _require, _stream

# slot-table geometry and hashes (agc_tpu/ops/match.py:108-122)
_POS_BITS = 24  # reference positions < 16M (the bank refuses larger refs)
_FP_BITS = 39
_HASH_MUL = 0x9E3779B97F4A7C15  # splitmix64 golden-ratio multiplier
_FP_MUL = 0xC2B2AE3D27D4EB4F  # xxhash64 prime_2
_SLOT_SENT = (1 << 63) - 1  # empty slot of the min table
_POS_MASK = (1 << _POS_BITS) - 1
_MAX_Q0 = 63  # csrc/match_estimate.cu's kMaxQ0: key_len // stride at most
_BLOCKS_PER_SM = 4  # the persistent grid: pairs in flight an SM


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def bucket_of(keys: torch.Tensor, log2_h: int) -> torch.Tensor:
    """Bucket of each raw int64 seed key: top log2_h bits of key * GOLDEN."""
    return ((keys * _signed(_HASH_MUL)) >> (64 - log2_h)) & ((1 << log2_h) - 1)


def fp_of(keys: torch.Tensor) -> torch.Tensor:
    """39-bit fingerprint: top bits of a second multiply."""
    return ((keys * _signed(_FP_MUL)) >> (64 - _FP_BITS)) & ((1 << _FP_BITS) - 1)


def digits(x: torch.Tensor) -> torch.Tensor:
    """ASCII digit count of a non-negative integer (the token grammar
    spells positions and lengths in decimal)."""
    d = torch.ones_like(x)
    for t in (10, 100, 1000, 10_000, 100_000, 1_000_000, 10_000_000):
        d = d + (x >= t).to(x.dtype)
    return d


def shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x shifted right along the last axis by k, zero (False) fill."""
    if k <= 0:
        return x
    out = torch.zeros_like(x)
    out[..., k:] = x[..., :-k]
    return out


def slot_bank(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """min / max slot tables, int64[..., H] each -> one int64[..., H, 2]
    bank, each slot's two entries side by side."""
    return torch.stack((ta, tb), dim=-1)


def match_estimate_plain(keys_s, a_lo, a_hi, nrun_tot, rows, cands, bank,
                         key_len: int, stride: int) -> torch.Tensor:
    """Plain version of ``match_estimate``: agc_tpu's ``_estimate_kernel``
    as torch ops, step for step, in the caller's pair order."""
    h = bank.shape[1]
    log2_h = h.bit_length() - 1
    t = keys_s.shape[1]
    rows, cands = rows.long(), cands.long()
    qs = keys_s[rows]
    t_valid = qs != -1
    bkt = torch.where(t_valid, bucket_of(qs, log2_h), 0)
    flat = cands[:, None] * h + bkt
    ea = bank[..., 0].reshape(-1)[flat]
    eb = bank[..., 1].reshape(-1)[flat]
    fp = fp_of(qs)
    hit_a = t_valid & (ea != _SLOT_SENT) & ((ea >> _POS_BITS) == fp)
    hit_b = t_valid & (eb >= 0) & ((eb >> _POS_BITS) == fp)
    hit = hit_a | hit_b
    rpos = torch.where(hit_a, ea & _POS_MASK, eb & _POS_MASK)
    rpos = torch.where(hit, rpos, 0)
    # a hit at block u covers blocks [u, u + q0] fully and the offsets
    # below r of block u + q0 + 1 (key_len = q0 * stride + r)
    q0, r = divmod(key_len, stride)
    c = torch.cumsum(hit.to(torch.int64), dim=1)
    cov_hi = (c - shift_right(c, q0)) > 0
    cov_lo = (c - shift_right(c, q0 + 1)) > 0
    lits = (torch.where(cov_lo, 0, a_lo[rows].long())
            + torch.where(cov_hi, 0, a_hi[rows].long())).sum(dim=1)
    cov0 = cov_lo if r else cov_hi
    run_start = cov0 & ~shift_right(cov_hi, 1)
    blk = torch.arange(t, dtype=torch.int64, device=qs.device)
    diag = rpos - blk * stride
    # previous run start's diagonal: pack (block, biased diag) so a cummax
    # carries the latest run start, then shift by one
    bias = 1 << 31
    packed = torch.where(run_start, (blk << 32) | (diag + bias), -1)
    last = torch.cummax(packed, dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    prev_diag = torch.where(prev >= 0, (prev & 0xFFFFFFFF) - bias, 0)
    run_cost = torch.where(run_start, digits((diag - prev_diag).abs()) + 4, 0)
    return lits + run_cost.sum(dim=1) + nrun_tot[rows].long()


def match_estimate(keys_s, a_lo, a_hi, nrun_tot, rows, cands, bank,
                   key_len: int, stride: int) -> torch.Tensor:
    """Estimated token cost of each (row, candidate) pair.

    keys_s: int64[Q, T] strided seed keys (-1 invalid); a_lo, a_hi:
    int32[Q, T] ACGT counts of each probe block's offsets below / from
    ``key_len % stride``; nrun_tot: int32[Q] N-run cost; rows, cands:
    int32[P] query row and bank row of each pair; bank: int64[R, H, 2], the
    min and max slot tables side by side (``slot_bank``), H a power of
    two. Returns int64[P] in pair order."""
    _require(keys_s.dim() == 2 and keys_s.dtype == torch.int64,
             "match_estimate: keys_s must be int64[Q, T]")
    _require(a_lo.shape == keys_s.shape and a_hi.shape == keys_s.shape
             and a_lo.dtype == torch.int32 and a_hi.dtype == torch.int32,
             "match_estimate: a_lo, a_hi must be int32[Q, T]")
    _require(nrun_tot.shape == keys_s.shape[:1] and nrun_tot.dtype == torch.int32,
             "match_estimate: nrun_tot must be int32[Q]")
    _require(rows.dim() == 1 and rows.shape == cands.shape
             and rows.dtype == torch.int32 and cands.dtype == torch.int32,
             "match_estimate: rows, cands must be int32[P]")
    _require(bank.dim() == 3 and bank.shape[2] == 2 and bank.dtype == torch.int64,
             "match_estimate: bank must be int64[R, H, 2]")
    h = bank.shape[1]
    _require(h >= 2 and h & (h - 1) == 0, "match_estimate: H must be a power of two")
    _require(stride > 0 and key_len // stride <= _MAX_Q0,
             f"match_estimate: key_len // stride must be below {_MAX_Q0 + 1}")
    if keys_s.device.type == "cpu":
        return match_estimate_plain(keys_s, a_lo, a_hi, nrun_tot, rows, cands, bank,
                                    key_len, stride)
    _check_cuda("match_estimate", keys_s, a_lo, a_hi, nrun_tot, rows, cands, bank)
    p = rows.numel()
    out = torch.empty(p, dtype=torch.int64, device=keys_s.device)
    if p == 0:
        return out
    with torch.cuda.device(keys_s.device):
        # the pairs that probe one table run together (csrc/match_estimate.cu)
        order = torch.sort(cands, stable=True).indices.to(torch.int32)
        grid = _BLOCKS_PER_SM * torch.cuda.get_device_properties(
            keys_s.device).multi_processor_count
        rc = _build.lib().agc_match_estimate(
            keys_s.data_ptr(), a_lo.data_ptr(), a_hi.data_ptr(), nrun_tot.data_ptr(),
            rows.data_ptr(), cands.data_ptr(), order.data_ptr(), bank.data_ptr(),
            p, keys_s.shape[1], h, h.bit_length() - 1, key_len, stride, grid,
            out.data_ptr(), _stream(keys_s),
        )
    _build.check(rc, "match_estimate")
    _count("match_estimate")
    return out
