"""The port's unsigned-in-signed integer convention (agc_tpu_torch.ops.u64)
against numpy uint64 / uint32 arithmetic."""

import numpy as np
import pytest
import torch

from agc_tpu_torch.ops import u64

EDGES = np.array(
    [0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
     (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1],
    dtype=np.uint64,
)


def _values(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 64, size=n, dtype=np.uint64, endpoint=False)
    return np.concatenate([EDGES, vals, vals[:50]])  # with duplicates


def test_round_trip_and_sentinel():
    v = _values()
    t = u64.from_u64(v)
    assert t.dtype == torch.int64
    assert np.array_equal(u64.to_u64(t), v)
    assert np.array_equal(u64.to_u64(u64.flip(u64.flip(t))), v)
    s = u64.from_u64(np.array([0xFFFFFFFFFFFFFFFF], np.uint64))
    assert int(s[0]) == u64.SENTINEL == torch.iinfo(torch.int64).max
    assert int(torch.sort(t).values[-1]) == u64.SENTINEL


@pytest.mark.parametrize("op", ["sort", "lt", "le", "minimum", "maximum",
                                "searchsorted_left", "searchsorted_right",
                                "unique"])
def test_order_ops_match_numpy(op):
    a, b = _values(1), _values(2)
    ta, tb = u64.from_u64(a), u64.from_u64(b)
    if op == "sort":
        assert np.array_equal(u64.to_u64(torch.sort(ta).values), np.sort(a))
    elif op == "lt":
        assert np.array_equal((ta < tb).numpy(), a < b)
    elif op == "le":
        assert np.array_equal((ta <= tb).numpy(), a <= b)
    elif op == "minimum":
        assert np.array_equal(u64.to_u64(torch.minimum(ta, tb)), np.minimum(a, b))
    elif op == "maximum":
        assert np.array_equal(u64.to_u64(torch.maximum(ta, tb)), np.maximum(a, b))
    elif op.startswith("searchsorted"):
        side = op.split("_")[1]
        sa = np.sort(a)
        got = torch.searchsorted(u64.from_u64(sa), tb, side=side).numpy()
        assert np.array_equal(got, np.searchsorted(sa, b, side=side))
    else:
        assert np.array_equal(u64.to_u64(torch.unique(ta)), np.unique(a))


@pytest.mark.parametrize("s", [0, 1, 2, 31, 32, 33, 62, 63])
def test_shifts_match_numpy(s):
    """The shift rules the convention relies on: ``<<`` wraps like an
    unsigned shift, ``>>`` needs a mask to be logical."""
    v = _values(3)
    raw = torch.from_numpy(v.view(np.int64).copy())  # unflipped bit pattern
    got_r = ((raw >> s) & ((1 << (64 - s)) - 1)).numpy().view(np.uint64)
    assert np.array_equal(got_r, v >> np.uint64(s))
    got_l = (raw << s).numpy().view(np.uint64)
    assert np.array_equal(got_l, v << np.uint64(s))


def test_words32():
    v = _values(4)
    raw = torch.from_numpy(v.view(np.int64).copy())
    lo, hi = u64.low32(raw), u64.high32(raw)
    assert lo.dtype == hi.dtype == torch.int32
    assert np.array_equal(u64.to_u32(lo), (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(u64.to_u32(hi), (v >> np.uint64(32)).astype(np.uint32))
    w = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tw = u64.from_u32(w)
    assert np.array_equal(u64.to_u32(tw), w)
    assert np.array_equal(u64.to_u32(tw ^ u64.from_u32(w[::-1].copy())), w ^ w[::-1])
    for s in (1, 7, 16, 31):
        logical = (tw >> s) & ((1 << (32 - s)) - 1)
        assert np.array_equal(u64.to_u32(logical), w >> np.uint32(s))
