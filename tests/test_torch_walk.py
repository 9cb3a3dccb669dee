"""The greedy walk's pool directory and its edge cases, on the CPU.

- The walk kernel (csrc/greedy_walk.cu) decides whether a value occurs
  exactly once in the sorted pool by looking in the index that
  ``walk_index`` builds: the pool's singletons, and a directory of their
  buckets; only the value's bucket is searched. That lookup, written here
  as torch ops over ``walk_index``'s output (its plain version on the
  CPU), is held against ``greedy_walk_plain``'s ``searchsorted``
  singleton mask on pools with duplicates, with SENTINELs, with bit-63
  values, with one heavily skewed prefix, and on an empty pool.
- The port's greedy walk against agc_tpu's speculative walk
  (splitter_greedy_canon_kernel) on inputs that reach the new kernel's
  edge branches: windows without hits, seg below the window width, cap
  inside a round, contigs shorter than a window, no singleton.

Integer outputs must be equal: no tolerance. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agc_tpu.ops import kmers as JK
from agc_tpu_torch.ops import cuda_kmers as CK
from agc_tpu_torch.ops import u64

SENT = u64.SENTINEL


def _fresh(rng, n):
    """Flipped codes of both signs, distinct with high probability, never
    SENTINEL."""
    return rng.integers(-(1 << 63), SENT, size=n, dtype=np.int64)


def _pool(kind: str, rng) -> np.ndarray:
    if kind == "duplicates":  # most values three or more times
        return np.sort(np.concatenate([np.repeat(_fresh(rng, 500), 3), _fresh(rng, 300)]))
    if kind == "sentinel":
        return np.sort(np.concatenate([_fresh(rng, 900), np.full(200, SENT)]))
    if kind == "bit63":  # next to INT64_MIN, 0 and INT64_MAX - 1
        near = [np.iinfo(np.int64).min, -1, 0, SENT - 1]
        v = np.concatenate([c + rng.integers(-300, 300, 300) for c in near])  # wraps too
        v = v[v != SENT]
        return np.sort(np.concatenate([v, v[:100]]))
    if kind == "skewed":  # 90% share the top 40 bits of the unsigned code
        top = np.uint64(int(rng.integers(0, 1 << 40)) << 24)
        low = rng.integers(0, 1 << 24, 1800).astype(np.uint64)
        skew = ((top | low) ^ np.uint64(1 << 63)).view(np.int64)
        return np.sort(np.concatenate([skew, skew[:300], _fresh(rng, 200)]))
    assert kind == "empty"
    return np.empty(0, np.int64)


def _searchsorted_singletons(values, pool):
    """greedy_walk_plain's singleton mask."""
    hit = torch.zeros(values.shape, dtype=torch.bool)
    p = pool.numel()
    if p:
        ix = torch.searchsorted(pool, values)
        at = pool[ix.clamp(max=p - 1)]
        nxt = pool[(ix + 1).clamp(max=p - 1)]
        hit = (at == values) & (values != SENT) & ((nxt != values) | (ix + 1 >= p))
    return hit


def _index_singletons(values, singles, dirs):
    """The kernel's lookup (``lookup`` in csrc/greedy_walk.cu): the
    value's bucket bounds from the directory, a bucket of more than four
    entries halved until four are left, then the value compared with
    them."""
    bits = (dirs.numel() - 1).bit_length() - 1
    off = dirs.to(torch.int64) & u64.M32
    b = CK.pool_buckets(values, bits)
    lo, hi = off[b], off[b + 1]
    safe = singles if singles.numel() else torch.zeros(1, dtype=torch.int64)
    last = max(singles.numel() - 1, 0)
    while bool((hi - lo > 4).any()):
        go = hi - lo > 4
        mid = (lo + hi) >> 1
        below = safe[mid.clamp(max=last)] < values
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid + 1, hi)
    hit = torch.zeros(values.shape, dtype=torch.bool)
    for q in range(4):
        hit |= (lo + q < hi) & (safe[(lo + q).clamp(max=last)] == values)
    return hit


@pytest.mark.parametrize("kind", ["duplicates", "sentinel", "bit63", "skewed", "empty"])
def test_walk_index_lookup_matches_searchsorted(kind):
    rng = np.random.default_rng(len(kind))
    pool = torch.from_numpy(_pool(kind, rng))
    singles, dirs = CK.walk_index(pool)
    # the singletons: values other than SENTINEL that occur once, in order
    vals, counts = np.unique(pool.numpy(), return_counts=True)
    assert np.array_equal(singles.numpy(), vals[(counts == 1) & (vals != SENT)])
    bits = CK.index_bits(singles.numel())
    assert dirs.dtype == torch.int32 and dirs.numel() == (1 << bits) + 1
    # entry b is the first offset into singles whose bucket is >= b
    buckets = CK.pool_buckets(singles, bits)
    for b in range(0, 1 << bits, max(1, (1 << bits) // 64)):
        assert int(dirs[b]) == int((buckets < b).sum())
    assert int(dirs[-1]) == singles.numel()
    # every pool value, its neighbours and fresh values
    values = torch.cat([
        pool, pool + 1, pool - 1, torch.from_numpy(_fresh(rng, 500)),
        torch.tensor([SENT, np.iinfo(np.int64).min, 0, -1]),
    ])
    want = _searchsorted_singletons(values, pool)
    assert torch.equal(_index_singletons(values, singles, dirs), want)
    if kind != "empty":
        assert 0 < int(want.sum()) < values.numel()
    if kind == "skewed":  # one bucket holds most of the singletons
        assert int((dirs[1:] - dirs[:-1]).max()) > singles.numel() // 2


def _walk_case(name: str, rng):
    """(canon flipped int64, seg, cap) for one contig."""
    if name == "mostly duplicates":  # windows without a hit end rounds early
        canon = _fresh(rng, 300)[rng.integers(0, 300, 6000)]
        one = rng.random(6000) < 0.01
        canon[one] = _fresh(rng, int(one.sum()))
        return canon, 200, 32
    canon = _fresh(rng, 5000)
    canon[rng.random(5000) < 0.3] = canon[0]  # a repeated value
    canon[rng.random(5000) < 0.05] = SENT
    if name == "seg = k = 31":
        return canon, 31, 5000 // 31 + 2
    if name == "cap inside a round":
        return canon, 31, 45
    if name == "shorter than a window":
        return canon[:40], 31, 4
    assert name == "no singleton"  # the pool below holds each value twice
    return canon, 100, 52


@pytest.mark.parametrize("name", ["mostly duplicates", "seg = k = 31", "cap inside a round",
                                  "shorter than a window", "no singleton"])
def test_greedy_walk_edge_cases_match_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    canon, seg, cap = _walk_case(name, rng)
    pool = np.sort(np.concatenate([canon, canon]) if name == "no singleton" else canon)
    n = len(canon)
    t = torch.from_numpy
    got = CK.greedy_walk(t(canon), torch.zeros(1, dtype=torch.int64),
                         torch.tensor([n]), t(pool), seg, cap)[0]
    flip = np.uint64(1 << 63)
    want = np.asarray(JK.splitter_greedy_canon_kernel(
        jnp.asarray(canon.view(np.uint64) ^ flip), n,
        jnp.asarray(pool.view(np.uint64) ^ flip), seg, cap))
    count = int(want[0])
    assert int(got[0]) == count
    assert np.array_equal(got[1 : 1 + count].numpy().astype(np.uint64), want[1 : 1 + count])
    assert np.array_equal(u64.to_u64(got[1 + cap : 1 + cap + count]),
                          want[1 + cap : 1 + cap + count])
    has_tail = want[1 + 2 * cap] != JK._POS_INF
    assert (int(got[1 + 2 * cap]) != SENT) == has_tail
    if has_tail:
        assert int(got[1 + 2 * cap]) == int(want[1 + 2 * cap])
        assert u64.to_u64(got[2 + 2 * cap : 3 + 2 * cap])[0] == want[2 + 2 * cap]
    if name == "no singleton":
        assert count == 0 and not has_tail
    elif name == "cap inside a round":
        assert count == cap
    else:
        assert count > 1
