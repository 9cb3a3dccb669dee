"""The greedy walk's pool directory and its edge cases, on the CPU.

- The walk kernel (csrc/greedy_walk.cu) decides whether a value occurs
  exactly once in the sorted pool by looking in the index that
  ``walk_index`` builds: the pool's singletons, and a directory of their
  buckets; only the value's bucket is searched. That lookup, written here
  as torch ops over ``walk_index``'s output (its plain version on the
  CPU), is held against ``greedy_walk_plain``'s ``searchsorted``
  singleton mask on pools with duplicates, with SENTINELs, with bit-63
  values, with one heavily skewed prefix, and on an empty pool.
- A Python model of the index's build (one read of the pool in tiles,
  each tile's offset by decoupled look-back in random orders, then the
  directory's pass over the singletons) against ``walk_index_plain``, on
  pools whose tile boundaries fall inside runs of equal values and at
  SENTINEL.
- The value-sampled discovery builds one index of its pool and walks every
  contig over it, with agc_tpu's splitters.
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


def _singles_model(pool: np.ndarray, tile: int, rng) -> np.ndarray:
    """singles_kernel as Python: each tile of ``tile`` entries flags its
    singletons against its neighbours (SENTINEL outside the pool) and
    publishes their count; the tiles' steps run in a random order, and a
    tile's look-back sums the words below it down to the first that holds
    a prefix, waiting while one is unset; then it writes its singletons in
    order from that offset. Returns the first S entries of the output."""
    p = len(pool)
    tiles = -(-p // tile)
    out = np.full(p, 12345, dtype=np.int64)  # the buffer has the pool's length
    status = [None] * tiles  # (is a prefix, value)
    flags = {}
    total = None
    pending = list(range(tiles))
    while pending:
        t = pending[int(rng.integers(0, len(pending)))]
        lo = t * tile
        if t not in flags:
            ext = [pool[i] if 0 <= i < p else SENT for i in range(lo - 1, lo + tile + 1)]
            flags[t] = [ext[j] != SENT and ext[j] != ext[j - 1] and ext[j] != ext[j + 1]
                        for j in range(1, tile + 1)]
            status[t] = (t == 0, sum(flags[t]))
            if t > 0:
                continue
            ex = 0
        else:
            ex, i = 0, t - 1
            while i >= 0 and status[i] is not None and not status[i][0]:
                ex += status[i][1]
                i -= 1
            if i >= 0 and status[i] is None:
                continue  # waits on a tile that has not published
            ex += status[i][1] if i >= 0 else 0
            status[t] = (True, ex + sum(flags[t]))
        mine = [pool[lo + j] for j in range(tile) if flags[t][j]]
        out[ex : ex + len(mine)] = mine
        if t == tiles - 1:
            total = ex + len(mine)
        pending.remove(t)
    return out[: total or 0]


def _dir_model(singles: np.ndarray, bits: int) -> np.ndarray:
    """dir_kernel as Python: entry i of singles (i = S: past the end) owns
    the buckets after its predecessor's, up to its own."""
    dirs = np.zeros((1 << bits) + 1, dtype=np.int64)
    b = CK.pool_buckets(torch.from_numpy(singles), bits).numpy()
    for i in range(len(singles) + 1):
        lo = int(b[i - 1]) + 1 if i > 0 else 0
        hi = int(b[i]) if i < len(singles) else 1 << bits
        dirs[lo : hi + 1] = i
    return dirs


def _tiled_pool(kind: str, tile: int, rng) -> np.ndarray:
    """Pools whose tile boundaries fall inside runs of equal values and at
    SENTINEL."""
    vals = np.sort(_fresh(rng, 40 * tile))
    reps = rng.integers(1, 4, vals.size)
    if kind == "runs across tiles":  # runs of 2-5 ending just past a boundary
        reps[::7] = 5
    pool = np.repeat(vals, reps)
    if kind == "runs across tiles":
        return pool
    if kind == "sentinel at a boundary":
        cut = (len(pool) // tile - 3) * tile
        return np.concatenate([pool[:cut], np.full(2 * tile + 5, SENT)])
    if kind == "sentinel inside a tile":
        cut = (len(pool) // tile - 3) * tile + tile // 2
        return np.concatenate([pool[:cut], np.full(tile + 3, SENT)])
    if kind == "tiles without a singleton":  # most tiles' values held twice
        pool = np.repeat(vals, 2)
        pool = np.sort(np.concatenate([pool, _fresh(rng, 5)]))
        return pool
    assert kind == "one entry"
    return vals[:1]


@pytest.mark.parametrize("kind", ["runs across tiles", "sentinel at a boundary",
                                  "sentinel inside a tile", "tiles without a singleton",
                                  "one entry"])
def test_one_pass_compaction_model_matches_plain(kind):
    """The one read of the pool (tiles of 16 and of 7, a look-back in random
    orders) gives walk_index_plain's singletons, and the directory's pass
    over them its directory."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    for tile in (16, 7):
        pool = _tiled_pool(kind, tile, rng)
        singles, dirs = CK.walk_index_plain(torch.from_numpy(pool))
        for _ in range(3):  # three random orders of the tiles
            got = _singles_model(pool, tile, rng)
            assert np.array_equal(got, singles.numpy()), (kind, tile)
        bits = CK.index_bits(len(got))
        assert np.array_equal(_dir_model(got, bits), dirs.numpy().astype(np.int64) & 0xFFFFFFFF)
        if kind != "one entry":
            assert 0 < len(got) < len(pool)


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


def test_sampled_path_builds_one_index(tmp_path, monkeypatch):
    """Value-sampled discovery (_POOL_DEVICE_MAX lowered on both engines,
    as tests/test_torch_sampled.py does) builds the pool's walk_index once
    and walks every contig over it: through that index each contig's codes
    are the pool's singletons, and the splitters are agc_tpu's."""
    from agc_tpu.core import compressor as tpu_comp
    from agc_tpu_torch.core import compressor as port_comp
    from util import write_fa

    monkeypatch.setattr(tpu_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 14)
    monkeypatch.setattr(port_comp.Compressor, "_POOL_DEVICE_MAX", 1 << 14)
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    monkeypatch.setenv("AGC_TPU_DISC", "device")
    rng = np.random.default_rng(21)
    contigs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (24000, 15000, 9000)]
    contigs[1][3000:9000] = contigs[0][10000:16000]  # a repeat across contigs
    ref = str(tmp_path / "ref.fa")
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    write_fa(ref, [(f"c{i}", alpha[c].tobytes().decode()) for i, c in enumerate(contigs)])
    built, walked = [], []

    def index_once(pool):
        built.append(CK.walk_index(pool))
        return built[-1]

    real_walk = port_comp.find_splitter_emissions_packed

    def walk(canon, placements, k, pool, seg, index=None):
        walked.append(index)
        singles, dirs = index
        assert torch.equal(singles, CK.walk_index_plain(pool)[0])
        assert torch.equal(_index_singletons(canon, singles, dirs),
                           _searchsorted_singletons(canon, pool))
        return real_walk(canon, placements, k, pool, seg, index=index)

    monkeypatch.setattr(port_comp, "walk_index", index_once)
    monkeypatch.setattr(port_comp, "find_splitter_emissions_packed", walk)
    params = dict(segment_size=2000)
    ours = port_comp.Compressor(str(tmp_path / "p.agc"), port_comp.CompressorParams(**params),
                                reference_file=ref, device="cpu")
    theirs = tpu_comp.Compressor(str(tmp_path / "t.agc"), tpu_comp.CompressorParams(**params),
                                 reference_file=ref)
    got = ours.splitter_set_snapshot()
    assert got == theirs.splitter_set_snapshot() and len(got) > 10
    assert len(built) == 1 and len(walked) == len(contigs)
    assert all(w is built[0] for w in walked)
    ours.abort()
    theirs.abort()
