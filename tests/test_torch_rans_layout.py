"""The flush's layout, raw copies and quantizer as csrc/rans.cu computes
them on the card, modelled in Python and held against the port's plain
versions and agc_tpu (agc_tpu/ops/device_rans.py, agc_tpu/core/entropy.py)
on the same inputs. Blobs, offsets and tables are integers: the tolerance
is 0 everywhere.

- rans_layout: each part's blob size from its frequency and lane-length
  varints, raw or coded, then one scan over tiles of 8 parts by decoupled
  look-back (a tile sums its predecessors down to the nearest that holds a
  prefix), against blob_offsets and the sizes of agc_tpu's blobs;
- rans_write's raw copies: 16-byte words loaded aligned and shifted to the
  destination's alignment, ragged ends byte by byte, against slicing;
- rans_tables' quantizer: ranks from a bitonic sort of 256 keys, 8 a lane,
  against quantize_plain and both packages' quantize_freqs;
- the buffer's size from the flush's shapes (blob_cap) against the blobs;
- the chunk list's check on the card: each entry against its neighbour,
  and a table of zeros for a part marked or whose counts miss its length,
  so that every list other than _prepare's is refused at the download.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from agc_tpu.core import entropy as TE
from agc_tpu_torch.core import entropy as E
from agc_tpu_torch.ops import device_rans as D

from test_torch_rans import _cases, _fuzz, _named_counts, _skewed

M64 = (1 << 64) - 1


def _tensors(prep):
    return tuple(torch.from_numpy(a) for a in
                 (prep.data, prep.meta, prep.chunks, prep.sel, prep.work))


def _coded(prep):
    """The flush's tables, counts and states by the plain versions."""
    data, meta, chunks, sel, work = _tensors(prep)
    freqs, enc = D.rans_tables(data, meta, chunks)
    counts, states = D.rans_encode(data, meta, enc, sel, work, prep.n_lanes)
    return freqs, enc, counts, states


# ---------------------------------------------------------------------------
# rans_layout
# ---------------------------------------------------------------------------


def layout_model(meta, freqs, counts, hide=0.0, seed=0):
    """rans_layout_kernel in Python. A warp a part: frequency varints of 1
    or 2 bytes, lane-length varints, raw where the coded blob is not
    smaller than the escape. A tile of 8 parts publishes its own sums, then
    looks back over windows of 32 tiles, adding each tile's words down to
    the nearest that holds a prefix, and publishes its prefix. `hide`: the
    share of earlier tiles whose prefix a later tile does not see yet (it
    reads their own sums and looks further back), as when they are still
    running. Returns (blob_off, stream_at, lane_cs)."""
    rng = np.random.default_rng(seed)
    rows = meta.tolist()
    fr, cnt = freqs.numpy(), counts.numpy().astype(np.int64)
    sizes, sums, streams = [], [], []
    for p, (_off, n, lanes, lane0) in enumerate(rows):
        c = cnt[lane0 : lane0 + lanes]
        vb = int(np.where(fr[p] >= 0x80, 2, 1).sum()) + sum(E._varint_len(int(x)) for x in c)
        head = 2 + E._varint_len(n)
        at = head + vb + 4 * lanes
        raw = at + int(c.sum()) >= head + n
        sizes.append(head + n if raw else at + int(c.sum()))
        sums.append(int(c.sum()))
        streams.append(-1 if raw else at)
    n_tiles = -(-len(rows) // D._TILE)
    own = [(sum(sizes[D._TILE * t : D._TILE * (t + 1)]), sum(sums[D._TILE * t : D._TILE * (t + 1)]))
           for t in range(n_tiles)]
    prefix = []
    blob_off = np.zeros(len(rows) + 1, dtype=np.int64)
    stream_at = np.zeros(len(rows), dtype=np.int64)
    lane_cs = np.zeros(len(cnt) + 1, dtype=np.int64)
    for t in range(n_tiles):
        seen = [i == 0 or rng.random() >= hide for i in range(t)]  # tile 0: its prefix at once
        ex_b = ex_s = 0
        look = t - 1
        while look >= 0:
            window = [look - lane for lane in range(32)]
            has = [i < 0 or seen[i] for i in window]
            stop = has.index(True) if any(has) else 31
            for i in window[: stop + 1]:
                if i >= 0:
                    b, s = prefix[i] if seen[i] else own[i]
                    ex_b, ex_s = ex_b + b, ex_s + s
            if any(has):
                break
            look -= 32
        prefix.append((ex_b + own[t][0], ex_s + own[t][1]))
        at, run = ex_b, ex_s
        for p in range(D._TILE * t, min(D._TILE * (t + 1), len(rows))):
            _off, n, lanes, lane0 = rows[p]
            blob_off[p] = at
            stream_at[p] = -1 if streams[p] < 0 else at + streams[p]
            c = cnt[lane0 : lane0 + lanes]
            lane_cs[lane0 : lane0 + lanes] = run + np.cumsum(c) - c
            at, run = at + sizes[p], run + sums[p]
        blob_off[-1], lane_cs[-1] = at, run
    return tuple(torch.from_numpy(a) for a in (blob_off, stream_at, lane_cs))


def _edge_parts():
    """Every lane tier, raw escapes, n on both sides of each varint width,
    and more than 32 tiles of parts (the look-back's second window)."""
    rng = np.random.default_rng(61)

    def sym(alpha, n):
        return rng.integers(0, alpha, n, dtype=np.uint16).astype(np.uint8).tobytes()

    parts = []
    for n in (127, 128, 16383, 16384, (1 << 21) - 1, 1 << 21):
        parts += [sym(4, n), sym(256, n)]  # coded where rANS pays, else raw
    parts += [sym(5, n) for n in (63, 64, 1023, 1024, 8191, 8192, 65535, 65536)]
    parts += [sym(int(a), int(n)) for a, n in zip(rng.integers(1, 257, 300),
                                                   rng.integers(1, 400, 300))]
    return parts


@pytest.fixture(scope="module")
def edge_flush():
    parts = _edge_parts()
    prep = D._prepare(parts)
    return parts, prep, _coded(prep)


@pytest.mark.parametrize("hide", [0.0, 0.7, 1.0])
def test_layout_model_equals_blob_offsets(edge_flush, hide):
    """The layout kernel's model, whatever share of its predecessors' prefixes a
    tile sees, equals blob_offsets, and its blob sizes equal agc_tpu's."""
    parts, prep, (freqs, _enc, counts, _states) = edge_flush
    meta = torch.from_numpy(prep.meta)
    assert {E.lanes_for(len(p)) for p in parts} == {1, 8, 64, 256, 1024}
    assert -(-len(parts) // D._TILE) > 32
    got = layout_model(meta, freqs, counts, hide=hide, seed=int(hide * 10))
    want = D.blob_offsets(meta, freqs, counts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sizes = (got[0][1:] - got[0][:-1]).tolist()
    assert sizes == [len(TE.compress(p)) for p in parts]
    raw = (got[1] < 0).tolist()
    assert raw == [bool(TE.compress(p)[1] & TE._RAW_FLAG) for p in parts]
    # raw escapes of each varint width, coded parts beside them
    widths = {E._varint_len(len(p)) for p, r in zip(parts, raw) if r}
    assert widths == {1, 2, 3, 4} and not all(raw)


def test_rans_layout_on_the_cpu_is_blob_offsets(edge_flush):
    _parts, prep, (freqs, _enc, counts, _states) = edge_flush
    meta = torch.from_numpy(prep.meta)
    for g, w in zip(D.rans_layout(meta, freqs, counts), D.blob_offsets(meta, freqs, counts)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# rans_write's raw copies
# ---------------------------------------------------------------------------


def load16_model(data: bytes, s: int) -> bytes:
    """load16_at: the aligned 16-byte words that hold data[s : s + 16],
    shifted down by s % 16 bytes: 8 (two words), then 4 (one word), then a
    funnel shift of 0-3 bytes across each pair of 32-bit words; byte by
    byte where the second aligned word would pass the end of the data."""
    base, r = s & ~15, s & 15
    if base + (32 if r else 16) > len(data):
        return bytes(data[s + k] if s + k < len(data) else 0 for k in range(16))
    if r == 0:
        return bytes(data[base : base + 16])
    w = [int.from_bytes(data[base + 4 * k : base + 4 * k + 4], "little") for k in range(8)]
    if r & 8:
        w[0:6] = w[2:8]
    if r & 4:
        w[0:5] = w[1:6]
    sh = 8 * (r & 3)
    return b"".join((((w[k + 1] << 32) | w[k]) >> sh & 0xFFFFFFFF).to_bytes(4, "little")
                    for k in range(4))


def copy_model(out: bytearray, d0: int, data: bytes, s0: int, length: int) -> None:
    """copy_realigned: out[d0 : d0 + length] = data[s0 : s0 + length], the
    16-byte words of out wholly inside the range stored whole from
    load16_model, the ragged ends byte by byte."""
    a, e = (d0 + 15) & ~15, (d0 + length) & ~15
    if a >= e:
        out[d0 : d0 + length] = data[s0 : s0 + length]
        return
    for i in range(a - d0):
        out[d0 + i] = data[s0 + i]
    for i in range(d0 + length - e):
        out[e + i] = data[s0 + (e - d0) + i]
    for w in range(a, e, 16):
        assert w % 16 == 0
        out[w : w + 16] = load16_model(data, w + s0 - d0)


@pytest.mark.parametrize("s_mod", range(16))
def test_realigned_copy_equals_slicing(s_mod):
    """Every (source mod 16, destination mod 16) pair, lengths 0-48, the
    source in the middle of the data and at its very end."""
    rng = np.random.default_rng(s_mod)
    for tail in (0, 3, 40):
        for d_mod in range(16):
            for length in range(49):
                s0, d0 = 32 + s_mod, 64 + d_mod
                data = rng.integers(0, 256, s0 + length + tail, dtype=np.uint8).tobytes()
                out = bytearray(b"\xee" * (d0 + length + 32))
                copy_model(out, d0, data, s0, length)
                assert out[d0 : d0 + length] == data[s0 : s0 + length]
                assert out[:d0] == b"\xee" * d0 and out[d0 + length :] == b"\xee" * 32


def test_realigned_copy_across_chunks():
    """A raw part of several 64 KB chunks, each copied by its own block (the
    first also writes the header), at odd source and destination offsets:
    the blob equals the escape the host writes, and no byte beside it
    changes."""
    rng = np.random.default_rng(5)
    n = 3 * D._CHUNK + 5
    part = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 7, dtype=np.uint8).tobytes() + part
    blob0 = 21
    head = 2 + E._varint_len(n)
    out = bytearray(b"\xee" * (blob0 + head + n + 16))
    out[blob0 : blob0 + 2] = bytes([E.MAGIC, E._RAW_FLAG])
    hdr = bytearray()
    E._put_varint(hdr, n)
    out[blob0 + 2 : blob0 + head] = hdr
    for start in range(0, n, D._CHUNK):
        copy_model(out, blob0 + head + start, data, 7 + start, min(D._CHUNK, n - start))
    assert bytes(out[blob0 : blob0 + head + n]) == TE.compress(part)
    assert out[:blob0] == b"\xee" * blob0 and out[blob0 + head + n :] == b"\xee" * 16


# ---------------------------------------------------------------------------
# rans_tables' quantizer
# ---------------------------------------------------------------------------


def warp_sort_model(keys) -> np.ndarray:
    """warp_sort256: the bitonic network over 256 keys at positions 8 lane +
    j, strides of 8 and more between lanes (partner position i ^ stride),
    the smaller ones inside a lane."""
    key = np.asarray(keys, dtype=np.uint64).copy()
    i = np.arange(256)
    for lk in range(1, 9):
        k = 1 << lk
        for ls in range(lk - 1, -1, -1):
            st = 1 << ls
            if st >= 8:
                other = key[i ^ st]
                keep_min = ((i & st) == 0) == ((i & k) == 0)
                key = np.where(keep_min, np.minimum(key, other), np.maximum(key, other))
            else:
                lo = i[(i & st) == 0]
                a, b = key[lo].copy(), key[lo | st].copy()
                swap = np.where((lo & k) == 0, a > b, a < b)
                key[lo], key[lo | st] = np.where(swap, b, a), np.where(swap, a, b)
    return key


def quantize_warp_model(counts) -> np.ndarray:
    """quantize_warp in Python integers: q = c * 4096 // n (present symbols
    at least 1); for diff > 0, diff // m to each present symbol and one
    more to the first diff % m by (-rem, symbol); for diff < 0 the least
    pass K in [1, max q] whose running total of min(q - 1, K) reaches
    -diff, K - 1 from each symbol (at most q - 1), and one more from the
    first of those with q > K by (rem, symbol). Ranks: warp_sort_model of
    the keys, symbols that take no part last (the largest key)."""
    c = [int(x) for x in counts]
    total = sum(c)
    q = [x * E.PROB_SCALE // total for x in c]
    rem = [x * E.PROB_SCALE % total for x in c]
    q = [1 if x > 0 and v == 0 else v for x, v in zip(c, q)]
    diff = E.PROB_SCALE - sum(q)
    if diff == 0:
        return np.asarray(q)

    def taken(k):
        return sum(min(max(v - 1, 0), k) for v in q)

    top = (1 << (23 if total < 1 << 20 else 55)) - 1  # 32-bit keys below 2^20 bytes
    if diff > 0:
        m = sum(x > 0 for x in c)
        first = diff % m
        keys = [(((top - rem[s]) << 8) | s) if c[s] > 0 else M64 for s in range(256)]
    else:
        need = -diff
        lo, hi = 1, max(q)
        while lo < hi:
            mid = (lo + hi) // 2
            if taken(mid) >= need:
                hi = mid
            else:
                lo = mid + 1
        k_last = lo
        first = need - taken(k_last - 1)
        keys = [((rem[s] << 8) | s) if q[s] > k_last else M64 for s in range(256)]
    ranked = warp_sort_model(keys)
    assert (np.diff(ranked.astype(object)) > 0).all() or len(set(keys)) < 256
    more = [0] * 256
    for key in ranked[:first].tolist():
        more[key & 0xFF] = 1
    for s in range(256):
        if diff > 0:
            if c[s] > 0:
                q[s] += diff // m + more[s]
        else:
            if q[s] >= 1:
                q[s] -= min(q[s] - 1, k_last - 1)
            q[s] -= more[s]
    return np.asarray(q)


def _against_both(counts: np.ndarray) -> None:
    got = quantize_warp_model(counts)
    assert (got == E.quantize_freqs(counts).astype(np.int64)).all()
    assert (got == TE.quantize_freqs(counts).astype(np.int64)).all()
    plain = D.quantize_plain(torch.from_numpy(counts.astype(np.int64))[None])[0].numpy()
    assert (got == plain).all()


def test_warp_sort_model_sorts():
    rng = np.random.default_rng(9)
    for _ in range(50):
        keys = rng.integers(0, 1 << 62, 256, dtype=np.uint64)
        keys[rng.integers(0, 256, 40)] = np.uint64(M64)
        assert (warp_sort_model(keys) == np.sort(keys)).all()


@pytest.mark.parametrize("case", ["one symbol", "every symbol once", "dominant among 255 rare",
                                  "dominant among rare, rem ties", "total below 4096",
                                  "total above 4096"])
def test_quantize_warp_model_named_cases(case):
    _against_both(_named_counts(case))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=256, max_size=256),
       st.sampled_from([1, 7, 10**4, 10**7]))
def test_quantize_warp_model_fuzz(counts, scale):
    c = np.asarray(counts, dtype=np.int64)
    c = np.where(c > 4000, c * scale, np.where(c > 3000, 0, c))
    if c.sum() == 0:
        c[0] = 1
    _against_both(c)


# ---------------------------------------------------------------------------
# the buffer's size and the whole flush
# ---------------------------------------------------------------------------


def _flushes():
    rng = np.random.default_rng(71)
    yield _cases()[1:] + _fuzz(6, seed=3) + [_skewed()]
    yield _edge_parts()
    yield [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()  # every part raw
           for n in rng.integers(1, 40_000, 60)]
    yield [bytes([7]) * int(n) for n in (1, 127, 128, 20_000)]  # one symbol: no stream


@pytest.mark.parametrize("i", range(4))
def test_blob_cap_holds_every_flush(i):
    """blob_cap(N, P), known before the tables run, holds the blobs of each
    flush; encode_batch on the CPU gives agc_tpu's blobs, from a buffer of
    that size on the card."""
    parts = list(_flushes())[i]
    prep = D._prepare(parts)
    data, meta, chunks, sel, work = _tensors(prep)
    freqs, enc, counts, states = _coded(prep)
    out, blob_off = D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    assert int(blob_off[-1]) == sum(len(TE.compress(p)) for p in parts) == out.numel()
    assert D.blob_cap(len(prep.data), len(parts)) >= int(blob_off[-1])
    assert D.encode_batch(parts, device="cpu") == [TE.compress(p) for p in parts]


def test_download_takes_only_the_blobs():
    """_download reads the offsets first and copies only blob_off[-1] bytes
    of a larger buffer; offsets past the buffer (a part without valid
    tables) or a last offset of -1 (a chunk list rans_write refused) are
    an error."""
    out = torch.arange(40, dtype=torch.uint8)
    flat, offs = D._download(out, torch.tensor([0, 3, 9]))
    assert flat.tobytes() == bytes(range(9)) and offs == [0, 3, 9]
    for bad in ([0, 41], [0, -1], [0, 3 + (1 << 40)]):
        with pytest.raises(ValueError, match="chunk list"):
            D._download(out, torch.tensor(bad))


def test_code_flush_with_known_lanes():
    """code_flush given the flush's lanes (no read of meta) equals the call
    that reads them."""
    prep = D._prepare(_cases()[1:12])
    args = _tensors(prep)
    a, ao = D.code_flush(*args, n_lanes=prep.n_lanes)
    b, bo = D.code_flush(*args)
    assert torch.equal(a, b) and torch.equal(ao, bo)
    assert prep.n_lanes == int(sum(E.lanes_for(len(p)) for p in _cases()[1:12]))


# ---------------------------------------------------------------------------
# the chunk list's check
# ---------------------------------------------------------------------------

K = D._CHUNK


def chunk_ok_model(chunks, c, lens) -> bool:
    """csrc/rans.cu's chunk_ok: entry c is (0, 0) when first, else the
    successor of entry c - 1 (the next 64 KB of its part, or the next
    part's first chunk after the previous part's last); the last entry is
    the last part's last chunk."""
    n_parts = len(lens)
    p, start = chunks[c]
    if not (0 <= p < n_parts and start >= 0 and start % K == 0):
        return False
    ok = start < lens[p]
    if c == 0:
        ok = ok and p == 0 and start == 0
    else:
        q, s = chunks[c - 1]
        if start > 0:
            ok = ok and q == p and s == start - K
        else:
            ok = (ok and p > 0 and q == p - 1 and s >= 0 and s % K == 0
                  and s < lens[q] <= s + K)
    if c == len(chunks) - 1:
        ok = ok and p == n_parts - 1 and start + K >= lens[p]
    return ok


def tables_model(data: np.ndarray, lens, chunks):
    """rans_hist_kernel, then rans_quantize_kernel's test: a chunk block
    whose entry fails chunk_ok marks its part and the previous entry's
    part (where they are parts) and counts nothing; the others store (a
    part of one chunk) or add their counts. Returns (counts, the parts
    given a table of zeros: marked, or counts not summing to the length)."""
    n_parts = len(lens)
    offs = np.cumsum(lens) - lens
    counts = np.zeros((n_parts, 256), dtype=np.int64)
    marks = np.zeros(n_parts, dtype=bool)
    for c, (p, start) in enumerate(chunks):
        if not chunk_ok_model(chunks, c, lens):
            for q in (p, chunks[c - 1][0] if c else -1):
                if 0 <= q < n_parts:
                    marks[q] = True
            continue
        h = np.bincount(data[offs[p] + start: offs[p] + min(lens[p], start + K)], minlength=256)
        counts[p] = h if lens[p] <= K else counts[p] + h
    return counts, marks | (counts.sum(axis=1) != lens)


def _chunk_flush():
    rng = np.random.default_rng(83)
    lens = [1, 3 * K + 5, 7, K, K + 1, 2 * K, 40_000, 3]
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


def _malformed(good: np.ndarray, rng) -> np.ndarray:
    """One of: an entry dropped, repeated, moved, replaced or its start
    shifted, two swapped, the list cut short or lengthened."""
    c = int(rng.integers(0, len(good)))
    kind = int(rng.integers(0, 8))
    bad = good.copy()
    if kind == 0:
        return np.delete(bad, c, axis=0)
    if kind == 1:
        return np.insert(bad, c, bad[c], axis=0)
    if kind == 2:
        d = int(rng.integers(0, len(good)))
        bad[[c, d]] = bad[[d, c]]
    elif kind == 3:
        bad[c, 1] += int(rng.choice([-K, 16, K, 2 * K]))
    elif kind == 4:
        bad[c] = [int(rng.integers(-2, len(good) // 2 + 3)), K * int(rng.integers(0, 4))]
    elif kind == 5:
        return bad[: int(rng.integers(1, len(good)))]  # an empty list: refused by shape
    elif kind == 6:
        return np.vstack([bad, [int(rng.integers(-1, 10)), K * int(rng.integers(0, 4))]])
    else:
        return np.insert(bad, c, [int(rng.integers(-1, 10)), 0], axis=0)
    return bad


def test_chunk_model_takes_prepares_list():
    """_prepare's chunk list passes every entry's check, no part is given
    a table of zeros, and the counts give rans_tables' plain tables."""
    parts = _chunk_flush()
    prep = D._prepare(parts)
    lens = prep.meta[:, 1]
    good = prep.chunks.tolist()
    assert all(chunk_ok_model(good, c, lens) for c in range(len(good)))
    counts, zero = tables_model(prep.data, lens, good)
    assert not zero.any()
    freqs, _enc = D.rans_tables(*_tensors(prep)[:3])
    assert torch.equal(D.quantize_plain(torch.from_numpy(counts)), freqs)


def test_malformed_chunk_lists_are_refused_by_the_model():
    """Every chunk list other than _prepare's fails some entry's check
    (rans_write then sets blob_off[P] to -1) and leaves some part a table
    of zeros (rans_layout then sizes its blob past any buffer); 400 seeded
    malformations of a flush with parts of 1-4 chunks."""
    parts = _chunk_flush()
    prep = D._prepare(parts)
    lens = prep.meta[:, 1]
    good = prep.chunks
    rng = np.random.default_rng(89)
    n = 0
    for _ in range(400):
        bad = _malformed(good, rng)
        if bad.shape == good.shape and (bad == good).all():
            continue
        rows = bad.tolist()
        assert not all(chunk_ok_model(rows, c, lens) for c in range(len(rows))), rows
        assert tables_model(prep.data, lens, rows)[1].any(), rows
        n += 1
    assert n > 300


@pytest.mark.parametrize("what", ["dropped", "repeated", "shifted", "cut", "past the parts"])
def test_malformed_chunk_lists_raise_on_the_cpu(what):
    """On CPU tensors rans_tables, rans_write and code_flush refuse a chunk
    list that is not _prepare's before any work."""
    prep = D._prepare(_chunk_flush())
    data, meta, chunks, sel, work = _tensors(prep)
    good = prep.chunks
    bad = {"dropped": np.delete(good, 2, axis=0), "repeated": np.insert(good, 2, good[2], 0),
           "shifted": good + np.where(np.arange(len(good))[:, None] == 2, [0, 16], 0),
           "cut": good[:-1], "past the parts": np.vstack([good, [len(prep.meta), 0]])}[what]
    bad = torch.from_numpy(np.ascontiguousarray(bad))
    freqs, enc, counts, states = _coded(prep)
    with pytest.raises(ValueError, match="chunks must be"):
        D.rans_tables(data, meta, bad)
    with pytest.raises(ValueError, match="chunks must be"):
        D.rans_write(data, meta, bad, sel, work, freqs, enc, counts, states)
    with pytest.raises(ValueError, match="chunks must be"):
        D.code_flush(data, meta, bad, sel, work, prep.n_lanes)


def test_a_table_of_zeros_is_refused():
    """A part whose frequencies are rans_tables' table of zeros gets a blob
    of 2^40 bytes in blob_offsets (as in rans_layout), no stream, and the
    flush is refused: rans_write on the CPU raises, and so does _download
    of the card's unwritten buffer."""
    prep = D._prepare(_chunk_flush())
    data, meta, chunks, sel, work = _tensors(prep)
    freqs, enc, counts, states = _coded(prep)
    good_off, _at, _cs = D.blob_offsets(meta, freqs, counts)
    freqs[3] = 0
    enc[3] = 0
    blob_off, stream_at, lane_cs = D.blob_offsets(meta, freqs, counts)
    assert int(blob_off[4] - blob_off[3]) == D._INVALID_SIZE and int(stream_at[3]) == -1
    assert torch.equal(blob_off[:4], good_off[:4])
    with pytest.raises(ValueError, match="tables are not valid"):
        D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    out = torch.zeros(D.blob_cap(len(prep.data), len(prep.meta)), dtype=torch.uint8)
    with pytest.raises(ValueError, match="chunk list"):
        D._download(out, blob_off)
