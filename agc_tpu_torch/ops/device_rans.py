"""The device rANS coder of the tpu-rans profile: ``encode_batch``,
``compress_device`` and ``decompress_device`` around five hand-written
kernels (``csrc/rans.cu``): ``rans_tables``, ``rans_encode``,
``rans_layout`` and ``rans_write`` code a store flush, ``rans_decode``
decodes a batch of blobs.

Counterpart of agc_tpu's ``ops/device_rans.py``. Its blobs are byte-equal
to the host coder's (``core/entropy.py``): the tables follow
``entropy.quantize_freqs``' integer rule, and the state machine, its
uint32 arithmetic and the blob layout of ``entropy.assemble_blob`` are the
same.

Which engine runs where:

- CUDA tensors (``device="cuda"``): the kernels. A flush is uploaded once
  (its parts' bytes, a meta row a part and the encode's schedule) and
  coded on the card with no sync until its download: ``rans_tables``
  (each part's histogram and quantized frequencies, and the encoder's
  reciprocal table), ``rans_encode`` (every lane of every part: its byte
  count and final state), then ``rans_write``, which runs ``rans_layout``
  (each part's blob size, raw or coded, and the blobs' and lanes' offsets
  by one device-wide scan) and writes each part's whole blob, or its raw
  escape, at its offset (the coded parts' lanes run again and write their
  bytes in place) into a buffer sized from the flush's shapes
  (``blob_cap``); the host downloads the offsets, then the blobs' bytes,
  and slices them. ``rans_decode`` decodes a batch of blobs in one launch,
  one thread a lane, by a schedule of work rows made on the host
  (``_decode_rows``): 256 lanes of a large blob a block, up to 8 small
  blobs of one tier a block; a symbol comes from the blob's 4096-slot
  table in shared memory, and the row's stream bytes are staged there.
- CPU tensors (``device="cpu"``): their plain PyTorch versions
  (``rans_tables_plain``: bincounts and ``quantize_plain``, the same
  closed form of ``quantize_freqs`` as torch ops across parts;
  ``rans_encode_plain``: agc_tpu's ``_encode_batch_fn``, a loop over
  steps of (B, L) int64 ops a lane tier, dividing by f;
  ``blob_offsets``: the layout by cumsums; ``rans_write_plain``: its
  streams, and the blobs by scatters; ``rans_decode_plain``:
  ``_decode_fn``). They are the oracle the kernels are held against;
  nothing runs them for a CUDA tensor.
- The engine reaches this module only when ``AGC_TPU_RANS_DEVICE`` forces
  it (``entropy.compress_parts``); otherwise the host's native coder codes
  every part.

agc_tpu groups a batch by (lane tier, pow2 steps bucket), cuts the groups
into chunks of 512 parts and pads shapes to powers of two, for XLA's
compile cache and its TPU link. None of that changes a byte, and there is
no compile cache here, so one ragged launch a kernel takes the whole flush.

``encode_batch`` runs as five module functions, looked up at call time so
that a caller can time each: ``_prepare`` (host: concatenation, one meta
row a part and the encode's work rows, from the lengths alone),
``_upload``, ``code_flush`` (the kernels), ``_download`` and ``_slice``.

State arithmetic in the plain versions is int64 (torch has no uint32
shift): states stay below 2^31 and ``f * (x >> 12) + slot`` below 2^31,
so every value is exact; the decoder masks to 32 bits where the kernel's
uint32 would wrap on a damaged blob. uint32 tables (the reciprocals) are
held in int32 tensors, bit for bit.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core import entropy as E
from . import _build, resolve_device
from .cuda_kmers import _check_cuda, _count, _require, _stream

_X_MAX_BASE = (E.RANS_L >> E.PROB_BITS) << 8  # x_max = _X_MAX_BASE * f
_M32 = 0xFFFFFFFF
_LANES = (1, 8, 64, 256, 1024)
_EMPTY_BLOB = bytes([E.MAGIC, 0, 0])  # header of n = 0
_CHUNK = 1 << 16  # csrc/rans.cu's kChunk: bytes of a part a histogram / raw-copy block
_TILE = 8  # parts a block of rans_layout (a warp a part)
_INVALID_SIZE = 1 << 40  # csrc/rans.cu's kInvalidSize: the blob of a part with no valid table
# rans_encode's work rows (csrc/rans.cu): (kind, index into sel, first lane
# or parts)
_BLOCK_PART, _WARP_PART, _LANE_PART = 0, 1, 2
_BLOCK_LANES, _WARP_PARTS, _LANE_PARTS = 256, 8, 256  # a block's lanes or parts


def _lanes_np(lens: np.ndarray) -> np.ndarray:
    """entropy.lanes_for of every length."""
    lanes = np.ones(len(lens), dtype=np.int64)
    for lo, n_lanes in reversed(E._LANE_TIERS):  # ascending thresholds
        lanes[lens >= lo] = n_lanes
    return lanes


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) -> the int32 tensor of the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def varint_len(v: torch.Tensor) -> torch.Tensor:
    """LEB128 byte count of each non-negative int64 value."""
    edges = torch.tensor([1 << (7 * k) for k in range(1, 9)], dtype=torch.int64,
                         device=v.device)
    return torch.bucketize(v.to(torch.int64).contiguous(), edges, right=True) + 1


def varints(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LEB128 bytes of each non-negative value, concatenated (uint8), and
    each value's byte count."""
    v = v.to(torch.int64).reshape(-1)
    nbytes = varint_len(v)
    width = int(nbytes.max()) if v.numel() else 1
    k = torch.arange(width, device=v.device)
    groups = (v[:, None] >> (7 * k)) & 0x7F
    more = (k[None, :] < nbytes[:, None] - 1).to(torch.int64) << 7
    return (groups | more)[k[None, :] < nbytes[:, None]].to(torch.uint8), nbytes


def _ranges(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The indices start .. start + len - 1 of every range, concatenated."""
    lens = lens.to(torch.int64)
    total = int(lens.sum()) if lens.numel() else 0
    first = torch.cumsum(lens, 0) - lens
    idx = torch.arange(total, device=lens.device)
    return torch.repeat_interleave(starts - first, lens, output_size=total) + idx


def _put_varints(out: torch.Tensor, pos: torch.Tensor, v: torch.Tensor) -> None:
    """Write the varint of each value at its position in ``out``."""
    b, nb = varints(v)
    out[_ranges(pos.reshape(-1), nb)] = b


_ZEROED: dict[tuple[int, int], torch.Tensor] = {}
_zeroed_lock = threading.Lock()


def _zeroed(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Scratch of at least ``n_bytes`` on ``t``'s device for kernels on its
    current stream, zero when a kernel starts: ``rans_tables`` (each part's
    counts and mark) and ``rans_layout`` (its look-back's status words)
    leave it zero when they end, so no memset runs before them. One buffer
    a stream: launches on it run in order."""
    key = (t.device.index, _stream(t))
    with _zeroed_lock:
        buf = _ZEROED.get(key)
        if buf is None or buf.numel() < n_bytes:
            buf = torch.zeros(max(n_bytes, 1 << 16), dtype=torch.uint8, device=t.device)
            _ZEROED[key] = buf
        return buf


# ---------------------------------------------------------------------------
# rans_tables
# ---------------------------------------------------------------------------


def quantize_plain(counts: torch.Tensor) -> torch.Tensor:
    """``entropy.quantize_freqs`` of every row of int64[P, 256] counts
    (each row's sum > 0), as torch ops across rows, in the closed form the
    ``rans_tables`` kernel computes: q = c * 4096 // total, every present
    symbol raised to 1; then, for diff = 4096 - sum(q) > 0, each present
    symbol gets diff // m, and the first diff % m of them by (-rem, symbol)
    one more (the +1s cycle over the m present symbols); for diff < 0, the
    passes of -1 over (rem, symbol) each take from the symbols with q > 1
    then, so K - 1 whole passes take min(q - 1, K - 1) from each and pass K
    one from the first of the symbols with q > K, K the least pass whose
    running total reaches -diff."""
    c = counts.to(torch.int64)
    dev = c.device
    total = c.sum(dim=1, keepdim=True)
    q = c * E.PROB_SCALE // total
    rem = c * E.PROB_SCALE % total
    present = c > 0
    q = torch.where(present & (q == 0), 1, q)
    diff = E.PROB_SCALE - q.sum(dim=1, keepdim=True)
    sym = torch.arange(256, dtype=torch.int64, device=dev)

    def rank(key):  # position of each entry in its row, keys ascending
        return torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1)

    m = present.sum(dim=1, keepdim=True)
    up = rank(torch.where(present, -(rem * 256 + (255 - sym)) - 1, 0))
    plus = torch.where(present, diff.clamp(min=0) // m + (up < diff.clamp(min=0) % m), 0)
    need = (-diff).clamp(min=0)

    def taken(k):  # decrements in passes 1 .. k
        return torch.minimum((q - 1).clamp(min=0), k).sum(dim=1, keepdim=True)

    lo = torch.ones_like(need)
    hi = torch.full_like(need, E.PROB_SCALE)
    for _ in range(13):  # the least K in [1, 4096] with taken(K) >= need
        mid = (lo + hi) // 2
        ok = taken(mid) >= need
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    k_last = lo
    eligible = q > k_last
    down = rank(torch.where(eligible, rem * 256 + sym, 1 << 62))
    minus = (torch.minimum((q - 1).clamp(min=0), k_last - 1)
             + (eligible & (down < need - taken(k_last - 1))).to(torch.int64))
    q = torch.where(diff > 0, q + plus, torch.where(diff < 0, q - minus, q))
    return q.to(torch.int32)


def enc_table_plain(freqs: torch.Tensor) -> torch.Tensor:
    """The encoder's symbol table of int32[P, 256] frequencies, as
    ``rans_tables`` writes it: int32[P, 256, 2] (uint32 bits), the
    reciprocal ceil(2^(shift + 31) / f) with 2^(shift - 1) < f <= 2^shift
    (0xFFFFFFFF for f = 1), then bias | (shift - 1) << 13 | f << 17 with
    bias = the cumulative frequency (+ 4095 for f = 1); 0 for f = 0."""
    f = freqs.to(torch.int64)
    start = torch.cumsum(f, dim=1) - f
    shift = torch.zeros_like(f)
    for b in range(13):  # the bit length of f - 1
        shift = shift + ((f - 1) >= (1 << b)).to(torch.int64)
    fs = f.clamp(min=2)
    rcp = ((1 << (shift.clamp(min=1) + 31)) + fs - 1) // fs
    word = start | ((shift - 1).clamp(min=0) << 13) | (f << 17)
    rcp = torch.where(f == 1, _M32, rcp)
    word = torch.where(f == 1, (start + E.PROB_SCALE - 1) | (1 << 17), word)
    rcp = torch.where(f == 0, 0, rcp)
    word = torch.where(f == 0, 0, word)
    return _as_i32(torch.stack((rcp, word), dim=-1))


def _part_ids(meta: torch.Tensor, per: torch.Tensor) -> torch.Tensor:
    """The part of each of ``per[p]`` consecutive items of every part."""
    return torch.repeat_interleave(torch.arange(meta.shape[0], device=meta.device), per)


def rans_tables_plain(data: torch.Tensor, meta: torch.Tensor):
    """Plain version of ``rans_tables``: each part's bincount, then
    ``quantize_plain`` and ``enc_table_plain``."""
    p = meta.shape[0]
    off, n = meta[:, 0], meta[:, 1]
    pid = _part_ids(meta, n)
    sym = data[_ranges(off, n)].long()
    counts = torch.zeros(p * 256, dtype=torch.int64, device=data.device)
    counts.index_add_(0, pid * 256 + sym, torch.ones_like(sym))
    freqs = quantize_plain(counts.reshape(p, 256))
    return freqs, enc_table_plain(freqs)


def _check_flush(name: str, data: torch.Tensor, meta: torch.Tensor) -> None:
    _require(data.dim() == 1 and data.dtype == torch.uint8, f"{name}: data must be uint8[N]")
    _require(meta.dim() == 2 and meta.shape[1] == 4 and meta.dtype == torch.int64
             and meta.shape[0] > 0, f"{name}: meta must be int64[P, 4], P > 0")


def _chunk_rows(lens: np.ndarray) -> np.ndarray:
    """int64[C, 2], (part, start) of every 64 KB of every part of these
    lengths, in order: the chunk list the kernels take (``_prepare``
    builds it; the card checks each entry against its neighbour)."""
    n_chunks = -(-lens // _CHUNK)
    c_part = np.repeat(np.arange(len(lens)), n_chunks)
    c_start = np.arange(len(c_part)) - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    return np.stack([c_part, c_start * _CHUNK], axis=1)


def _check_chunks(name: str, meta: torch.Tensor, chunks: torch.Tensor) -> None:
    """The chunk list's shape; on the CPU also its entries, which must be
    ``_chunk_rows`` of the parts' lengths (on the card the kernels check
    them, and the download raises)."""
    _require(chunks.dim() == 2 and chunks.shape[1] == 2 and chunks.dtype == torch.int64,
             f"{name}: chunks must be int64[C, 2]")
    if chunks.device.type == "cpu" and meta.device.type == "cpu":
        want = _chunk_rows(meta[:, 1].numpy())
        _require(chunks.shape == want.shape and (chunks.numpy() == want).all(),
                 f"{name}: chunks must be (part, start) of every 64 KB of every part, "
                 "in order, as _prepare builds them")


def rans_tables(data: torch.Tensor, meta: torch.Tensor, chunks: torch.Tensor):
    """Each part's quantized frequencies and the encoder's symbol table.

    data: uint8[N], the parts' symbols concatenated; meta: int64[P, 4], a
    row a part: data offset, length n >= 1, lanes ``lanes_for(n)``, its
    first lane in the flush; chunks: int64[C, 2], (part, start) of every
    64 KB of every part. ``_prepare`` builds these. Returns (int32[P, 256]
    frequencies, equal to ``entropy.quantize_freqs`` of each part's counts;
    int32[P, 256, 2] the table of ``enc_table_plain``). On the card, two
    launches (histograms a chunk a block, then a warp a part); a chunk list
    that is not ``_prepare``'s gives its parts tables of zeros, which
    ``rans_write`` does not write and ``_download`` refuses."""
    _check_flush("rans_tables", data, meta)
    _check_chunks("rans_tables", meta, chunks)
    if data.device.type == "cpu":
        return rans_tables_plain(data, meta)
    _check_cuda("rans_tables", data, meta, chunks)
    _require(data.data_ptr() % 16 == 0, "rans_tables: data must be 16-byte aligned")
    p, c = meta.shape[0], chunks.shape[0]
    _require(c >= p, "rans_tables: every part has a chunk")
    scratch = _zeroed(data, 4 * 257 * p)  # counts and a mark a part
    freqs = torch.empty((p, 256), dtype=torch.int32, device=data.device)
    enc = torch.empty((p, 256, 2), dtype=torch.int32, device=data.device)
    with torch.cuda.device(data.device):
        rc = _build.lib().agc_rans_tables(data.data_ptr(), data.numel(), meta.data_ptr(),
                                          chunks.data_ptr(), c, p, scratch.data_ptr(),
                                          freqs.data_ptr(), enc.data_ptr(), _stream(data))
    _build.check(rc, "rans_tables")
    _count("rans_tables")
    return freqs, enc


# ---------------------------------------------------------------------------
# rans_encode
# ---------------------------------------------------------------------------


def _n_lanes(meta: torch.Tensor) -> int:
    """Lanes of a flush: its last part's first lane and lane count."""
    _off, _n, n_lane, lane0 = meta[-1].tolist()
    return lane0 + n_lane


def _encode_plain(data: torch.Tensor, meta: torch.Tensor, enc: torch.Tensor):
    """agc_tpu's ``_encode_batch_fn`` over each lane tier's parts (x // f
    and x % f, the frequencies and their cumulative sums taken from
    ``enc``), then ``_pack_part_streams``' reversed masks: (uint8 the lanes'
    streams in decode order, lane after lane; int32[lanes] their byte
    counts; int32[lanes] final states, uint32 bits)."""
    dev = data.device
    rows = meta.tolist()
    n_lanes = _n_lanes(meta)
    counts = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    states = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    f_all = (enc[..., 1].long() >> 17) & 0x1FFF
    c_all = torch.cumsum(f_all, dim=1) - f_all
    tiers: dict[int, list[int]] = {}
    for i, row in enumerate(rows):
        tiers.setdefault(row[2], []).append(i)
    packed = []
    for n_lane, idx in sorted(tiers.items()):
        ix = torch.tensor(idx, dtype=torch.int64, device=dev)
        off, lens, lane0 = meta[ix, 0], meta[ix, 1], meta[ix, 3]
        b = len(idx)
        steps = max(-(-rows[i][1] // n_lane) for i in idx)
        lane = torch.arange(n_lane, dtype=torch.int64, device=dev)
        pos = torch.arange(steps, dtype=torch.int64, device=dev)[:, None] * n_lane + lane
        live = pos[None] < lens[:, None, None]  # (B, steps, L)
        grid = data[torch.where(live, off[:, None, None] + pos[None], 0)].long()
        f_tab, c_tab = f_all[ix], c_all[ix]
        x = torch.full((b, n_lane), E.RANS_L, dtype=torch.int64, device=dev)
        bts = torch.zeros((steps, b, n_lane, 2), dtype=torch.uint8, device=dev)
        cnts = torch.zeros((steps, b, n_lane), dtype=torch.uint8, device=dev)
        for i, t in enumerate(range(steps - 1, -1, -1)):  # scan order = emission order
            active = live[:, t]
            s = grid[:, t]
            f = torch.where(active, f_tab.gather(1, s), 1)
            c = c_tab.gather(1, s)
            x_max = _X_MAX_BASE * f
            for j in range(2):  # encode renorm emits at most 2 bytes
                emit = active & (x >= x_max)
                bts[i, :, :, j] = torch.where(emit, x & 0xFF, 0).to(torch.uint8)
                cnts[i] += emit.to(torch.uint8)
                x = torch.where(emit, x >> 8, x)
            x = torch.where(active, ((x // f) << E.PROB_BITS) + x % f + c, x)
        # lane-major emission order, reversed into decode order
        arr = bts.permute(1, 2, 0, 3).reshape(b, n_lane, 2 * steps).flip(-1)
        two = torch.arange(2, device=dev)
        msk = (two < cnts[..., None]).permute(1, 2, 0, 3).reshape(b, n_lane, 2 * steps).flip(-1)
        lanes_ix = (lane0[:, None] + lane).reshape(-1)
        counts[lanes_ix] = msk.sum(-1).reshape(-1).to(torch.int32)
        states[lanes_ix] = _as_i32(x.reshape(-1))
        packed.append((lanes_ix, arr, msk))
    lane_out = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    flat = torch.empty(int(counts.sum()), dtype=torch.uint8, device=dev)
    for lanes_ix, arr, msk in packed:
        rank = torch.cumsum(msk, dim=-1) - 1
        dst = lane_out[lanes_ix].reshape(msk.shape[:2])[..., None] + rank
        flat[dst[msk]] = arr[msk]
    return flat, counts, states


def rans_encode_plain(data: torch.Tensor, meta: torch.Tensor, enc: torch.Tensor,
                      sel: torch.Tensor | None = None, work: torch.Tensor | None = None):
    """Plain version of ``rans_encode``: the counts and states of
    ``_encode_plain``. The schedule (``sel``, ``work``) changes no output
    and is not read."""
    _flat, counts, states = _encode_plain(data, meta, enc)
    return counts, states


def rans_encode(data: torch.Tensor, meta: torch.Tensor, enc: torch.Tensor,
                sel: torch.Tensor, work: torch.Tensor, n_lanes: int | None = None):
    """Run every lane of every part of a flush in one launch: each lane's
    byte count and final state (``rans_write`` runs the coded parts' lanes
    again to write their bytes in place, once the blobs' offsets are known).

    data, meta: as for ``rans_tables``; enc: its symbol table; sel:
    int32[P] the parts in work order, work: int32[B, 3] a row a block
    (kind, index into sel, first lane or parts), both from ``_prepare``;
    n_lanes: the flush's lanes (``Prepared.n_lanes``), required on the
    card, where reading them from meta would wait on it; the plain version
    reads meta. Returns (int32[lanes] the streams' byte counts;
    int32[lanes] final states, uint32 bits)."""
    _check_flush("rans_encode", data, meta)
    p = meta.shape[0]
    _require(enc.shape == (p, 256, 2) and enc.dtype == torch.int32,
             "rans_encode: enc must be int32[P, 256, 2]")
    _require(sel.shape == (p,) and sel.dtype == torch.int32
             and work.dim() == 2 and work.shape[1] == 3 and work.dtype == torch.int32,
             "rans_encode: sel must be int32[P], work int32[B, 3]")
    if data.device.type == "cpu":
        return rans_encode_plain(data, meta, enc, sel, work)
    _check_cuda("rans_encode", data, meta, enc, sel, work)
    _require(n_lanes is not None, "rans_encode: n_lanes (Prepared.n_lanes) is required on the "
             "card: reading it from meta would sync")
    counts = torch.empty(n_lanes, dtype=torch.int32, device=data.device)
    states = torch.empty_like(counts)
    with torch.cuda.device(data.device):
        rc = _build.lib().agc_rans_encode(
            data.data_ptr(), meta.data_ptr(), enc.data_ptr(), sel.data_ptr(), work.data_ptr(),
            work.shape[0], counts.data_ptr(), states.data_ptr(), _stream(data))
    _build.check(rc, "rans_encode")
    _count("rans_encode")
    return counts, states


# ---------------------------------------------------------------------------
# rans_write
# ---------------------------------------------------------------------------


def _lane_sums(meta: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(each part's sum of the per-lane values v, each lane's exclusive
    prefix within its part)."""
    cs = torch.zeros(v.numel() + 1, dtype=torch.int64, device=v.device)
    cs[1:] = torch.cumsum(v.to(torch.int64), 0)
    lane0, n_lane = meta[:, 3], meta[:, 2]
    pid = _part_ids(meta, n_lane)
    return cs[lane0 + n_lane] - cs[lane0], cs[:-1] - cs[lane0][pid]


def blob_offsets(meta: torch.Tensor, freqs: torch.Tensor, counts: torch.Tensor):
    """The layout of a flush's blobs, from the sizes of
    ``entropy.assemble_blob`` (header, 256 frequency varints, a lane-length
    varint and 4 state bytes a lane, the streams; or the raw escape, header
    + n, where that is not smaller; 2^40 bytes, past any buffer, where the
    frequencies do not sum to 4096: ``rans_tables``' table of zeros for a
    chunk list that is not ``_prepare``'s): (int64[P + 1] each blob's
    offset in the flush's buffer; int64[P] where its streams start in that
    buffer, -1 for a raw escape; int64[lanes + 1] the exclusive prefix sum
    of the lanes' byte counts)."""
    n, n_lane, lane0 = meta[:, 1], meta[:, 2], meta[:, 3]
    head = 2 + varint_len(n)
    lane_cs = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=counts.device)
    lane_cs[1:] = torch.cumsum(counts, 0)
    vl = torch.zeros_like(lane_cs)
    vl[1:] = torch.cumsum(varint_len(counts), 0)
    streams = (head + varint_len(freqs).sum(dim=1) + 4 * n_lane
               + vl[lane0 + n_lane] - vl[lane0])
    coded = streams + lane_cs[lane0 + n_lane] - lane_cs[lane0]
    raw = coded >= head + n
    bad = freqs.sum(dim=1) != E.PROB_SCALE
    size = torch.where(bad, _INVALID_SIZE, torch.where(raw, head + n, coded))
    blob_off = torch.zeros(n.numel() + 1, dtype=torch.int64, device=n.device)
    blob_off[1:] = torch.cumsum(size, 0)
    return blob_off, torch.where(raw | bad, -1, blob_off[:-1] + streams), lane_cs


def rans_layout(meta: torch.Tensor, freqs: torch.Tensor, counts: torch.Tensor):
    """``blob_offsets`` on the card, with no sync: a warp a part sums its
    frequency and lane-length varints and its lanes' byte counts and
    chooses raw or coded, and one device-wide scan (decoupled look-back
    over tiles of 8 parts) gives the offsets. Inputs and outputs as for
    ``blob_offsets``."""
    _require(meta.dim() == 2 and meta.shape[1] == 4 and meta.dtype == torch.int64
             and meta.shape[0] > 0, "rans_layout: meta must be int64[P, 4], P > 0")
    _require(freqs.shape == (meta.shape[0], 256) and freqs.dtype == torch.int32,
             "rans_layout: freqs must be int32[P, 256]")
    _require(counts.dim() == 1 and counts.dtype == torch.int32,
             "rans_layout: counts must be int32[lanes]")
    if meta.device.type == "cpu":
        return blob_offsets(meta, freqs, counts)
    _check_cuda("rans_layout", meta, freqs, counts)
    p = meta.shape[0]
    _require(p < 1 << 21, "rans_layout: at most 2^21 - 1 parts")  # sums below 2^62
    tiles = -(-p // _TILE)
    status = _zeroed(meta, 8 * (2 * tiles + 1))
    blob_off = torch.empty(p + 1, dtype=torch.int64, device=meta.device)
    stream_at = torch.empty(p, dtype=torch.int64, device=meta.device)
    lane_cs = torch.empty(counts.numel() + 1, dtype=torch.int64, device=meta.device)
    with torch.cuda.device(meta.device):
        rc = _build.lib().agc_rans_layout(
            meta.data_ptr(), freqs.data_ptr(), counts.data_ptr(), p, status.data_ptr(),
            blob_off.data_ptr(), stream_at.data_ptr(), lane_cs.data_ptr(), _stream(meta))
    _build.check(rc, "rans_layout")
    _count("rans_layout")
    return blob_off, stream_at, lane_cs


def blob_cap(n_data: int, n_parts: int) -> int:
    """Bytes that hold every blob of a flush of n_parts parts tiling
    n_data bytes, from its shapes alone: a blob is never larger than its
    raw escape, 2 + varint_len(n) + n, and no n exceeds n_data."""
    return n_data + n_parts * (2 + E._varint_len(n_data))


def rans_write_plain(data, meta, freqs, enc, counts, states, blob_off):
    """Plain version of ``rans_write``: the streams of ``_encode_plain``,
    every blob byte by scatters."""
    dev = data.device
    flat, _counts, _states = _encode_plain(data, meta, enc)
    out = torch.zeros(int(blob_off[-1]), dtype=torch.uint8, device=dev)
    off, n, n_lane, lane0 = meta.unbind(1)
    at = blob_off[:-1]
    head = 2 + varint_len(n)
    raw = blob_off[1:] - at == head + n
    log2_l = torch.zeros_like(n_lane)
    for k in range(1, 11):
        log2_l += (n_lane >= 1 << k).to(torch.int64)
    out[at] = E.MAGIC
    out[at + 1] = torch.where(raw, E._RAW_FLAG, log2_l).to(torch.uint8)
    _put_varints(out, at + 2, n)
    r = raw.nonzero().squeeze(1)
    out[_ranges(at[r] + head[r], n[r])] = data[_ranges(off[r], n[r])]
    coded = ~raw
    fv = varint_len(freqs)
    fpos = (at + head)[:, None] + torch.cumsum(fv, dim=1) - fv
    _put_varints(out, fpos[coded], freqs[coded])
    pid = _part_ids(meta, n_lane)
    keep = coded[pid]
    l_bytes, l_at = _lane_sums(meta, varint_len(counts))
    _s_bytes, s_at = _lane_sums(meta, counts)
    lens_at = (at + head + fv.sum(dim=1))[pid]
    _put_varints(out, (lens_at + l_at)[keep], counts[keep])
    local = torch.arange(pid.numel(), device=dev) - lane0[pid]
    states_at = lens_at + l_bytes[pid] + 4 * local
    for k in range(4):
        out[states_at[keep] + k] = ((states[keep].long() >> (8 * k)) & 0xFF).to(torch.uint8)
    src = torch.cumsum(counts, 0) - counts
    dst = lens_at + l_bytes[pid] + 4 * n_lane[pid] + s_at
    out[_ranges(dst[keep], counts[keep])] = flat[_ranges(src[keep], counts[keep])]
    return out


def rans_write(data: torch.Tensor, meta: torch.Tensor, chunks: torch.Tensor,
               sel: torch.Tensor, work: torch.Tensor, freqs: torch.Tensor, enc: torch.Tensor,
               counts: torch.Tensor, states: torch.Tensor):
    """Every part's blob of ``entropy.assemble_blob`` (or its raw escape)
    into one buffer: (uint8[S], the blobs back to back in its first
    blob_off[-1] bytes; int64[P + 1] their offsets). Inputs: the flush as
    ``rans_encode`` takes it (data, meta, chunks, sel, work; parts tiling
    data), ``rans_tables``' outputs and ``rans_encode``'s on it. The layout
    is ``rans_layout``'s; on the card S is ``blob_cap(N, P)``, known
    before the layout, so nothing waits on the host; the coded parts'
    lanes run again and write their streams in place, raw payloads are
    copied as 16-byte words. A chunk list that is not ``_prepare``'s sets
    blob_off[P] to -1 on the card, which ``_download`` refuses."""
    _check_flush("rans_write", data, meta)
    _check_chunks("rans_write", meta, chunks)
    p = meta.shape[0]
    _require(enc.shape == (p, 256, 2) and enc.dtype == torch.int32,
             "rans_write: enc must be int32[P, 256, 2]")
    _require(counts.shape == states.shape and states.dtype == torch.int32,
             "rans_write: counts, states must be int32[lanes]")
    blob_off, stream_at, lane_cs = rans_layout(meta, freqs, counts)
    if data.device.type == "cpu":
        _require(int(blob_off[-1]) <= blob_cap(data.numel(), p),
                 "rans_write: a part's tables are not valid")
        return rans_write_plain(data, meta, freqs, enc, counts, states, blob_off), blob_off
    _check_cuda("rans_write", data, meta, chunks, sel, work, freqs, enc, counts, states)
    _require(data.data_ptr() % 16 == 0 and data.numel() < _INVALID_SIZE,
             "rans_write: data must be 16-byte aligned, below 2^40 bytes")
    _require(chunks.shape[0] >= p, "rans_write: every part has a chunk")
    cap = blob_cap(data.numel(), p)
    out = torch.empty(cap, dtype=torch.uint8, device=data.device)
    live = torch.empty(work.shape[0], dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        rc = _build.lib().agc_rans_write(
            data.data_ptr(), data.numel(), meta.data_ptr(), chunks.data_ptr(), chunks.shape[0],
            enc.data_ptr(), sel.data_ptr(), work.data_ptr(), work.shape[0], freqs.data_ptr(),
            counts.data_ptr(), states.data_ptr(), blob_off.data_ptr(), stream_at.data_ptr(),
            lane_cs.data_ptr(), p, cap, out.data_ptr(), live.data_ptr(), _stream(data))
    _build.check(rc, "rans_write")
    _count("rans_write")
    return out, blob_off


def code_flush(data: torch.Tensor, meta: torch.Tensor, chunks: torch.Tensor,
               sel: torch.Tensor, work: torch.Tensor, n_lanes: int | None = None):
    """A flush's blobs on ``data``'s device: ``rans_tables``, then
    ``rans_encode``, then ``rans_write``, with no sync on the card (which
    needs n_lanes, ``Prepared.n_lanes``). Returns (uint8 blobs back to
    back, int64[P + 1] offsets)."""
    freqs, enc = rans_tables(data, meta, chunks)
    counts, states = rans_encode(data, meta, enc, sel, work, n_lanes)
    return rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)


# ---------------------------------------------------------------------------
# rans_decode
# ---------------------------------------------------------------------------


_DECODE_BLOBS = 8  # csrc/rans.cu's kDecodeBlobs: blobs a decode block at most


def _check_decode_meta(meta, n_lanes: int, n_freqs: int) -> None:
    """Refuse, before any launch, a meta that is not ``blob_tensors``':
    n >= 1 and L = lanes_for(n) a blob, lanes and outputs back to back,
    the lanes those of ``states``, a frequency row a blob."""
    _require(isinstance(meta, np.ndarray) and meta.dtype == np.int64 and meta.ndim == 2
             and meta.shape[1] == 4 and 1 <= len(meta) < (1 << 31),
             "rans_decode: meta must be a host int64[B, 4] array, B >= 1")
    n, lanes, lane0, out0 = meta.T
    _require(bool((n >= 1).all()) and bool((lanes == _lanes_np(n)).all()),
             "rans_decode: a blob's n must be >= 1 and its L lanes_for(n)")
    _require(bool((lane0 == np.cumsum(lanes) - lanes).all()) and int(lanes.sum()) == n_lanes,
             "rans_decode: the blobs' lanes must follow one another and be the states'")
    _require(bool((out0 == np.cumsum(n) - n).all()),
             "rans_decode: the blobs' outputs must follow one another")
    _require(n_freqs == len(meta), "rans_decode: freqs must hold a row a blob")


def _decode_rows(meta: np.ndarray):
    """``rans_decode``'s schedule: (sel int32[B], the blobs in work order;
    work int32[W, 3] rows (first index into sel, blobs, first lane)).
    Tiers from the largest: a row a 256-lane slice of a 256- or 1024-lane
    blob; smaller blobs of one tier packed into a row, 256 / max(L, 16) of
    them, at most 8."""
    lanes = meta[:, 1]
    sel, rows = [], []
    first = 0
    for n_lanes in reversed(_LANES):
        idx = np.flatnonzero(lanes == n_lanes)
        if not len(idx):
            continue
        if n_lanes >= _BLOCK_LANES:
            per = n_lanes // _BLOCK_LANES
            r = np.arange(len(idx) * per)
            rows.append(np.stack([first + r // per, np.ones_like(r), (r % per) * _BLOCK_LANES],
                                 axis=1))
        else:
            per = min(_BLOCK_LANES // max(n_lanes, 16), _DECODE_BLOBS)
            at = np.arange(0, len(idx), per)
            rows.append(np.stack([first + at, np.minimum(per, len(idx) - at),
                                  np.zeros_like(at)], axis=1))
        sel.append(idx)
        first += len(idx)
    return (np.concatenate(sel).astype(np.int32),
            np.concatenate(rows).astype(np.int32).reshape(-1, 3))


def rans_decode_plain(stream: torch.Tensor, lane_off: torch.Tensor, states: torch.Tensor,
                      freqs: torch.Tensor, meta: np.ndarray) -> torch.Tensor:
    """Plain version of ``rans_decode``: agc_tpu's ``_decode_fn`` over every
    lane of every blob at once, the symbol as the rank ``sum(cum[1:] <=
    slot)`` (one ``searchsorted`` over all blobs' cum rows, each offset by
    8192 times its blob), a lane's bytes read at its cursor inside its
    range."""
    dev = stream.device
    n_blob = len(meta)
    n, lanes, lane0, out0 = torch.from_numpy(meta).to(dev).unbind(1)
    blob = torch.repeat_interleave(torch.arange(n_blob, device=dev), lanes,
                                   output_size=states.numel())
    lane = torch.arange(states.numel(), device=dev) - lane0[blob]
    n_l, l_l = n[blob], lanes[blob]
    steps = torch.where(lane < n_l, (n_l - lane + l_l - 1) // l_l, 0)
    size = stream.numel()
    start = lane_off[:-1].clamp(0, size)
    length = torch.maximum(lane_off[1:].clamp(max=size), start) - start
    f_tab = freqs.long()
    cum = torch.zeros((n_blob, 257), dtype=torch.int64, device=dev)
    cum[:, 1:] = torch.cumsum(f_tab, 1)
    keys = (torch.arange(n_blob, device=dev)[:, None] * 8192 + cum[:, 1:256]).reshape(-1)
    x = states.long() & _M32
    cur = torch.zeros_like(x)
    out = torch.zeros(int(meta[-1, 0] + meta[-1, 3]), dtype=torch.uint8, device=dev)
    at = out0[blob] + lane
    data = stream.long()
    for t in range(int(((meta[:, 0] + meta[:, 1] - 1) // meta[:, 1]).max())):
        active = t < steps
        slot = x & (E.PROB_SCALE - 1)
        s = (torch.searchsorted(keys, blob * 8192 + slot, right=True) - blob * 255).clamp(0, 255)
        out[(at + t * l_l)[active]] = s[active].to(torch.uint8)
        nx = (f_tab[blob, s] * (x >> E.PROB_BITS) + slot - cum[blob, s]) & _M32
        x = torch.where(active, nx, x)
        for _ in range(2):  # decode renorm reads at most 2 bytes
            need = active & (x < E.RANS_L)
            byte = (torch.where(cur < length, data[(start + cur).clamp(max=size - 1)], 0)
                    if size else torch.zeros_like(x))
            x = torch.where(need, (x << 8) | byte, x)
            cur = cur + need.long()
    return out


def rans_decode(stream: torch.Tensor, lane_off: torch.Tensor, states: torch.Tensor,
                freqs: torch.Tensor, meta: np.ndarray) -> torch.Tensor:
    """Decode a batch of blobs in one launch.

    stream: uint8[S], every lane's stream back to back; lane_off:
    int64[lanes + 1] their offsets; states: int64[lanes] the final encoder
    states (uint32 values); freqs: int32[B, 256]; meta: int64[B, 4] on the
    host, a row a blob (n, L = lanes_for(n), first lane, output offset),
    as ``blob_tensors`` makes them. Returns uint8[sum n], each blob's
    symbols at its offset. A malformed meta is refused before the launch;
    a lane reads only inside its lane_off range, clamped to the stream."""
    _require(stream.dim() == 1 and stream.dtype == torch.uint8,
             "rans_decode: stream must be uint8[S]")
    _require(states.dim() == 1 and states.dtype == torch.int64,
             "rans_decode: states must be int64[lanes]")
    _require(lane_off.shape == (states.numel() + 1,) and lane_off.dtype == torch.int64,
             "rans_decode: lane_off must be int64[lanes + 1]")
    _require(freqs.dim() == 2 and freqs.shape[1] == 256 and freqs.dtype == torch.int32,
             "rans_decode: freqs must be int32[B, 256]")
    _check_decode_meta(meta, states.numel(), freqs.shape[0])
    if stream.device.type == "cpu":
        return rans_decode_plain(stream, lane_off, states, freqs, meta)
    _check_cuda("rans_decode", stream, lane_off, states, freqs)
    dev = stream.device
    sel, work = _decode_rows(meta)
    meta_d, sel_d, work_d = (torch.from_numpy(a).to(dev) for a in (meta, sel, work))
    out = torch.empty(int(meta[-1, 0] + meta[-1, 3]), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().agc_rans_decode(
            stream.data_ptr(), stream.numel(), lane_off.data_ptr(), states.data_ptr(),
            freqs.data_ptr(), meta_d.data_ptr(), sel_d.data_ptr(), work_d.data_ptr(),
            work.shape[0], out.data_ptr(), _stream(stream),
        )
    _build.check(rc, "rans_decode")
    _count("rans_decode")
    return out


# ---------------------------------------------------------------------------
# batched part encode (the stages of a flush)
# ---------------------------------------------------------------------------


@dataclass
class Prepared:
    """A flush's non-empty parts on the host: symbols, meta rows, the
    encode's schedule."""

    data: np.ndarray  # uint8[N]
    meta: np.ndarray  # int64[P, 4]
    chunks: np.ndarray  # int64[C, 2]
    sel: np.ndarray  # int32[P]
    work: np.ndarray  # int32[B, 3]

    @property
    def n_lanes(self) -> int:
        return int(self.meta[-1, 2] + self.meta[-1, 3])


def _work_rows(kind: int, first: int, count: int, per: int) -> np.ndarray:
    starts = np.arange(first, first + count, per)
    return np.stack([np.full_like(starts, kind), starts,
                     np.minimum(per, first + count - starts)], axis=1)


def _prepare(parts: list) -> Prepared:
    """What the lengths give: offsets, lane tiers, meta rows, the 64 KB
    chunks and the encode's work rows (large parts first, 256 lanes a
    block, then the warp parts, then the one-lane parts)."""
    lens = np.fromiter(map(len, parts), dtype=np.int64, count=len(parts))
    data = np.concatenate([np.frombuffer(p, dtype=np.uint8) for p in parts])
    offs = np.cumsum(lens) - lens
    lanes = _lanes_np(lens)
    lane0 = np.cumsum(lanes) - lanes
    meta = np.stack([offs, lens, lanes, lane0], axis=1)
    chunks = _chunk_rows(lens)
    groups = (np.flatnonzero(lanes >= 256), np.flatnonzero((lanes == 8) | (lanes == 64)),
              np.flatnonzero(lanes == 1))
    first = np.cumsum([0] + [len(g) for g in groups])
    per_big = lanes[groups[0]] // _BLOCK_LANES
    big = np.repeat(np.arange(len(groups[0])), per_big)
    big_lane = (np.arange(len(big)) - np.repeat(np.cumsum(per_big) - per_big, per_big))
    work = np.concatenate([
        np.stack([np.full_like(big, _BLOCK_PART), big, big_lane * _BLOCK_LANES], axis=1)
        .reshape(-1, 3),
        _work_rows(_WARP_PART, int(first[1]), len(groups[1]), _WARP_PARTS),
        _work_rows(_LANE_PART, int(first[2]), len(groups[2]), _LANE_PARTS),
    ]).astype(np.int32)
    return Prepared(data, meta, chunks, np.concatenate(groups).astype(np.int32), work)


def _upload(prep: Prepared, dev: torch.device):
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (prep.data, prep.meta, prep.chunks, prep.sel, prep.work))


def _download(out: torch.Tensor, blob_off: torch.Tensor):
    """The offsets (the flush's one sync), then the blobs' bytes alone.
    Raises where the card refused the flush: blob_off[-1] is -1 (a chunk
    list that ``rans_write`` found not to be ``_prepare``'s) or past the
    buffer (a part without valid tables, from ``rans_tables``)."""
    offs = blob_off.cpu().tolist()
    _require(0 <= offs[-1] <= out.numel(),
             "the flush failed on the card: its chunk list is not _prepare's "
             f"(blob_off[-1] = {offs[-1]}, buffer {out.numel()} bytes)")
    return out[: offs[-1]].cpu().numpy(), offs


def _slice(flat: np.ndarray, blob_off: list) -> list[bytes]:
    view = memoryview(flat)
    return [bytes(view[a:b]) for a, b in zip(blob_off[:-1], blob_off[1:])]


def encode_batch(payloads: list, device="cuda") -> list[bytes]:
    """Blobs byte-identical to ``entropy.compress`` of each payload, every
    non-empty part coded in one ``code_flush`` on ``device``."""
    dev = resolve_device(device)
    out = [_EMPTY_BLOB] * len(payloads)
    live = [i for i, p in enumerate(payloads) if len(p)]
    if not live:
        return out
    prep = _prepare([payloads[i] for i in live])
    blobs = _slice(*_download(*code_flush(*_upload(prep, dev), n_lanes=prep.n_lanes)))
    for i, blob in zip(live, blobs):
        out[i] = blob
    return out


def compress_device(data, level: int = 0, device="cuda") -> bytes:
    """Device twin of ``entropy.compress`` (identical blobs); ``level`` is
    ignored, as there."""
    return encode_batch([data], device)[0]


def _parse_blob(blob, expected_size: int | None):
    """A blob's decoded bytes where it is empty or a raw escape, else
    (stream bytes, lane lengths, states, freqs, n) on the host. Raises
    ValueError where agc_tpu's decoder does, and for a frequency table that
    does not sum to 4096 (the slot table needs the full scale)."""
    n, flags, freqs, lane_lens, states, pos = E.parse_header(blob)
    if n == 0:
        return b""
    # agc_tpu's hostile-size policy: a size header disagreeing with the
    # part metadata, or an absurd size, is corruption, never an allocation
    if (expected_size is not None and expected_size and n != expected_size) or (
        n > (64 << 30)
    ):
        raise ValueError("corrupt rANS blob")
    buf = memoryview(blob)
    if flags & E._RAW_FLAG:
        raw = bytes(buf[pos : pos + n])
        if len(raw) != n:  # truncated raw-escape payload
            raise ValueError("corrupt rANS blob")
        return raw
    if int(freqs.sum()) != E.PROB_SCALE:
        raise ValueError("corrupt rANS blob")
    flat = np.frombuffer(buf, dtype=np.uint8, count=int(lane_lens.sum()), offset=pos)
    return flat, lane_lens, states, freqs, n


def blob_tensors(blobs: list, dev: torch.device, expected_sizes: list | None = None):
    """``rans_decode``'s inputs for a list of blobs: (done, args). done[i]
    is blob i's bytes where it is empty or a raw escape, None where it is
    coded; args is (stream, lane_off, states, freqs, meta) of the coded
    blobs in order, on ``dev`` (meta on the host), or None without one.
    Raises as ``_parse_blob``."""
    sizes = expected_sizes if expected_sizes is not None else [None] * len(blobs)
    done, coded = [], []
    for blob, size in zip(blobs, sizes, strict=True):
        got = _parse_blob(blob, size)
        done.append(got if isinstance(got, bytes) else None)
        if not isinstance(got, bytes):
            coded.append(got)
    if not coded:
        return done, None
    flat, lane_lens, states, freqs, n = zip(*coded)
    lane_lens = np.concatenate(lane_lens)
    offs = np.zeros(len(lane_lens) + 1, dtype=np.int64)
    np.cumsum(lane_lens, out=offs[1:])
    n = np.array(n, dtype=np.int64)
    lanes = _lanes_np(n)
    meta = np.stack([n, lanes, np.cumsum(lanes) - lanes, np.cumsum(n) - n], axis=1)
    return done, (torch.from_numpy(np.concatenate(flat)).to(dev), torch.from_numpy(offs).to(dev),
                  torch.from_numpy(np.concatenate(states).astype(np.int64)).to(dev),
                  torch.from_numpy(np.stack(freqs).astype(np.int32)).to(dev), meta)


def _decoded(done: list, out: torch.Tensor, meta: np.ndarray) -> list[bytes]:
    """Every blob's bytes: ``done``'s, and the coded blobs' slices of
    ``rans_decode``'s output in order."""
    flat = memoryview(out.cpu().numpy())
    coded = iter(zip(meta[:, 3].tolist(), (meta[:, 3] + meta[:, 0]).tolist()))
    return [d if d is not None else bytes(flat[slice(*next(coded))]) for d in done]


def decompress_device(blob, expected_size: int | None = None, device="cuda") -> bytes:
    """Device twin of ``entropy.decompress``: one ``rans_decode`` launch
    over a batch of this one blob."""
    done, args = blob_tensors([blob], resolve_device(device), [expected_size])
    if args is None:
        return done[0]
    return _decoded(done, rans_decode(*args), args[4])[0]
