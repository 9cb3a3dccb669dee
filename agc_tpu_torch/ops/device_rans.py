"""The device rANS coder of the tpu-rans profile: ``encode_batch``,
``compress_device`` and ``decompress_device`` around two hand-written
kernels, ``rans_encode`` and ``rans_decode`` (``csrc/rans.cu``).

Counterpart of agc_tpu's ``ops/device_rans.py``. Its blobs are byte-equal
to the host coder's (``core/entropy.py``): the same lane-interleaved state
machine, the same uint32 arithmetic, the same blob assembly. The frequency
tables are quantized on the host by ``entropy.quantize_freqs`` for every
engine, so all of them consume identical tables.

Which engine runs where:

- CUDA tensors (``device="cuda"``): the kernels. ``rans_encode`` codes
  every part of a flush in one launch, one block a part and one thread a
  lane, then compacts the lanes' streams into one flat buffer (a prefix
  sum of their byte counts and a gather kernel); ``rans_decode`` decodes
  one blob, one thread a lane.
- CPU tensors (``device="cpu"``): their plain PyTorch versions,
  ``rans_encode_plain`` (agc_tpu's ``_encode_batch_fn``: a loop over steps
  of (B, L) int64 ops, one group of parts a lane tier) and
  ``rans_decode_plain`` (``_decode_fn``). They are the oracle the kernels
  are held against; nothing runs them for a CUDA tensor.
- The engine reaches this module only when ``AGC_TPU_RANS_DEVICE`` forces
  it (``entropy.compress_parts``); otherwise the host's native coder codes
  every part.

agc_tpu groups a batch by (lane tier, pow2 steps bucket), cuts the groups
into chunks of 512 parts and pads shapes to powers of two, for XLA's
compile cache and its TPU link. None of that changes a byte (padded slots
are inactive), and there is no compile cache here, so one ragged launch
takes the whole flush.

``encode_batch`` runs as five module functions, looked up at call time so
that a caller can time each: ``_prepare`` (host: concatenation, symbol
counts, ``quantize_freqs``, one meta row a part), ``_upload``,
``rans_encode``, ``_download`` and ``_assemble`` (blob headers, with the
lane-length varints built by numpy, and ``assemble_blob``'s raw-escape
decision).

State arithmetic in the plain versions is int64 (torch has no uint32
shift): states stay below 2^31 and ``f * (x >> 12) + slot`` below 2^31,
so every value is exact; the decoder masks to 32 bits where the kernel's
uint32 would wrap on a damaged blob.
"""

from __future__ import annotations

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


def _lanes_np(lens: np.ndarray) -> np.ndarray:
    """entropy.lanes_for of every length."""
    lanes = np.ones(len(lens), dtype=np.int64)
    for lo, n_lanes in reversed(E._LANE_TIERS):  # ascending thresholds
        lanes[lens >= lo] = n_lanes
    return lanes


# ---------------------------------------------------------------------------
# rans_encode
# ---------------------------------------------------------------------------


def rans_encode_plain(data: torch.Tensor, meta: torch.Tensor, freqs: torch.Tensor):
    """Plain version of ``rans_encode``: agc_tpu's ``_encode_batch_fn``
    over each lane tier's parts, then ``_pack_part_streams``' reversed
    masks, placed at the lanes' prefix-sum offsets."""
    dev = data.device
    rows = meta.tolist()
    n_lanes = rows[-1][3] + rows[-1][2] if rows else 0
    counts = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    states = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
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
        f_tab = freqs[ix].long()
        c_tab = torch.cumsum(f_tab, dim=1) - f_tab
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
        states[lanes_ix] = x.reshape(-1).to(torch.int32)
        packed.append((lanes_ix, arr, msk))
    lane_out = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    out = torch.empty(int(counts.sum()), dtype=torch.uint8, device=dev)
    for lanes_ix, arr, msk in packed:
        rank = torch.cumsum(msk, dim=-1) - 1
        dst = lane_out[lanes_ix].reshape(msk.shape[:2])[..., None] + rank
        out[dst[msk]] = arr[msk]
    return out, counts, states


def rans_encode(data: torch.Tensor, meta: torch.Tensor, freqs: torch.Tensor):
    """Encode the parts of a flush in one launch.

    data: uint8[N], the parts' symbols concatenated; meta: int64[P, 5], a
    row a part: data offset, length n >= 1, lanes ``lanes_for(n)``, its
    first lane in the flush, the base of its lanes' regions (each lane
    2 * ceil(n / L) bytes); freqs: int32[P, 256] quantized frequencies.
    ``_prepare`` builds these; the kernel trusts their offsets. Returns
    (uint8[S] the lanes' streams in decode order, lane after lane;
    int32[lanes] their byte counts; int32[lanes] final states)."""
    _require(data.dim() == 1 and data.dtype == torch.uint8, "rans_encode: data must be uint8[N]")
    _require(meta.dim() == 2 and meta.shape[1] == 5 and meta.dtype == torch.int64,
             "rans_encode: meta must be int64[P, 5]")
    _require(freqs.shape == (meta.shape[0], 256) and freqs.dtype == torch.int32,
             "rans_encode: freqs must be int32[P, 256]")
    if data.device.type == "cpu":
        return rans_encode_plain(data, meta, freqs)
    _check_cuda("rans_encode", data, meta, freqs)
    p = meta.shape[0]
    _require(p > 0, "rans_encode: no part")
    _off, n, n_lane, lane0, base = meta[-1].tolist()
    region = torch.empty(base + n_lane * 2 * -(-n // n_lane), dtype=torch.uint8,
                         device=data.device)
    counts = torch.empty(lane0 + n_lane, dtype=torch.int32, device=data.device)
    states = torch.empty_like(counts)
    lib = _build.lib()
    with torch.cuda.device(data.device):
        rc = lib.agc_rans_encode(data.data_ptr(), meta.data_ptr(), freqs.data_ptr(), p,
                                 region.data_ptr(), counts.data_ptr(), states.data_ptr(),
                                 _stream(data))
        _build.check(rc, "rans_encode")
        lane_out = torch.cumsum(counts, 0, dtype=torch.int64) - counts
        out = torch.empty(int(lane_out[-1] + counts[-1]), dtype=torch.uint8,
                          device=data.device)
        rc = lib.agc_rans_compact(region.data_ptr(), meta.data_ptr(), counts.data_ptr(),
                                  lane_out.data_ptr(), p, out.data_ptr(), _stream(data))
    _build.check(rc, "rans_compact")
    _count("rans_encode")
    return out, counts, states


# ---------------------------------------------------------------------------
# rans_decode
# ---------------------------------------------------------------------------


def rans_decode_plain(stream: torch.Tensor, lane_off: torch.Tensor, states: torch.Tensor,
                      freqs: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of ``rans_decode``: agc_tpu's ``_decode_fn``, the
    symbol as the rank ``sum(cum[1:] <= slot)`` (by ``searchsorted``), bytes through a zero-padded
    (L, max_len + 1) matrix and a per-lane cursor."""
    dev = stream.device
    n_lane = states.numel()
    lens = lane_off[1:] - lane_off[:-1]
    max_len = int(lens.max())
    mat = torch.zeros((n_lane, max_len + 1), dtype=torch.uint8, device=dev)
    lane_of = torch.repeat_interleave(torch.arange(n_lane, device=dev), lens)
    col = torch.arange(lane_of.numel(), device=dev) - lane_off[lane_of]
    mat[lane_of, col] = stream[: lane_of.numel()]
    f_tab = freqs.long()
    cum = torch.zeros(257, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(f_tab, 0)
    x = states.long() & _M32
    cur = torch.zeros(n_lane, dtype=torch.int64, device=dev)
    lane = torch.arange(n_lane, device=dev)
    steps = -(-n // n_lane)
    out = torch.empty((steps, n_lane), dtype=torch.uint8, device=dev)
    for t in range(steps):
        active = t * n_lane + lane < n
        slot = x & (E.PROB_SCALE - 1)
        s = torch.searchsorted(cum[1:], slot, right=True).clamp(max=255)
        out[t] = s.to(torch.uint8)
        nx = (f_tab[s] * (x >> E.PROB_BITS) + slot - cum[s]) & _M32
        x = torch.where(active, nx, x)
        for _ in range(2):  # decode renorm reads at most 2 bytes
            need = active & (x < E.RANS_L)
            byte = mat.gather(1, cur.clamp(max=max_len)[:, None])[:, 0].long()
            x = torch.where(need, (x << 8) | byte, x)
            cur = cur + need.long()
    return out.reshape(-1)[:n]


def rans_decode(stream: torch.Tensor, lane_off: torch.Tensor, states: torch.Tensor,
                freqs: torch.Tensor, n: int) -> torch.Tensor:
    """Decode one blob's lanes.

    stream: uint8[S], the blob's concatenated lane streams; lane_off:
    int64[L + 1] their offsets; states: int64[L] the final encoder states
    (uint32 values); freqs: int32[256]; n: the symbol count. L is
    ``lanes_for(n)``. Returns uint8[n]."""
    _require(stream.dim() == 1 and stream.dtype == torch.uint8,
             "rans_decode: stream must be uint8[S]")
    _require(states.dim() == 1 and states.dtype == torch.int64 and states.numel() in _LANES,
             "rans_decode: states must be int64[L], L in (1, 8, 64, 256, 1024)")
    n_lane = states.numel()
    _require(lane_off.shape == (n_lane + 1,) and lane_off.dtype == torch.int64,
             "rans_decode: lane_off must be int64[L + 1]")
    _require(freqs.shape == (256,) and freqs.dtype == torch.int32,
             "rans_decode: freqs must be int32[256]")
    _require(n >= n_lane, "rans_decode: n must be at least the lane count")
    if stream.device.type == "cpu":
        return rans_decode_plain(stream, lane_off, states, freqs, n)
    _check_cuda("rans_decode", stream, lane_off, states, freqs)
    out = torch.empty(n, dtype=torch.uint8, device=stream.device)
    with torch.cuda.device(stream.device):
        rc = _build.lib().agc_rans_decode(
            stream.data_ptr(), lane_off.data_ptr(), states.data_ptr(), freqs.data_ptr(),
            n, n_lane, out.data_ptr(), _stream(stream),
        )
    _build.check(rc, "rans_decode")
    _count("rans_decode")
    return out


# ---------------------------------------------------------------------------
# batched part encode (the stages of a flush)
# ---------------------------------------------------------------------------


@dataclass
class Prepared:
    """A flush's non-empty parts on the host: symbols, meta rows, tables."""

    data: np.ndarray  # uint8[N]
    meta: np.ndarray  # int64[P, 5], rans_encode's rows
    freqs: np.ndarray  # int32[P, 256]


def _prepare(parts: list) -> Prepared:
    lens = np.fromiter(map(len, parts), dtype=np.int64, count=len(parts))
    data = np.concatenate([np.frombuffer(p, dtype=np.uint8) for p in parts])
    offs = np.cumsum(lens) - lens
    lanes = _lanes_np(lens)
    lane0 = np.cumsum(lanes) - lanes
    region = lanes * 2 * (-(-lens // lanes))
    freqs = np.stack([
        E.quantize_freqs(np.bincount(data[o : o + n], minlength=256))
        for o, n in zip(offs.tolist(), lens.tolist())
    ]).astype(np.int32)
    meta = np.stack([offs, lens, lanes, lane0, np.cumsum(region) - region], axis=1)
    return Prepared(data, meta, freqs)


def _upload(prep: Prepared, dev: torch.device):
    return tuple(torch.from_numpy(a).to(dev) for a in (prep.data, prep.meta, prep.freqs))


def _download(flat: torch.Tensor, counts: torch.Tensor, states: torch.Tensor):
    return flat.cpu().numpy(), counts.cpu().numpy(), states.cpu().numpy()


def varints(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """LEB128 bytes of each non-negative value, concatenated (uint8), and
    each value's byte count."""
    v = np.asarray(v, dtype=np.uint64).reshape(-1)
    nbytes = np.ones(v.shape, dtype=np.int64)
    rest = v >> np.uint64(7)
    while rest.any():
        nbytes += rest > 0
        rest >>= np.uint64(7)
    width = int(nbytes.max()) if v.size else 1
    k = np.arange(width, dtype=np.int64)
    groups = (v[:, None] >> (np.uint64(7) * k.astype(np.uint64))) & np.uint64(0x7F)
    more = (k[None, :] < nbytes[:, None] - 1).astype(np.uint64) << np.uint64(7)
    return (groups | more).astype(np.uint8)[k[None, :] < nbytes[:, None]], nbytes


def _assemble(prep: Prepared, flat: np.ndarray, counts: np.ndarray,
              states: np.ndarray) -> list[bytes]:
    """The blobs of ``entropy.assemble_blob``: header, frequency and
    lane-length varints, states, streams, or the raw escape where rANS
    would not pay."""
    offs, lens, lanes, lane0, _ = prep.meta.T.tolist()
    n_parts = len(lens)
    f_bytes, f_n = varints(prep.freqs)
    f_end = np.cumsum(f_n.reshape(n_parts, 256).sum(axis=1)).tolist()
    l_bytes, l_n = varints(counts)
    l_end = np.cumsum(np.add.reduceat(l_n, lane0)).tolist()
    s_end = np.cumsum(np.add.reduceat(counts.astype(np.int64), lane0)).tolist()
    f_bytes, l_bytes = f_bytes.tobytes(), l_bytes.tobytes()
    st, fl = states.astype("<u4").tobytes(), flat.tobytes()
    blobs = []
    f0 = l0 = s0 = 0
    for p in range(n_parts):
        n, n_lane = lens[p], lanes[p]
        head = bytearray((E.MAGIC, n_lane.bit_length() - 1))
        E._put_varint(head, n)
        blob = b"".join((head, f_bytes[f0 : f_end[p]], l_bytes[l0 : l_end[p]],
                         st[4 * lane0[p] : 4 * (lane0[p] + n_lane)], fl[s0 : s_end[p]]))
        if len(blob) >= n + 2 + E._varint_len(n):
            raw = bytearray((E.MAGIC, E._RAW_FLAG))
            E._put_varint(raw, n)
            blob = bytes(raw) + prep.data[offs[p] : offs[p] + n].tobytes()
        blobs.append(blob)
        f0, l0, s0 = f_end[p], l_end[p], s_end[p]
    return blobs


def encode_batch(payloads: list, device="cuda") -> list[bytes]:
    """Blobs byte-identical to ``entropy.compress`` of each payload, every
    non-empty part coded in one ``rans_encode`` launch on ``device``."""
    dev = resolve_device(device)
    out = [_EMPTY_BLOB] * len(payloads)
    live = [i for i, p in enumerate(payloads) if len(p)]
    if not live:
        return out
    prep = _prepare([payloads[i] for i in live])
    host = _download(*rans_encode(*_upload(prep, dev)))
    for i, blob in zip(live, _assemble(prep, *host)):
        out[i] = blob
    return out


def compress_device(data, level: int = 0, device="cuda") -> bytes:
    """Device twin of ``entropy.compress`` (identical blobs); ``level`` is
    ignored, as there."""
    return encode_batch([data], device)[0]


def blob_tensors(blob, dev: torch.device, expected_size: int | None = None):
    """``rans_decode``'s inputs for a blob on ``dev``, (stream, lane_off,
    states, freqs, n), or the decoded bytes themselves for an empty or
    raw-escape blob. Raises ValueError where agc_tpu's decoder does, and
    for a frequency table that does not sum to 4096 (the slot table
    needs the full scale)."""
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
    offs = np.zeros(len(lane_lens) + 1, dtype=np.int64)
    np.cumsum(lane_lens, out=offs[1:])
    flat = np.frombuffer(buf, dtype=np.uint8, count=int(offs[-1]), offset=pos).copy()
    return (torch.from_numpy(flat).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(states.astype(np.int64)).to(dev),
            torch.from_numpy(freqs.astype(np.int32)).to(dev), n)


def decompress_device(blob, expected_size: int | None = None, device="cuda") -> bytes:
    """Device twin of ``entropy.decompress``: one ``rans_decode`` launch."""
    args = blob_tensors(blob, resolve_device(device), expected_size)
    if isinstance(args, bytes):
        return args
    return rans_decode(*args).cpu().numpy().tobytes()
