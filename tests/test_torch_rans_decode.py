"""The batched ``rans_decode`` of agc_tpu_torch on the CPU (its plain
version) against the host coder's ``entropy.decompress`` and agc_tpu's
``decompress_device`` (JAX on the CPU), blob for blob: every lane tier's
edges, single-symbol blobs, blobs with frequency-1 symbols, and batches
that mix all tiers with empty blobs and raw escapes. Also held here: the
decode's schedule (``_decode_rows``), every lane of every blob covered
exactly once by the kernel's mapping of its work rows, models of the
kernel's slot table fill (against agc_tpu's rank) and of its stream
staging, and the refusal of a malformed meta before any decode.
"""

import numpy as np
import pytest
import torch

from agc_tpu.core import entropy as TE
from agc_tpu.ops import device_rans as TD
from agc_tpu_torch.core import entropy as E
from agc_tpu_torch.ops import device_rans as D

CPU = torch.device("cpu")
THREADS = 256  # csrc/rans.cu's kThreads


def _payloads(seed: int = 3) -> list:
    """rans_cases-style payloads: every tier's edges, a single symbol at
    several tiers, frequency-1 symbols (two-byte renorms), skewed 4- to
    16-symbol alphabets, an empty part and a raw escape."""
    rng = np.random.default_rng(seed)

    def sym(alpha: int, n: int) -> bytes:
        return rng.integers(0, alpha, n, dtype=np.uint16).astype(np.uint8).tobytes()

    out = [sym(5, n) for n in (1, 2, 63, 64, 1023, 1024, 8191, 8192, 65535, 65536)]
    out += [bytes([7]) * n for n in (1, 63, 64, 5000, 70_000)]  # one symbol
    rare = np.zeros(20_000, dtype=np.uint8)
    rare[rng.choice(len(rare), 12, replace=False)] = rng.integers(1, 256, 12)
    out.append(rare.tobytes())
    for n in (17, 300, 3000, 30_000):
        alpha = int(rng.integers(4, 17))
        p = rng.random(alpha) ** 3
        out.append(rng.choice(alpha, n, p=p / p.sum()).astype(np.uint8).tobytes())
    out += [b"", rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()]
    return out


def coded_blob(data: bytes) -> bytes:
    """The coded form of a payload, kept where ``entropy.assemble_blob``
    would escape it (a payload under ~600 bytes): the decoders take it, and
    it is how the 1- and 8-lane tiers are reached."""
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = E.quantize_freqs(np.bincount(arr, minlength=256))
    streams, states = E._encode_lanes(arr, freqs)
    out = bytearray([E.MAGIC, E.lanes_for(len(data)).bit_length() - 1])
    for v in (len(data), *freqs.tolist(), *map(len, streams)):
        E._put_varint(out, int(v))
    for x in states:
        out += int(x).to_bytes(4, "little")
    return bytes(out + b"".join(streams))


def _decode_batch(blobs, sizes=None, **kw):
    done, args = D.blob_tensors(blobs, CPU, sizes)
    if args is None:
        return done
    return D._decoded(done, D.rans_decode(*args, **kw), args[4])


def test_batch_equals_host_coder_and_agc_tpu():
    payloads = _payloads()
    blobs = [E.compress(p) for p in payloads]
    assert blobs == [TE.compress(p) for p in payloads]
    # the small payloads' coded forms, which compress escapes
    small = [p for p in payloads if 0 < len(p) < 1024]
    payloads += small
    blobs += [coded_blob(p) for p in small]
    lanes = {E.lanes_for(len(p)) for p, b in zip(payloads, blobs)
             if len(p) and not b[1] & E._RAW_FLAG}
    assert lanes == {1, 8, 64, 256, 1024}
    got = _decode_batch(blobs, [len(p) for p in payloads])
    assert got == payloads
    assert got == [E.decompress(b) for b in blobs]
    assert got == [TD.decompress_device(b) for b in blobs]


@pytest.mark.parametrize("n", [63, 64, 1023, 1024, 8191, 8192, 65535, 65536])
def test_tier_edges_one_blob_a_batch(n):
    """Each edge alone through decompress_device, and with its neighbour
    tier's edge in one batch."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 6, n, dtype=np.uint8).tobytes()
    b = rng.integers(0, 3, n + 1, dtype=np.uint8).tobytes()
    blob_a, blob_b = E.compress(a), E.compress(b)
    assert D.decompress_device(blob_a, n, device="cpu") == a == TD.decompress_device(blob_a, n)
    assert _decode_batch([blob_b, blob_a]) == [b, a]


def test_mixed_tiers_in_every_schedule_mode():
    """The same batch, many blobs of each tier (more than a row holds),
    decoded whole and each tier in a batch of its own, so that every kind
    of work row the kernel's schedule makes is decoded beside others and
    alone."""
    rng = np.random.default_rng(11)
    sizes = np.concatenate([rng.integers(1, 64, 70), rng.integers(64, 1024, 40),
                            rng.integers(1024, 8192, 9), rng.integers(8192, 65536, 3),
                            rng.integers(65536, 150_000, 2)])
    rng.shuffle(sizes)
    payloads = [rng.integers(0, int(rng.integers(1, 17)), int(n), dtype=np.uint8).tobytes()
                for n in sizes]
    blobs = [coded_blob(p) if len(p) < 1024 else E.compress(p) for p in payloads]
    assert _decode_batch(blobs) == payloads
    tiers = [E.lanes_for(len(p)) for p in payloads]
    for t in (1, 8, 64, 256, 1024):
        pick = [i for i, x in enumerate(tiers) if x == t]
        assert _decode_batch([blobs[i] for i in pick]) == [payloads[i] for i in pick]


def _lanes_of_rows(meta, sel, work):
    """(blob, lane) of every thread that decodes, as the kernel maps its
    work rows: a row's blobs split the 256 threads evenly."""
    seen = []
    for first, count, lane0 in work.tolist():
        assert 1 <= count <= D._DECODE_BLOBS
        per = THREADS // count
        for t in range(THREADS):
            r = t // per
            if r >= count:
                continue
            b = int(sel[first + r])
            n, lanes = int(meta[b, 0]), int(meta[b, 1])
            lane = lane0 + t % per
            if lane < lanes and lane < n:
                seen.append((b, lane))
    return seen


def _schedule_meta(seed: int):
    rng = np.random.default_rng(seed)
    n = np.concatenate([rng.integers(1, 64, 300), rng.integers(64, 1024, 77),
                        rng.integers(1024, 8192, 13), rng.integers(8192, 65536, 5),
                        rng.integers(65536, 1 << 20, 4), [1, 63, 64, 1023, 1024, 8191,
                                                          8192, 65535, 65536]])
    rng.shuffle(n)
    lanes = D._lanes_np(n)
    return np.stack([n, lanes, np.cumsum(lanes) - lanes, np.cumsum(n) - n], axis=1)


@pytest.mark.parametrize("seed", [1, 8, 64, 256, 2048])
def test_schedule_covers_every_lane_once(seed):
    meta = _schedule_meta(seed)
    lanes = meta[:, 1]
    sel, work = D._decode_rows(meta)
    assert sorted(sel.tolist()) == list(range(len(meta)))
    # a row holds one tier: a 256-lane slice, or 256 / max(L, 16) blobs
    for first, count, lane0 in work.tolist():
        tier = {int(lanes[sel[first + r]]) for r in range(count)}
        assert len(tier) == 1
        (t,) = tier
        assert count == 1 if t >= THREADS else (count <= THREADS // max(t, 16) and lane0 == 0)
    seen = _lanes_of_rows(meta, sel, work)
    assert len(seen) == len(set(seen)) == int(lanes.sum())


def _rank(freqs: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """agc_tpu's symbol of a slot: sum(cum[1:256] <= slot)."""
    cum = np.concatenate([[0], np.cumsum(freqs)])
    return (cum[None, 1:256] <= slots[:, None]).sum(axis=1)


def slot_table_model(freqs: np.ndarray, count: int) -> np.ndarray:
    """The kernel's slot table (csrc/rans.cu, rans_decode_kernel) in a row
    of count blobs, 256 // count threads a blob: a thread fills a run of
    16-slot chunks (the last thread's cut at 4096, none past it), the first
    slot's symbol by a binary search of cum (rank_in), the next ones' by
    one more symbol where the symbol's range ends, and a binary search
    again where that one's range has ended too."""
    cum = np.concatenate([[0], np.cumsum(freqs)])

    def rank_in(slot, lo, hi):
        while lo < hi:
            mid = (lo + hi) >> 1
            if cum[mid + 1] <= slot:
                lo = mid + 1
            else:
                hi = mid
        return lo

    out = np.full(E.PROB_SCALE, -1, dtype=np.int64)
    tpb = THREADS // count  # threads a blob
    span = 16 * -(-256 // tpb)  # slots a thread
    for lo in range(0, tpb * span, span):
        if lo >= E.PROB_SCALE:
            continue
        s = rank_in(lo, 0, 255)
        end = cum[s + 1] if s < 255 else E.PROB_SCALE
        for slot in range(lo, min(lo + span, E.PROB_SCALE)):
            if slot >= end:
                s += 1
                if s < 255 and cum[s + 1] <= slot:
                    s = rank_in(slot, s + 1, 255)
                end = cum[s + 1] if s < 255 else E.PROB_SCALE
            out[slot] = s
    return out


def _freq_cases() -> dict:
    rng = np.random.default_rng(5)
    cases = {"uniform": np.full(256, 16), "one symbol": np.eye(256, dtype=np.int64)[200] * 4096,
             "first and last": np.zeros(256, dtype=np.int64)}
    cases["first and last"][[0, 255]] = [1, 4095]
    ones = np.zeros(256, dtype=np.int64)
    ones[rng.choice(256, 200, replace=False)] = 1
    ones[int(np.flatnonzero(ones == 0)[0])] = 4096 - 200
    cases["frequency-1 symbols"] = ones
    # the alphabet of a create's coded parts: text digits, a few letters and
    # 255, with long runs of frequency-0 symbols between
    text = np.zeros(256, dtype=np.int64)
    text[[33, 44, 46, *range(48, 58), 65, 66, 67, 68, 255]] = rng.integers(1, 500, 18)
    cases["digits and 255"] = E.quantize_freqs(text)
    for i in range(6):
        alpha = int(rng.integers(2, 257))
        counts = np.zeros(256, dtype=np.int64)
        counts[rng.choice(256, alpha, replace=False)] = (rng.random(alpha) ** 4 * 1e5).astype(
            np.int64) + 1
        cases[f"quantized {i}"] = E.quantize_freqs(counts)
    return cases


@pytest.mark.parametrize("case", ["uniform", "one symbol", "first and last", "frequency-1 symbols",
                                  "digits and 255"] + [f"quantized {i}" for i in range(6)])
def test_slot_table_equals_rank(case):
    freqs = np.asarray(_freq_cases()[case], dtype=np.int64)
    assert freqs.sum() == E.PROB_SCALE
    slots = np.arange(E.PROB_SCALE)
    for count in range(1, D._DECODE_BLOBS + 1):
        assert np.array_equal(slot_table_model(freqs, count), _rank(freqs, slots))


SMEM, BLOB_BYTES = 44 << 10, 5120  # csrc/rans.cu's kDecodeBytes, kBlobBytes


def test_stage_holds_every_staged_lane():
    """The kernel's staging (rans_decode_kernel): a row's blobs' byte
    ranges placed back to back, each at an offset of its alignment in the
    stream, in the shared bytes its tables leave while they fit; every
    lane of a staged blob must read its whole range there, none past the
    stage, for every alignment of the stream."""
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, int(rng.integers(2, 17)), int(n), dtype=np.uint8).tobytes()
                for n in np.exp(rng.uniform(0, np.log(200_000), 300)).astype(np.int64)]
    blobs = [coded_blob(p) if len(p) < 1024 else E.compress(p) for p in payloads]
    _done, (stream, lane_off, _states, _freqs, meta) = D.blob_tensors(blobs, CPU)
    off = lane_off.numpy()
    size = stream.numel()
    sel, work = D._decode_rows(meta)
    n_staged = 0
    for base in range(16):  # the stream's address mod 16
        for first, count, lane0 in work.tolist():
            cap = SMEM - count * BLOB_BYTES
            ranges, at, run = [], [], 0
            for r in range(count):
                _n, lanes, g, _o = meta[sel[first + r]]
                nl = min(lanes - lane0, THREADS)
                lo = min(max(off[g + lane0], 0), size)
                hi = min(max(off[g + lane0 + nl], lo), size)
                ranges.append((lo, hi))
                a = -(-run // 16) * 16 + (base + lo) % 16
                assert (a - (base + lo)) % 16 == 0
                at.append(a if a + hi - lo <= cap else -1)
                run = run if at[-1] < 0 else a + hi - lo
            assert run <= cap
            for r, (lo, hi) in enumerate(ranges):
                if at[r] < 0:
                    continue
                n_staged += 1
                _n, lanes, g, _o = meta[sel[first + r]]
                for lane in range(lane0, min(lanes, lane0 + THREADS)):
                    start, end = off[g + lane], off[g + lane + 1]
                    assert lo <= start <= end <= hi
    assert n_staged > 0


def _meta_cases(meta):
    bad = {}
    m = meta.copy()
    m[1, 1] = 8  # L not lanes_for(n)
    bad["a wrong lane count"] = m
    m = meta.copy()
    m[2, 2] += 1
    bad["lanes not back to back"] = m
    m = meta.copy()
    m[1, 3] += 1
    bad["outputs not back to back"] = m
    m = meta.copy()
    m[0, 0] = 0
    bad["an empty blob"] = m
    bad["int32 meta"] = meta.astype(np.int32)
    bad["meta on a tensor"] = torch.from_numpy(meta)
    bad["a blob cut off"] = meta[:-1]
    return bad


@pytest.mark.parametrize("case", ["a wrong lane count", "lanes not back to back",
                                  "outputs not back to back", "an empty blob", "int32 meta",
                                  "meta on a tensor", "a blob cut off"])
def test_malformed_meta_is_refused_before_a_decode(case, monkeypatch):
    payloads = [b"ACGT" * 50, bytes(range(16)) * 100, b"AC" * 20]
    _done, (stream, lane_off, states, freqs, meta) = D.blob_tensors(
        [coded_blob(p) for p in payloads], CPU)
    assert len(meta) == 3

    def no_decode(*_a, **_k):
        raise AssertionError("decoded a malformed batch")

    monkeypatch.setattr(D, "rans_decode_plain", no_decode)
    with pytest.raises(ValueError, match="rans_decode"):
        D.rans_decode(stream, lane_off, states, freqs, _meta_cases(meta)[case])


def test_blob_tensors_layout():
    """Coded blobs back to back, raw and empty ones answered on the host."""
    payloads = [b"", b"ACGT" * 300, bytes(range(256)) * 40, b"Z" * 10]
    blobs = [E.compress(p) for p in payloads[:3]] + [coded_blob(payloads[3])]
    done, (stream, lane_off, states, freqs, meta) = D.blob_tensors(blobs, CPU)
    assert done[0] == b"" and done[2] == payloads[2] and done[1] is None and done[3] is None
    assert meta.tolist() == [[1200, 64, 0, 0], [10, 1, 64, 1200]]
    assert lane_off.numel() == states.numel() + 1 == 66 and freqs.shape == (2, 256)
    assert int(lane_off[-1]) == stream.numel()
    assert D._decoded(done, D.rans_decode(stream, lane_off, states, freqs, meta), meta) == payloads
