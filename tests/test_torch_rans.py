"""The port's device rANS coder (agc_tpu_torch/ops/device_rans.py) against
agc_tpu's (agc_tpu/ops/device_rans.py, JAX on the CPU) and the host coder,
with device='cpu': the kernels' plain versions. Blobs and archives are
bytes, so the tolerance is 0 everywhere.

Also held here: the tables' closed form (quantize_plain) against both
packages' quantize_freqs, the encoder's reciprocal step against the
division, a model of the rans_encode and rans_write kernels' ragged
indexing, reciprocal arithmetic and in-place writes (part and lane bases,
bytes backwards, whole aligned words inside a lane's stream, single bytes
at its ends) against agc_tpu's _pack_part_streams, the encode's schedule
and the blobs' layout, and the blob writer's plain version against
entropy.assemble_blob.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from agc_tpu.core import entropy as TE
from agc_tpu.core.compressor import CompressorParams as TpuParams
from agc_tpu.core.compressor import append_archive as tpu_append
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.core.decompressor import Decompressor
from agc_tpu.ops import device_rans as TD
from agc_tpu_torch.core import entropy as E
from agc_tpu_torch.core.compressor import CompressorParams, append_archive, create_archive
from agc_tpu_torch.ops import device_rans as D

from test_torch_create import assert_same_archive
from util import make_collection, mutate, write_fa

TIERS = (1, 8, 64, 256, 1024)


def _cases():
    """tests/test_entropy.py's cases, then every lane tier's edges."""
    rng = np.random.default_rng(7)
    cases = [
        b"",
        b"Z",
        b"ACGT" * 64,
        bytes(rng.integers(0, 256, 10_000, dtype=np.uint8)),  # raw escape
        bytes(rng.integers(0, 4, 200_000, dtype=np.uint8)),
        bytes(np.repeat(np.arange(5, dtype=np.uint8), 30_000)),
        b"\x00" * 70_000,  # one symbol: no emission
        bytes(rng.integers(0, 16, 1023, dtype=np.uint8)),
        bytes(rng.integers(0, 16, 1024, dtype=np.uint8)),
        bytes(rng.integers(0, 16, 63, dtype=np.uint8)),
    ]
    edge = np.random.default_rng(8)
    cases += [bytes(edge.integers(0, 5, n, dtype=np.uint8))
              for n in (63, 64, 1023, 1024, 8191, 8192, 65535, 65536)]
    return cases


def _fuzz(n_cases=10, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_cases):
        n = int(rng.integers(0, 40_000))
        alpha = int(rng.integers(1, 257))
        out.append(bytes(rng.integers(0, alpha, n, dtype=np.uint16).astype(np.uint8)))
    return out


def _skewed(n=20_000, seed=5):
    """Mostly one symbol, a few of frequency 1: two-byte renorms."""
    rng = np.random.default_rng(seed)
    a = np.zeros(n, dtype=np.uint8)
    a[rng.integers(0, n, 9)] = rng.integers(1, 256, 9)
    return a.tobytes()


@pytest.mark.parametrize("i", range(18))
def test_blob_equals_agc_tpu(i):
    d = _cases()[i]
    blob = D.compress_device(d, device="cpu")
    assert blob == TD.compress_device(d) == TE.compress(d)
    assert D.decompress_device(blob, device="cpu") == d
    assert D.decompress_device(blob, len(d), device="cpu") == d


def test_fuzz_equals_agc_tpu():
    payloads = _fuzz() + [_skewed()]
    got = D.encode_batch(payloads, device="cpu")
    assert got == TD.encode_batch(payloads)
    assert got == [TE.compress(p) for p in payloads]
    for p, blob in zip(payloads, got):
        assert D.decompress_device(blob, len(p), device="cpu") == p


def _raw_blob(n, body=b""):
    head = bytearray([E.MAGIC, E._RAW_FLAG])
    E._put_varint(head, n)
    return bytes(head) + body


@pytest.mark.parametrize("case", ["size mismatch", "over 64 GiB", "truncated raw"])
def test_decompress_raises_where_agc_tpu_raises(case):
    if case == "size mismatch":
        blob, size = E.compress(b"ACGT" * 100), 17
    elif case == "over 64 GiB":
        blob, size = _raw_blob(65 << 30, b"AC"), None
    else:
        blob, size = _raw_blob(100, b"AC"), None
    with pytest.raises(ValueError):
        TD.decompress_device(blob, size)
    with pytest.raises(ValueError):
        D.decompress_device(blob, size, device="cpu")


def test_decompress_rejects_a_table_off_scale():
    """A frequency table that does not sum to 4096 cannot fill the
    decoder's slot table: corruption, not a decode."""
    blob = bytearray(E.compress(b"ACGT" * 300))
    assert blob[4] == 0  # symbol 0's frequency varint, after a 2-byte n
    blob[4] = 1
    with pytest.raises(ValueError, match="corrupt"):
        D.decompress_device(bytes(blob), device="cpu")


def test_encode_batch_mixed_tiers_equals_agc_tpu():
    """One batch: every tier, empty parts, and more than 512 parts of one
    tier (agc_tpu's chunking boundary)."""
    rng = np.random.default_rng(21)
    payloads = [b""]
    payloads += [bytes(rng.integers(0, 4, int(n), dtype=np.uint8))
                 for n in rng.integers(100, 300, 530)]
    payloads += [b"", _skewed(), b"Q"]
    payloads += [bytes(rng.integers(0, 20, n, dtype=np.uint8))
                 for n in (40, 5000, 9000, 70_000, 256 * 70 + 13)]
    assert {E.lanes_for(len(p)) for p in payloads if p} == set(TIERS)
    got = D.encode_batch(payloads, device="cpu")
    assert got == TD.encode_batch(payloads)
    assert got[0] == got[531] == TE.compress(b"")


def _tpu_lane_streams(payload: bytes):
    """agc_tpu's lane streams of one part: _encode_batch_fn's emission
    slots through _pack_part_streams (agc_tpu's _encode_group, B = 1)."""
    arr = np.frombuffer(payload, dtype=np.uint8)
    n = len(arr)
    lanes = TE.lanes_for(n)
    steps = TD._bucket(-(-n // lanes))
    steps = 4 * -(-steps // 4)
    grid = np.zeros((1, steps * lanes), dtype=np.uint8)
    grid[0, :n] = arr
    freqs = TE.quantize_freqs(np.bincount(arr, minlength=256))[None, :].astype(np.uint32)
    cum = np.cumsum(freqs, axis=1, dtype=np.uint32) - freqs
    grid_rev = np.ascontiguousarray(grid.reshape(1, steps, lanes).transpose(1, 0, 2)[::-1])
    x, bts, packed_c = TD._encode_batch_fn(steps, 1, lanes)(
        grid_rev, np.array([n], dtype=np.int32), freqs, cum)
    packed_c = np.asarray(packed_c)
    cnts = np.empty((steps, 1, lanes), dtype=np.uint8)
    for k in range(4):
        cnts[k::4] = (packed_c >> (2 * k)) & 3
    flat, lane_lens = TD._pack_part_streams(np.asarray(bts)[:, 0], cnts[:, 0])
    return flat, lane_lens, np.asarray(x)[0]


def kernel_model(data, meta, enc, shift=3):
    """rans_encode and rans_write's streams as csrc/rans.cu computes them,
    lane by lane in Python integers. Each lane walks its steps from the
    last down, reads data[off + t * L + lane] and steps its state by the
    reciprocal form of enc (x + bias + q * (4096 - f), q the top 32 bits
    of x * rcp shifted right): a first run gives its byte count and final
    state. The second writes its bytes backwards from the top of its
    stream's place, here shift + the counts' prefix sum: the 8-byte words
    wholly inside that place whole (aligned, each new byte at the bottom of
    a little-endian word), the bytes of the words shared with neighbours
    one by one. Returns (the lanes' streams read back, counts, states)."""
    rows = meta.tolist()
    sym = data.numpy()
    m64 = (1 << 64) - 1

    def run(p, lane, sink=None):
        off, n, lanes, _lane0 = rows[p]
        rcp = (enc[p, :, 0].long() & 0xFFFFFFFF).tolist()
        word = enc[p, :, 1].long().tolist()
        steps = (n - lane + lanes - 1) // lanes if lane < n else 0
        x, cnt, buf = E.RANS_L, 0, 0
        for t in range(steps - 1, -1, -1):
            s = int(sym[off + t * lanes + lane])
            f = word[s] >> 17
            for _ in range(2):
                if x >= f << 19:
                    cnt += 1
                    if sink is not None:
                        out, lo, top = sink
                        at = top - cnt
                        if at >= top // 8 * 8 or at < (lo + 7) // 8 * 8:
                            out[at] = x & 0xFF
                        else:
                            buf = ((buf << 8) | (x & 0xFF)) & m64
                            if at % 8 == 0:
                                assert lo <= at and at + 8 <= top
                                out[at : at + 8] = buf.to_bytes(8, "little")
                    x >>= 8
            q = ((x * rcp[s]) >> 32) >> ((word[s] >> 13) & 15)
            x = (x + (word[s] & 0x1FFF) + q * (E.PROB_SCALE - f)) & 0xFFFFFFFF
        return cnt, x

    counts, states = [], []
    for p, (_off, _n, lanes, _lane0) in enumerate(rows):
        for lane in range(lanes):
            cnt, x = run(p, lane)
            counts.append(cnt)
            states.append(x)
    cs = np.concatenate([[0], np.cumsum(counts)]) + shift
    out = bytearray(int(cs[-1]) + 16)
    for p, (_off, _n, lanes, lane0) in enumerate(rows):
        for lane in range(lanes):
            run(p, lane, (out, int(cs[lane0 + lane]), int(cs[lane0 + lane + 1])))
    flat = torch.frombuffer(out[shift : int(cs[-1])] or bytearray(1), dtype=torch.uint8)
    return (flat[: int(cs[-1]) - shift], torch.tensor(counts, dtype=torch.int64),
            torch.tensor(states, dtype=torch.int64))


@pytest.mark.parametrize("tier", TIERS)
def test_kernel_layout_model_equals_pack_part_streams(tier):
    """A flush of parts of this tier beside parts of other tiers (so part
    and lane bases are not trivial), one with a partly inactive last row,
    written from an offset off the 8-byte grid: the kernel model's lane
    streams, lane lengths and states equal agc_tpu's, and rans_encode's
    plain version's."""
    rng = np.random.default_rng(tier)
    lo = {1: 1, 8: 64, 64: 1024, 256: 8192, 1024: 65536}[tier]
    lens = [lo + 3, 700, lo * 2 - 1 if tier > 1 else 63, 9000, lo + tier // 2 + 1]
    parts = [bytes(rng.integers(0, 6, n, dtype=np.uint8)) for n in lens]
    prep = D._prepare(parts)
    data, meta, chunks, sel, work = (torch.from_numpy(a) for a in
                                     (prep.data, prep.meta, prep.chunks, prep.sel, prep.work))
    _freqs, enc = D.rans_tables(data, meta, chunks)
    flat, counts, states = kernel_model(data, meta, enc, shift=tier % 8 + 1)
    p_counts, p_states = D.rans_encode(data, meta, enc, sel, work)
    assert torch.equal(flat, D._encode_plain(data, meta, enc)[0])
    assert torch.equal(counts.int(), p_counts) and torch.equal(states.int(), p_states)
    lane_out = np.cumsum(counts.numpy()) - counts.numpy()
    for (_off, n, lanes, lane0), part in zip(prep.meta.tolist(), parts):
        if lanes != tier:
            continue
        want, want_lens, want_x = _tpu_lane_streams(part)
        got_lens = counts.numpy()[lane0 : lane0 + lanes]
        assert (got_lens == want_lens).all()
        start = lane_out[lane0]
        assert flat.numpy()[start : start + got_lens.sum()].tobytes() == want.tobytes()
        assert (states.numpy()[lane0 : lane0 + lanes] == want_x).all()


@pytest.mark.parametrize("kind", [*TIERS, "raw"])
def test_assemble_equals_assemble_blob(kind):
    """The blob writer's plain version against entropy.assemble_blob on the
    host spec's lane streams, beside other parts of the flush."""
    rng = np.random.default_rng(31)
    if kind == "raw":
        parts = [bytes(rng.integers(0, 256, 5000, dtype=np.uint8))]
    else:
        lo = {1: 5, 8: 200, 64: 3000, 256: 20_000, 1024: 70_000}[kind]
        parts = [bytes(rng.integers(0, 4, lo, dtype=np.uint8)), _skewed(lo + 7)]
    parts.append(bytes(rng.integers(0, 3, 100, dtype=np.uint8)))
    prep = D._prepare(parts)
    data, meta, chunks, sel, work = (torch.from_numpy(a) for a in
                                     (prep.data, prep.meta, prep.chunks, prep.sel, prep.work))
    freqs, enc = D.rans_tables(data, meta, chunks)
    counts, states, want = [], [], []
    for part, f in zip(parts, freqs.numpy()):
        s, x = E._encode_lanes(np.frombuffer(part, dtype=np.uint8), f.astype(np.uint32))
        counts += [len(x) for x in s]
        states.append(x)
        want.append(E.assemble_blob(part, f, s, x))
    counts = torch.tensor(counts, dtype=torch.int32)
    states = torch.from_numpy(np.concatenate(states).astype(np.int64)).to(torch.int32)
    out, blob_off = D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    got = D._slice(out.numpy(), blob_off.tolist())
    assert got == want
    # the raw escape where rANS does not pay: always for random bytes,
    # never for 4 symbols once the tables' overhead is amortised
    if kind == "raw" or kind >= 64:
        assert (kind == "raw") == bool(got[0][1] & E._RAW_FLAG)


def test_varints_equal_put_varint():
    vals = np.array([0, 1, 127, 128, 300, 16383, 16384, 4096, 1 << 35, (1 << 63) - 1])
    got, nbytes = D.varints(torch.from_numpy(vals))
    want = bytearray()
    for v in vals.tolist():
        E._put_varint(want, v)
    assert got.numpy().tobytes() == bytes(want)
    assert nbytes.tolist() == [E._varint_len(v) for v in vals.tolist()]


@pytest.mark.parametrize("env,device", [(None, False), ("0", False), ("", False), ("1", True)])
def test_compress_parts_gate(monkeypatch, env, device):
    """agc_tpu's gate: only a value other than unset, "" or "0" routes a
    flush to the device coder, with the engine's device."""
    seen = []

    def fake(payloads, dev):
        seen.append(dev)
        return [b"device"] * len(payloads)

    if env is None:
        monkeypatch.delenv("AGC_TPU_RANS_DEVICE", raising=False)
    else:
        monkeypatch.setenv("AGC_TPU_RANS_DEVICE", env)
    monkeypatch.setattr(D, "encode_batch", fake)
    got = E.compress_parts([b"ACGT" * 50], "cpu")
    assert (got == [b"device"]) == device
    assert seen == (["cpu"] if device else [])
    if not device:
        assert got == [TE.compress(b"ACGT" * 50)]


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.encode_batch([b"ACGT"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.decompress_device(E.compress(b"ACGT" * 300))


@pytest.fixture
def rans_forced(monkeypatch):
    monkeypatch.setenv("AGC_TPU_RANS_DEVICE", "1")
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


def _fasta_body(path, contig):
    from test_torch_create import _fasta_body as body

    return body(path, contig)


@pytest.mark.parametrize("layout", ["multi", "single"])
def test_forced_create_matches_agc_tpu(tmp_path, rans_forced, layout):
    """AGC_TPU_RANS_DEVICE=1 with the tpu-rans profile: the port's create
    (plain versions on the CPU) equals agc_tpu's (its XLA coder on the CPU)
    part for part, and every sample extracts (test_profile.py:192-209)."""
    lens = (60000, 40000) if layout == "multi" else (90000,)
    files = make_collection(tmp_path, random.Random(17), n_samples=2, contig_lens=lens)
    paths = [p for _, p in files]
    params = CompressorParams(segment_size=4000, profile="tpu-rans")
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, paths, params, device="cpu")
    tpu_create(ref, paths, TpuParams(**vars(params)))
    assert_same_archive(ours, ref)
    d = Decompressor(ours)
    try:
        for sample, path in files:
            for i in range(len(lens)):
                assert d.get_contig_seq(sample, f"c{i + 1}") == _fasta_body(path, f"c{i + 1}")
    finally:
        d.close()


def test_forced_append_matches_host_and_agc_tpu(tmp_path, monkeypatch):
    """Append inherits the tpu-rans profile: the forced and the host coders
    give equal archives, every sample extracts, and the forced append
    equals agc_tpu's (test_profile.py:212-231)."""
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    rng = random.Random(23)
    files = make_collection(tmp_path, rng, n_samples=1, contig_lens=(50000, 20000))
    paths = [p for _, p in files]
    extra = str(tmp_path / "sb.fa")
    write_fa(extra, [(f"c{i + 1}", mutate(rng, _fasta_body(paths[0], f"c{i + 1}").decode(),
                                          subs=25)) for i in range(2)])
    params = CompressorParams(segment_size=3000, profile="tpu-rans")
    base = str(tmp_path / "base.agc")
    create_archive(base, paths, params, device="cpu")
    outs = {}
    for force in ("1", "0"):
        monkeypatch.setenv("AGC_TPU_RANS_DEVICE", force)
        outs[force] = str(tmp_path / f"app{force}.agc")
        append_archive(base, outs[force], [extra], CompressorParams(), device="cpu")
    assert_same_archive(outs["1"], outs["0"])
    monkeypatch.setenv("AGC_TPU_RANS_DEVICE", "1")
    tpu_base, tpu_out = str(tmp_path / "tbase.agc"), str(tmp_path / "tapp.agc")
    tpu_create(tpu_base, paths, TpuParams(**vars(params)))
    tpu_append(tpu_base, tpu_out, [extra], TpuParams())
    assert_same_archive(outs["1"], tpu_out)
    d = Decompressor(outs["1"])
    try:
        for sample, path in [*files, ("sb", extra)]:
            for c in ("c1", "c2"):
                assert d.get_contig_seq(sample, c) == _fasta_body(path, c)
    finally:
        d.close()


def test_device_coder_error_surfaces(tmp_path, rans_forced, monkeypatch):
    """An error of the device coder on the store worker is raised by the
    create, which leaves no archive behind."""
    def broken(*_a, **_k):
        raise RuntimeError("rans_encode failed")

    monkeypatch.setattr(D, "encode_batch", broken)
    files = make_collection(tmp_path, random.Random(3), n_samples=1, contig_lens=(30000,))
    out = tmp_path / "x.agc"
    with pytest.raises(RuntimeError, match="rans_encode failed"):
        create_archive(str(out), [p for _, p in files],
                       CompressorParams(segment_size=3000, profile="tpu-rans"), device="cpu")
    assert not out.exists()


def _quantize_both(counts: np.ndarray) -> np.ndarray:
    """quantize_plain of one row of counts, checked against both packages'
    quantize_freqs."""
    got = D.quantize_plain(torch.from_numpy(counts.astype(np.int64))[None])[0].numpy()
    assert (got == E.quantize_freqs(counts).astype(np.int64)).all()
    assert (got == TE.quantize_freqs(counts).astype(np.int64)).all()
    assert got.sum() == E.PROB_SCALE and ((got > 0) == (counts > 0)).all()
    return got


def _named_counts(case: str) -> np.ndarray:
    c = np.zeros(256, dtype=np.int64)
    if case == "one symbol":
        c[200] = 12345
    elif case == "every symbol once":
        c[:] = 1
    elif case == "dominant among 255 rare":  # diff < 0 over many passes
        c[:] = 1
        c[7] = 10**9
    elif case == "dominant among rare, rem ties":
        c[::2] = 3
        c[1] = 5 * 10**6
    elif case == "total below 4096":
        c[[0, 3, 9, 255]] = [1000, 7, 1, 33]
    elif case == "total above 4096":
        c[[0, 1, 2, 3, 4]] = [100_003, 99_999, 7, 4096, 1]
    return c


@pytest.mark.parametrize("case", ["one symbol", "every symbol once", "dominant among 255 rare",
                                  "dominant among rare, rem ties", "total below 4096",
                                  "total above 4096"])
def test_quantize_plain_equals_quantize_freqs(case):
    c = _named_counts(case)
    got = _quantize_both(c)
    if case == "dominant among 255 rare":
        assert (got[c == 1] == 1).all() and got[7] == E.PROB_SCALE - 255


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=256, max_size=256),
       st.sampled_from([1, 7, 10**4, 10**7]))
def test_quantize_plain_fuzz(counts, scale):
    c = np.asarray(counts, dtype=np.int64)
    c = np.where(c > 4000, c * scale, np.where(c > 3000, 0, c))
    if c.sum() == 0:
        c[0] = 1
    _quantize_both(c)


def test_quantize_plain_rows_at_once():
    """Rows of every kind in one call: the closed form is per row."""
    cases = ["one symbol", "every symbol once", "dominant among 255 rare",
             "dominant among rare, rem ties", "total below 4096", "total above 4096"]
    rows = np.stack([_named_counts(c) for c in cases])
    got = D.quantize_plain(torch.from_numpy(rows)).numpy()
    for row, c in zip(got, rows):
        assert (row == E.quantize_freqs(c).astype(np.int64)).all()


def test_reciprocal_step_is_exact():
    """The encoder's step x + bias + q * (4096 - f), q = (x * rcp) >> 32 >>
    shift, equals ((x // f) << 12) + x % f + start for every f of the
    12-bit scale and states from 1 (a state is never 0: the renorm leaves
    x >= f << 11) to x_max - 1 = (f << 19) - 1, the edges included."""
    f = np.arange(1, E.PROB_SCALE + 1, dtype=np.int64)
    start = (E.PROB_SCALE - f) // 2
    freqs = np.zeros((len(f), 256), dtype=np.int32)
    freqs[:, 0], freqs[:, 1], freqs[:, 2] = start, f, E.PROB_SCALE - f - start
    enc = D.enc_table_plain(torch.from_numpy(freqs))[:, 1].numpy().astype(np.int64)
    rcp, word = enc[:, 0] & 0xFFFFFFFF, enc[:, 1]
    assert ((word >> 17) == f).all()
    rng = np.random.default_rng(4)
    x_max = f << 19
    for x in [np.ones_like(f), f << 11, x_max - 1, x_max - f, x_max // 2 + 1,
              *[rng.integers(1, x_max) for _ in range(64)]]:
        q = ((x.astype(np.uint64) * rcp.astype(np.uint64)) >> np.uint64(32)).astype(np.int64)
        q >>= (word >> 13) & 15
        got = x + (word & 0x1FFF) + q * (E.PROB_SCALE - f)
        assert (got == ((x // f) << 12) + x % f + start).all()


def test_tables_plain_equals_quantize_freqs_on_a_flush():
    """rans_tables' plain version over a flush of every tier: each part's
    frequencies are quantize_freqs of its bincount, its enc table that of
    its frequencies."""
    parts = _cases()[1:] + _fuzz(6, seed=3) + [_skewed()]
    prep = D._prepare(parts)
    freqs, enc = D.rans_tables(*(torch.from_numpy(a) for a in (prep.data, prep.meta, prep.chunks)))
    for part, row in zip(parts, freqs.numpy()):
        want = E.quantize_freqs(np.bincount(np.frombuffer(part, dtype=np.uint8), minlength=256))
        assert (row == want.astype(np.int64)).all()
    assert torch.equal(enc, D.enc_table_plain(freqs))


def test_encode_batch_equals_compress_parts():
    """encode_batch(device="cpu") on a mixed-tier flush (every tier, raw
    escapes, empty parts, 1-lane parts past a work row of 256) equals
    agc_tpu's compress_parts, the host coder there."""
    rng = np.random.default_rng(41)
    payloads = [bytes(rng.integers(0, 4, int(n), dtype=np.uint8))
                for n in rng.integers(1, 64, 300)]
    payloads += [b"", bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), _skewed(9000)]
    payloads += [bytes(rng.integers(0, 9, n, dtype=np.uint8))
                 for n in (70, 1100, 20_000, 66_000, 100)]
    payloads += [bytes(rng.integers(0, 4, 200, dtype=np.uint8)) for _ in range(11)]
    assert {E.lanes_for(len(p)) for p in payloads if p} == set(TIERS)
    assert D.encode_batch(payloads, device="cpu") == TE.compress_parts(payloads)


def test_prepare_schedule_covers_every_part_once():
    """_prepare's chunks cover every byte of every part once, 64 KB a
    chunk; its work rows give every lane of every large part to one block
    (256 lanes a block), every 8- or 64-lane part to one warp, every 1-lane
    part to one thread."""
    rng = np.random.default_rng(12)
    lens = [1, 63, 64, 1023, 1024, 8191, 8192, 65535, 65536, 200_000, 131_073]
    lens += rng.integers(1, 64, 600).tolist() + rng.integers(64, 1024, 20).tolist()
    prep = D._prepare([bytes(n) for n in lens])
    meta = prep.meta
    assert len(prep.data) == sum(lens)
    assert (meta[:, 0] == np.cumsum(lens) - lens).all()
    assert (meta[:, 3] == np.cumsum(meta[:, 2]) - meta[:, 2]).all()
    covered = np.zeros(len(lens), dtype=np.int64)
    for p, start in prep.chunks.tolist():
        assert start % D._CHUNK == 0 and start < lens[p]
        covered[p] += min(D._CHUNK, lens[p] - start)
    assert covered.tolist() == lens
    lanes_done = np.zeros(len(lens), dtype=np.int64)
    for kind, first, arg in prep.work.tolist():
        if kind == D._BLOCK_PART:
            p = prep.sel[first]
            assert meta[p, 2] >= 256 and arg % 256 == 0 and arg < meta[p, 2]
            lanes_done[p] += 256
        else:
            per = D._WARP_PARTS if kind == D._WARP_PART else D._LANE_PARTS
            assert 1 <= arg <= per
            for p in prep.sel[first : first + arg]:
                assert (meta[p, 2] in (8, 64)) == (kind == D._WARP_PART)
                lanes_done[p] += meta[p, 2]
    assert (lanes_done == meta[:, 2]).all()
    assert sorted(prep.sel.tolist()) == list(range(len(lens)))


def test_blob_offsets_place_every_stream():
    """blob_offsets' layout, what rans_write's kernel writes by: each coded
    part's lane l writes its stream at stream_at + the prefix sum of the
    counts before it in its part; raw escapes have stream_at -1 and the
    raw size."""
    rng = np.random.default_rng(13)
    parts = [bytes(rng.integers(0, 4, n, dtype=np.uint8)) for n in (5, 300, 3000, 70_000)]
    parts.append(bytes(rng.integers(0, 256, 4000, dtype=np.uint8)))  # a raw escape
    prep = D._prepare(parts)
    data, meta, chunks, sel, work = (torch.from_numpy(a) for a in
                                     (prep.data, prep.meta, prep.chunks, prep.sel, prep.work))
    freqs, enc = D.rans_tables(data, meta, chunks)
    counts, states = D.rans_encode(data, meta, enc, sel, work)
    out, blob_off = D.rans_write(data, meta, chunks, sel, work, freqs, enc, counts, states)
    boff, stream_at, lane_cs = D.blob_offsets(meta, freqs, counts)
    assert torch.equal(boff, blob_off)
    flat = D._encode_plain(data, meta, enc)[0]
    for p, (_off, n, lanes, lane0) in enumerate(prep.meta.tolist()):
        if stream_at[p] < 0:
            assert blob_off[p + 1] - blob_off[p] == 2 + E._varint_len(n) + n
            assert out[blob_off[p] + 1] == E._RAW_FLAG
            continue
        for lane in range(lanes):
            a, b = int(lane_cs[lane0 + lane]), int(lane_cs[lane0 + lane + 1])
            at = int(stream_at[p]) + a - int(lane_cs[lane0])
            assert torch.equal(out[at : at + b - a], flat[a:b])
        assert int(stream_at[p]) + int(lane_cs[lane0 + lanes] - lane_cs[lane0]) == blob_off[p + 1]
    # short parts and random bytes are raw escapes; the longer 4-symbol parts code
    assert (stream_at < 0).tolist() == [True, True, False, False, True]
