"""The port's device rANS coder (agc_tpu_torch/ops/device_rans.py) against
agc_tpu's (agc_tpu/ops/device_rans.py, JAX on the CPU) and the host coder,
with device='cpu': the kernels' plain versions. Blobs and archives are
bytes, so the tolerance is 0 everywhere.

Also held here: a torch model of the rans_encode kernel's ragged indexing
(part and lane bases, backwards writes into 2 * ceil(n / L)-byte regions,
compaction by a prefix sum) against agc_tpu's _pack_part_streams, and the
port's numpy blob assembly against entropy.assemble_blob.
"""

import random

import numpy as np
import pytest
import torch

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


def kernel_model(data, meta, freqs):
    """rans_encode as csrc/rans.cu indexes it, in torch: per part, each
    lane walks its steps from the last down, reads data[off + t * L +
    lane] and writes each emitted byte backwards from the end of its region
    (base + (lane + 1) * cap, cap = 2 * ceil(n / L)); then the compaction
    copies each lane's last counts[lane] region bytes to the prefix sum of
    the counts."""
    rows = meta.tolist()
    _off, n, lanes, lane0, base = rows[-1]
    region = torch.zeros(base + lanes * 2 * -(-n // lanes), dtype=torch.uint8)
    counts = torch.zeros(lane0 + lanes, dtype=torch.int64)
    states = torch.zeros(lane0 + lanes, dtype=torch.int64)
    for p, (off, n, lanes, lane0, base) in enumerate(rows):
        f_tab = freqs[p].long()
        c_tab = torch.cumsum(f_tab, 0) - f_tab
        cap = 2 * -(-n // lanes)
        lane = torch.arange(lanes)
        steps = torch.where(lane < n, (n - lane + lanes - 1) // lanes, 0)
        end = base + (lane + 1) * cap
        x = torch.full((lanes,), E.RANS_L, dtype=torch.int64)
        cnt = torch.zeros(lanes, dtype=torch.int64)
        for t in range(int(steps.max()) - 1, -1, -1):
            act = t < steps
            s = data[torch.where(act, off + t * lanes + lane, 0)].long()
            f = torch.where(act, f_tab[s], 1)
            x_max = ((E.RANS_L >> E.PROB_BITS) << 8) * f
            for _ in range(2):
                emit = act & (x >= x_max)
                region[(end - 1 - cnt)[emit]] = (x[emit] & 0xFF).to(torch.uint8)
                cnt = cnt + emit.long()
                x = torch.where(emit, x >> 8, x)
            x = torch.where(act, ((x // f) << E.PROB_BITS) + x % f + c_tab[s], x)
        counts[lane0 + lane] = cnt
        states[lane0 + lane] = x
    lane_out = torch.cumsum(counts, 0) - counts
    out = torch.zeros(int(counts.sum()), dtype=torch.uint8)
    for off, n, lanes, lane0, base in rows:
        cap = 2 * -(-n // lanes)
        for lane in range(lanes):
            c, dst = int(counts[lane0 + lane]), int(lane_out[lane0 + lane])
            src = base + (lane + 1) * cap - c
            out[dst : dst + c] = region[src : src + c]
    return out, counts, states


@pytest.mark.parametrize("tier", TIERS)
def test_kernel_layout_model_equals_pack_part_streams(tier):
    """A flush of parts of this tier beside parts of other tiers (so part,
    lane and region bases are not trivial), one with a partly inactive
    last row: the kernel model's lane streams, lane lengths and states
    equal agc_tpu's, and its outputs equal rans_encode_plain's."""
    rng = np.random.default_rng(tier)
    lo = {1: 1, 8: 64, 64: 1024, 256: 8192, 1024: 65536}[tier]
    lens = [lo + 3, 700, lo * 2 - 1 if tier > 1 else 63, 9000, lo + tier // 2 + 1]
    parts = [bytes(rng.integers(0, 6, n, dtype=np.uint8)) for n in lens]
    prep = D._prepare(parts)
    args = [torch.from_numpy(a) for a in (prep.data, prep.meta, prep.freqs)]
    flat, counts, states = kernel_model(*args)
    plain = D.rans_encode_plain(*args)
    assert torch.equal(flat, plain[0])
    assert torch.equal(counts.int(), plain[1]) and torch.equal(states.int(), plain[2])
    lane_out = np.cumsum(counts.numpy()) - counts.numpy()
    for (_off, n, lanes, lane0, _base), part in zip(prep.meta.tolist(), parts):
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
    """The port's vectorised blob assembly against entropy.assemble_blob on
    the host spec's lane streams."""
    rng = np.random.default_rng(31)
    if kind == "raw":
        parts = [bytes(rng.integers(0, 256, 5000, dtype=np.uint8))]
    else:
        lo = {1: 5, 8: 200, 64: 3000, 256: 20_000, 1024: 70_000}[kind]
        parts = [bytes(rng.integers(0, 4, lo, dtype=np.uint8)), _skewed(lo + 7)]
    prep = D._prepare(parts)
    streams, states, want = [], [], []
    for part, freqs in zip(parts, prep.freqs):
        s, x = E._encode_lanes(np.frombuffer(part, dtype=np.uint8), freqs.astype(np.uint32))
        streams += s
        states.append(x)
        want.append(E.assemble_blob(part, freqs, s, x))
    flat = np.frombuffer(b"".join(streams), dtype=np.uint8)
    counts = np.array([len(s) for s in streams], dtype=np.int32)
    got = D._assemble(prep, flat, counts, np.concatenate(states).astype(np.int32))
    assert got == want
    # the raw escape where rANS does not pay: always for random bytes,
    # never for 4 symbols once the tables' overhead is amortised
    if kind == "raw" or kind >= 64:
        assert (kind == "raw") == bool(got[0][1] & E._RAW_FLAG)


def test_varints_equal_put_varint():
    vals = np.array([0, 1, 127, 128, 300, 16383, 16384, 4096, 1 << 35, (1 << 63) - 1])
    got, nbytes = D.varints(vals)
    want = bytearray()
    for v in vals.tolist():
        E._put_varint(want, v)
    assert got.tobytes() == bytes(want)
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
