"""The anchor LZ mode of agc_tpu_torch against agc_tpu's, on the CPU.

The anchor diagonal sets of the port's match layer (ops/match.py:
anchor_join, anchor_select, anchor_diag_sets, plain torch ops here) against
agc_tpu's _anchor_join_kernel / _anchor_select_kernel / anchor_diag_sets
and against the native host twin (lz_anchor_diags); anchor-mode creates
and appends equal to agc_tpu's part for part; and the port's device tables
on and off (AGC_TPU_DEVICE_LZ) giving the same archive.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agc_tpu.ops import match as JM
from agc_tpu_torch.core.compressor import CompressorParams, append_archive, create_archive
from agc_tpu_torch.core.lz import LZDiff
from agc_tpu_torch.ops import match as M

from test_torch_create import (
    _fasta_body,
    _tpu_params,
    assert_extracts,
    assert_same_archive,
    tpu_append,
    tpu_create,
)
from util import make_collection, mutate, random_seq, write_fa

jax.config.update("jax_enable_x64", True)


def _mutate(rng, seq, rate):
    out = seq.copy()
    pos = rng.integers(0, len(seq), size=max(1, int(len(seq) * rate)))
    out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
    return out


def _pairs(seed, n_pairs=10, lo=60, hi=50000):
    """(texts, gids, refs): mutated copies of random references with N
    and IUPAC symbols, indels, one reference too short for the rule."""
    rng = np.random.default_rng(seed)
    refs, texts, gids = {}, [], []
    for trial in range(n_pairs):
        m = 12 if trial == 5 else int(rng.integers(lo, hi))
        ref = rng.integers(0, 5, size=m, dtype=np.uint8)
        refs[trial] = ref
        t = _mutate(rng, ref, 0.005)
        if trial % 3 == 1:  # an indel
            t = np.concatenate([t[: m // 2], t[m // 2 + 33 :]])
        if trial == 7:
            t[:40] = rng.integers(5, 16, 40)
        texts.append(t.tobytes())
        gids.append(trial)
    return texts, gids, refs


@pytest.mark.parametrize("seed", [1, 2])
def test_anchor_diag_sets_match_agc_tpu_and_host_twin(seed):
    texts, gids, refs = _pairs(seed)
    provider = lambda g: refs[g].tobytes()  # noqa: E731
    got = M.anchor_diag_sets(texts, gids, M.AnchorCodeBank("cpu"), provider, 17)
    want = JM.anchor_diag_sets(texts, gids, JM.AnchorCodeBank(), provider, 17)
    checked = 0
    for txt, gid, tab, wtab in zip(texts, gids, got, want):
        assert (tab is None) == (wtab is None), gid
        lz = LZDiff(20)
        lz.prepare(refs[gid].tobytes())
        host = lz.anchor_diags_host(txt)
        assert (tab is None) == (host is None), gid
        if tab is None:
            continue
        np.testing.assert_array_equal(tab, wtab)
        np.testing.assert_array_equal(tab, host)
        assert lz.encode_anchor(txt, tables=tab) == lz.encode_anchor(txt)
        checked += 1
    assert checked >= 8
    assert got[5] is None  # the reference below key_len + 4 symbols


def test_anchor_sets_do_not_depend_on_chunking(monkeypatch):
    """The rows of one bucket go in dispatches bounded by a count of sorted
    elements; any split gives the same sets."""
    texts, gids, refs = _pairs(3, n_pairs=6, lo=3000, hi=4000)
    provider = lambda g: refs[g].tobytes()  # noqa: E731
    whole = M.anchor_diag_sets(texts, gids, M.AnchorCodeBank("cpu"), provider, 17)
    monkeypatch.setattr(M, "_ANCHOR_CHUNK_ELEMS", 1)
    one_by_one = M.anchor_diag_sets(texts, gids, M.AnchorCodeBank("cpu"), provider, 17)
    for a, b in zip(whole, one_by_one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key_len", [12, 17, 32])
def test_anchor_join_and_select_match_agc_tpu(key_len):
    """The join's unordered diagonals, as a multiset per row, and the
    selected top-32 sets; key_len 32 reaches keys with bit 63 set."""
    rng = np.random.default_rng(key_len)
    tb, rb = 4096, 16384
    texts = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in (4096, 3000, 100)]
    refs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in (16384, 9000)]
    texts[0][:2000] = refs[0][5000:7000]  # shared keys at one diagonal
    texts[1][100:3000] = refs[1][:2900]
    texts[0][3000:3100] = 3  # poly-T: all-ones keys
    refs[0][:200] = 3

    def packed(rows, b):
        mat = np.full((len(rows), b), 255, dtype=np.uint8)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        return JM.pack4_np(mat.reshape(-1)).reshape(len(rows), b // 2)

    tp, rp = packed(texts, tb), packed(refs, rb)
    rowidx = np.array([0, 1, 0], dtype=np.int32)
    got = M.anchor_join(torch.from_numpy(tp), torch.from_numpy(rp),
                        torch.from_numpy(rowidx), key_len)
    want = np.asarray(JM._anchor_join_kernel(jnp.asarray(tp), jnp.asarray(rp),
                                             jnp.asarray(rowidx), key_len))
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=1), np.sort(want, axis=1))
    assert (got.numpy() != JM._I32_MISS).sum() > 1000
    sel = M.anchor_select(got)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(JM._anchor_select_kernel(
        jnp.asarray(want))))


def _anchor_collection(tmp_path, seed=3):
    rng = random.Random(seed)
    base = random_seq(rng, 200_000)
    files = [str(tmp_path / "ref.fa")]
    write_fa(files[0], [("chr1", base), ("chr2", random_seq(rng, 7000))])
    for i in range(3):
        s = mutate(rng, base, 150, 12)
        if i == 1:
            s = s[:5000] + "N" * 300 + s[5300:]
        p = str(tmp_path / f"s{i}.fa")
        write_fa(p, [("chr1", s), ("chr2", mutate(rng, base[:7000], 20, 2))])
        files.append(p)
    return files


@pytest.mark.parametrize("device_lz", [None, "1"])
def test_anchor_create_matches_agc_tpu(tmp_path, monkeypatch, device_lz):
    """Anchor mode, the tables from the host twin (auto on the CPU) and
    from the match layer's plain versions (AGC_TPU_DEVICE_LZ=1) on both
    sides: archives equal part for part."""
    if device_lz:
        monkeypatch.setenv("AGC_TPU_DEVICE_LZ", device_lz)
    files = _anchor_collection(tmp_path)
    params = CompressorParams(segment_size=8000, lz_mode="anchor")
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    timers = create_archive(ours, files, params, device="cpu")
    tpu_create(ref, files, _tpu_params(params))
    assert_same_archive(ours, ref)
    assert (timers.times["device_lz_tables"] > 0) == bool(device_lz)
    assert_extracts(ours, [(f"s{i}", files[i + 1]) for i in range(3)], ["chr1", "chr2"])


def test_anchor_mode_from_the_environment(tmp_path, monkeypatch):
    """AGC_TPU_LZ_MODE=anchor selects the rule as lz_mode does."""
    files = _anchor_collection(tmp_path, seed=4)[:2]
    a, b = str(tmp_path / "env.agc"), str(tmp_path / "param.agc")
    create_archive(b, files, CompressorParams(segment_size=8000, lz_mode="anchor"), device="cpu")
    monkeypatch.setenv("AGC_TPU_LZ_MODE", "anchor")
    create_archive(a, files, CompressorParams(segment_size=8000), device="cpu")
    assert_same_archive(a, b)


def test_anchor_append_matches_agc_tpu(tmp_path, monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_LZ", "1")
    rng = random.Random(11)
    files = make_collection(tmp_path, rng, n_samples=1, contig_lens=(50000, 12000))
    base = [p for _, p in files]
    seq = _fasta_body(files[0][1], "c1").decode()
    extra = str(tmp_path / "extra.fa")
    write_fa(extra, [("c1", mutate(rng, seq, 150, 10)), ("c3", random_seq(rng, 3000))])
    params = CompressorParams(segment_size=3000, lz_mode="anchor")
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    create_archive(ours, base, params, device="cpu")
    tpu_create(ref, base, _tpu_params(params))
    ours2, ref2 = str(tmp_path / "port2.agc"), str(tmp_path / "tpu2.agc")
    append_archive(ours, ours2, [extra], params, device="cpu")
    tpu_append(ref, ref2, [extra], _tpu_params(params))
    assert_same_archive(ours2, ref2)
    assert_extracts(ours2, [("extra", extra)], ["c1", "c3"])


def test_device_tables_on_off_same_archive(tmp_path, monkeypatch):
    """Where the anchor tables are computed never changes a byte."""
    files = _anchor_collection(tmp_path, seed=5)
    params = CompressorParams(segment_size=8000, lz_mode="anchor")
    on, off = str(tmp_path / "on.agc"), str(tmp_path / "off.agc")
    monkeypatch.setenv("AGC_TPU_DEVICE_LZ", "1")
    t_on = create_archive(on, files, params, device="cpu")
    monkeypatch.setenv("AGC_TPU_DEVICE_LZ", "0")
    t_off = create_archive(off, files, params, device="cpu")
    assert t_on.times["device_lz_tables"] > 0 and "device_lz_tables" not in t_off.times
    assert_same_archive(on, off)
    assert_extracts(on, [(f"s{i}", files[i + 1]) for i in range(3)], ["chr1", "chr2"])
