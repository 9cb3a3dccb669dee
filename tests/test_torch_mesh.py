"""The port's mesh create and compression step
(agc_tpu_torch/parallel/sharding.py) on a mesh of 8 CPU devices against
the port's plain create and agc_tpu's mesh over its 8 virtual devices:
archives equal stream for stream and part for part, and the step's
outputs equal agc_tpu's make_compression_step on the same rows.
"""

import jax
import numpy as np
import pytest
import torch

import agc_tpu.ops  # noqa: F401  (x64)
from agc_tpu.parallel import sharding as js
from agc_tpu_torch.core.compressor import CompressorParams, create_archive
from agc_tpu_torch.ops import kmers as tk
from agc_tpu_torch.ops import u64
from agc_tpu_torch.parallel import sharding as ts

from test_torch_create import _tpu_params, assert_extracts, assert_same_archive
from util import make_collection

PARAMS = dict(kmer_length=17, segment_size=1000, pack_cardinality=2, min_match_len=15)
MESH = ["cpu"] * 8


@pytest.fixture(autouse=True)
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


@pytest.mark.parametrize("chunk_len", [8192, 2048])
def test_mesh_create_matches_plain_and_agc_tpu(tmp_path, chunk_len):
    """Several rows a device (2048) and padding rows (8192: 6 rows over 8
    devices); the (k-1) halo filter keeps every hit once."""
    files = make_collection(tmp_path, n_samples=3, contig_lens=(30000, 9000))
    paths = [p for _, p in files]
    params = CompressorParams(**PARAMS)
    meshed, plain, tpu = (str(tmp_path / f"{n}.agc") for n in ("mesh", "plain", "tpu"))
    ts.mesh_create_archive(meshed, paths, params, mesh=ts.make_mesh(MESH),
                           chunk_len=chunk_len, device="cpu")
    create_archive(plain, paths, params, device="cpu")
    js.mesh_create_archive(tpu, paths, _tpu_params(params), mesh=js.make_mesh(jax.devices()),
                           chunk_len=chunk_len)
    assert_same_archive(meshed, plain)
    assert_same_archive(meshed, tpu)
    assert_extracts(meshed, files, ["c1", "c2"])


@pytest.mark.parametrize("flag", ["adaptive_compression", "concatenated_genomes",
                                  "fallback_frac"])
def test_mesh_rejects_other_modes(tmp_path, flag):
    params = CompressorParams(**PARAMS, **{flag: 0.05 if flag == "fallback_frac" else True})
    with pytest.raises(NotImplementedError):
        ts.mesh_create_archive(str(tmp_path / "x.agc"), ["nope.fa"], params,
                               mesh=ts.make_mesh(MESH), device="cpu")


def _rows(k: int):
    """8 rows of 2048 symbols: random ACGT, N runs, a 255-padded tail, and
    the splitter table (every 50th distinct canonical code)."""
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 4, (8, 2048), dtype=np.uint8)
    rows[1, 100:140] = 4
    rows[5, 1500:1530] = 4
    rows[7, 1800:] = 255
    ud, ur, v = tk.dir_rc_kmers_np(rows.reshape(-1), k)
    table = np.unique(np.minimum(ud, ur)[v])[::50]
    return rows, table


@pytest.mark.parametrize("k", [17, 31])
def test_compression_step_matches_agc_tpu(k):
    rows, table = _rows(k)
    new = np.arange(8 * 3, dtype=np.uint64).reshape(8, 3) * np.uint64(0x9E3779B97F4A7C15)

    mesh = js.make_mesh(jax.devices())
    step, _cs, repl = js.make_compression_step(mesh, k)
    j_canon, j_member, j_gathered, j_cuts = step(
        js.shard_chunks(mesh, rows), jax.device_put(table, repl), js.shard_chunks(mesh, new))

    tmesh = ts.make_mesh(MESH)
    canon, member, gathered, cuts = ts.make_compression_step(tmesh, k)(
        ts.shard_chunks(tmesh, rows), ts.replicate_table(tmesh, table),
        [u64.from_u64(r) for r in new])
    valid = np.asarray(js._scan_batch(rows, table, k)[1])
    assert np.array_equal(torch.cat(member).numpy(), np.asarray(j_member))
    # canonical codes agree wherever the window is valid
    got = u64.to_u64(torch.cat(canon))
    assert np.array_equal(got[valid], np.asarray(j_canon)[valid])
    assert np.array_equal(u64.to_u64(gathered), np.asarray(j_gathered).reshape(-1))
    assert int(cuts) == int(j_cuts) > 0
