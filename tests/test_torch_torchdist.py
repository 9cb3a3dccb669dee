"""The port's torch.distributed create (agc_tpu_torch/parallel/torchdist.py)
on the CPU over gloo, against agc_tpu's jax.distributed create
(parallel/jaxdist.py) at the same process counts: archives equal stream
for stream and part for part, splitter sets equal to the single-host
discovery's; the padded collectives on payloads that hold EMPTY and an
empty rank; the owned-range reduction against agc_tpu's collective
program over 8 virtual devices; owner and chunk keys of bit-63 codes.
Every spawned process and every wait has a timeout.
"""

import os
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import agc_tpu.ops  # noqa: F401  (x64)
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu.parallel import jaxdist as jd
from agc_tpu_torch.core.compressor import CompressorParams, create_archive
from agc_tpu_torch.ops import u64
from agc_tpu_torch.parallel import torchdist as td

from test_torch_create import REPO, _splitters, _tpu_params, assert_same_archive
from util import mutate, random_seq, write_fa

TIMEOUT = 240  # seconds a distributed run may take here


@pytest.fixture(autouse=True)
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the collectives' inputs, the same in every rank and in the test
_DATA = '''
import numpy as np
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

def payload(pid):
    """rank 1 sends nothing; the others EMPTY among random words"""
    if pid == 1:
        return np.empty(0, np.uint64)
    rng = np.random.default_rng(10 + pid)
    p = rng.integers(0, 1 << 63, 5 + 4 * pid, dtype=np.int64).astype(np.uint64)
    p[::3] |= np.uint64(1 << 63)
    p[1] = EMPTY
    return p

def buckets(pid, n):
    """bucket j of rank pid: canonical-like codes (bit 63 set on some),
    values shared across ranks so that owners see duplicates"""
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 1 << 62, 30, dtype=np.int64).astype(np.uint64) << np.uint64(1)
    pool[::4] |= np.uint64(1 << 63)
    mine = np.random.default_rng(100 + pid)
    out = []
    for j in range(n):
        take = mine.integers(0, len(pool), 7 + j + pid)
        out.append(pool[take][pool[take] % np.uint64(n) == np.uint64(j)])
    return out
'''

_RANK = _DATA + '''
import datetime, sys, torch, torch.distributed as dist
from agc_tpu_torch.ops import u64
from agc_tpu_torch.parallel import torchdist as td
pid, n, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
timeout = datetime.timedelta(seconds=60)
store = dist.TCPStore("127.0.0.1", port, n, is_master=pid == 0, timeout=timeout)
dist.init_process_group("gloo", store=store, rank=pid, world_size=n, timeout=timeout)
g = td._Group(pid, n, "cpu", "cpu")
got = td._allgather_u64(g, torch.from_numpy(payload(pid).view(np.int64)))
counts = td._allgather_counts(g, 10 * pid + 1)
s, d = td._exchange_and_reduce_owned(g, [u64.from_u64(b) for b in buckets(pid, n)])
np.savez(out, gathered=got.numpy().view(np.uint64), counts=counts,
         singles=u64.to_u64(s), dups=u64.to_u64(d))
dist.destroy_process_group()
'''


def _reference_reduce(values: np.ndarray):
    uniq, cnt = np.unique(values, return_counts=True)
    return uniq[cnt == 1], uniq[cnt > 1]


def test_collectives_over_gloo(tmp_path):
    """Three ranks: the padded all_gather keeps EMPTY words and an empty
    rank (padding stripped by count), and each owner's reduced range
    equals the singletons / duplicated values of what it was sent."""
    n = 3
    port = _port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(pid), str(n), str(port),
                               str(tmp_path / f"r{pid}.npz")], env=env)
             for pid in range(n)]
    try:
        assert [p.wait(timeout=TIMEOUT) for p in procs] == [0] * n
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ns: dict = {}
    exec(_DATA, ns)
    want_gathered = np.concatenate([ns["payload"](pid) for pid in range(n)])
    assert (want_gathered == ns["EMPTY"]).sum() == 2
    for pid in range(n):
        r = np.load(tmp_path / f"r{pid}.npz")
        assert np.array_equal(r["gathered"], want_gathered)
        assert r["counts"].tolist() == [1, 11, 21]
        sent = np.concatenate([ns["buckets"](src, n)[pid] for src in range(n)])
        singles, dups = _reference_reduce(sent)
        assert len(singles) and len(dups)
        assert np.array_equal(r["singles"], singles)
        assert np.array_equal(r["dups"], dups)


def test_reduce_owned_matches_agc_tpu_mesh():
    """8 ranks' buckets through agc_tpu's exchange-and-reduce program on a
    mesh of 8 virtual devices; the port's _reduce_owned of what each rank
    receives (its column of the buckets) gives the same tables."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n = 8
    ns: dict = {}
    exec(_DATA, ns)
    blocks = [ns["buckets"](pid, n) for pid in range(n)]
    m = td._pow2(max(len(b) for bs in blocks for b in bs))
    glob = np.full((n * n, m), jd._SENTINEL, dtype=np.uint64)
    for src, bs in enumerate(blocks):
        for j, b in enumerate(bs):
            glob[src * n + j, : len(b)] = b
    mesh = Mesh(np.array(jax.devices()[:n]), ("host",))
    arr = jax.device_put(glob, NamedSharding(mesh, P("host", None)))
    s_g, single_g, dup_g = (np.asarray(x) for x in jd._exchange_reduce_fn(mesh, n, m)(arr))
    for pid in range(n):
        received = u64.from_u64(glob.reshape(n, n, m)[:, pid])
        singles, dups = td._reduce_owned(received)
        assert np.array_equal(u64.to_u64(singles), s_g[pid][single_g[pid]]), pid
        assert np.array_equal(u64.to_u64(dups), s_g[pid][dup_g[pid]]), pid


@pytest.mark.parametrize("k", [17, 31, 32])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_owner_and_chunk_keys_of_bit63_codes(k, n):
    rng = np.random.default_rng(k * n)
    raw = rng.integers(0, 1 << 63, 4000, dtype=np.int64).astype(np.uint64)
    raw[::2] |= np.uint64(1 << 63)
    raw[:3] = [0, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(1 << 63)]
    codes = (raw >> np.uint64(64 - 2 * k)) << np.uint64(64 - 2 * k)  # left-aligned
    t = u64.from_u64(codes)
    want = (codes >> np.uint64(64 - 2 * k)) % np.uint64(n)
    assert np.array_equal(td.owner_of(t, k, n).numpy(), want.astype(np.int64))
    for n_chunks in (2, 8, 1 << 16):
        shift = np.uint64(64 - int(np.log2(n_chunks)))
        assert np.array_equal(td.chunk_of(t, n_chunks).numpy(),
                              (codes >> shift).astype(np.int64))


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    """agc_tpu's jaxdist collection: a 3-contig reference (so discovery
    really is contig-sharded) and 5 mutated samples."""
    tmp = tmp_path_factory.mktemp("torchdist")
    rng = random.Random(4242)
    base = {"c1": random_seq(rng, 60_000), "c2": random_seq(rng, 40_000),
            "c3": random_seq(rng, 25_000)}
    files = [str(tmp / "ref.fa")]
    write_fa(files[0], list(base.items()))
    for i in range(5):
        p = str(tmp / f"s{i}.fa")
        write_fa(p, [(c, mutate(rng, seq, subs=len(seq) // 1000)) for c, seq in base.items()])
        files.append(p)
    return files


def _torchdist(out, files, params, n):
    td.create_archive_torchdist(str(out), files, params, n_procs=n, device="cpu",
                                timeout_s=TIMEOUT)


def _jaxdist(out, files, params, n):
    jd.create_archive_jaxdist(str(out), files, _tpu_params(params), n_procs=n)


@pytest.mark.parametrize("n_procs", [2, 3])
def test_torchdist_matches_jaxdist(collection, tmp_path, n_procs):
    """The collective discovery reproduces the single-host splitter set
    (jaxdist's _distributed_splitters gives the same), and the archive
    equals jaxdist's at the same process count."""
    params = CompressorParams(segment_size=5000)
    ours, theirs, plain = (tmp_path / f"{n}.agc" for n in ("td", "jd", "plain"))
    _torchdist(ours, collection, params, n_procs)
    _jaxdist(theirs, collection, params, n_procs)
    tpu_create(str(plain), collection, _tpu_params(params))
    assert _splitters(str(ours)) == _splitters(str(theirs)) == _splitters(str(plain))
    assert_same_archive(str(ours), str(theirs))


def test_torchdist_chunked_exchange_identical(collection, tmp_path, monkeypatch):
    """A tiny exchange budget forces the pool merge into many value-range
    chunk rounds; the archive equals the unchunked run's."""
    params = CompressorParams(segment_size=5000)
    whole, chunked = tmp_path / "whole.agc", tmp_path / "chunked.agc"
    _torchdist(whole, collection, params, 2)
    monkeypatch.setenv("AGC_TPU_DIST_EXCHANGE_BUDGET", str(64 << 10))
    _torchdist(chunked, collection, params, 2)
    assert_same_archive(str(whole), str(chunked))


def _adaptive_fixture(tmp_path):
    """Reference + two samples with novel contigs; s1's is a mutated copy
    of s0's, so s0's promoted splitters segment it only if they crossed
    shards (agc_tpu's tests/test_jaxdist.py fixture)."""
    rng = random.Random(77)
    base = random_seq(rng, 24000)
    novel = random_seq(rng, 8000)
    ref = str(tmp_path / "aref.fa")
    write_fa(ref, [("c1", base)])
    s0 = str(tmp_path / "as0.fa")
    write_fa(s0, [("c1", mutate(rng, base, 30, 3)), ("nv", novel)])
    s1 = str(tmp_path / "as1.fa")
    write_fa(s1, [("c1", mutate(rng, base, 25, 2)), ("nv", mutate(rng, novel, subs=8))])
    params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=10,
                              min_match_len=15, adaptive_compression=True)
    return [ref, s0, s1], params


def test_torchdist_adaptive_exchange_crosses_shards(tmp_path):
    """-a at 2 processes: the per-barrier all_gather carries s0's promoted
    splitters to the other shard; the archive equals jaxdist's and the
    splitter set the single-host one."""
    files, params = _adaptive_fixture(tmp_path)
    ours, theirs, plain = (tmp_path / f"{n}.agc" for n in ("td", "jd", "plain"))
    _torchdist(ours, files, params, 2)
    _jaxdist(theirs, files, params, 2)
    create_archive(str(plain), files, params, device="cpu")
    assert_same_archive(str(ours), str(theirs))
    assert _splitters(str(ours)) == _splitters(str(plain))


@pytest.mark.parametrize("mode", ["-a", "-f"])
def test_torchdist_one_process_matches_plain_create(tmp_path, mode):
    """One process follows the plain create's schedule: with -a (the
    candidate tables from the exchange) and with -f (the fallback records
    of the contig-sharded walk) the archive equals the port's plain
    create."""
    if mode == "-a":
        files, params = _adaptive_fixture(tmp_path)
    else:
        rng = random.Random(5)
        base = random_seq(rng, 30000)
        files = [str(tmp_path / "r.fa"), str(tmp_path / "s0.fa")]
        write_fa(files[0], [("c1", base)])
        write_fa(files[1], [("c1", mutate(rng, base[5000:25000], 50, 5))])
        params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=10,
                                  min_match_len=15, fallback_frac=0.05)
    ours, plain = tmp_path / "td1.agc", tmp_path / "plain.agc"
    _torchdist(ours, files, params, 1)
    create_archive(str(plain), files, params, device="cpu")
    assert_same_archive(str(ours), str(plain))


def test_run_worker_rejects_concatenated_mode(tmp_path):
    with pytest.raises(NotImplementedError):
        td.run_worker(0, 1, "127.0.0.1:1", str(tmp_path / "x.agc"), ["nope.fa"],
                      CompressorParams(concatenated_genomes=True), device="cpu")


def test_backend_choice():
    """gloo on the CPU and wherever ranks share a card; NCCL only with a
    card a rank."""
    assert td.choose_backend(2, "cpu") == "gloo"
    n_cards = torch.cuda.device_count()
    assert td.choose_backend(n_cards + 1, "cuda") == "gloo"


def test_failed_worker_stops_the_run(tmp_path):
    """A worker that cannot read its input fails the launcher at once,
    and the other workers are stopped (no wait for the collective's
    timeout)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="workers failed"):
        td.create_archive_torchdist(str(tmp_path / "x.agc"), [str(tmp_path / "nope.fa")],
                                    CompressorParams(), n_procs=2, device="cpu",
                                    timeout_s=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
