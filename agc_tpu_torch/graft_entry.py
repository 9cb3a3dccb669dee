"""The port's graft entry points: the flagship step and a multi-device dry
run (counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``).

- ``entry(device)`` returns ``(fn, example_args)``: the batched rolling
  k-mer and splitter-membership scan that drives compression, one
  ``kmer_dir_rc`` launch over the nibble-packed rows with the splitter
  table's ``set_table`` (``parallel/sharding.py::_scan_batch``).
- ``dryrun_multichip(n_devices, device)`` runs one compression step over a
  mesh of ``n_devices``, the owned-range k-mer exchange and reduction
  through a process group of ``n_devices`` ranks, and a whole create
  with every membership scan on the mesh, each checked against the
  port's single-device or plain result.

Both draw their inputs from ``np.random.default_rng(0)`` in the order
``__graft_entry__.py`` does, so they see the same numbers.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .ops import resolve_device, u64
from .ops.cuda_kmers import set_table
from .ops.kmers import pack4_np
from .parallel import sharding as sh
from .parallel import torchdist as td

K = 31


def entry(device="cuda"):
    """Return ``(fn, example_args)``: ``fn(chunks, table)`` scans uint8
    [B, N] symbol rows (255-padded, N even) against a sorted np.uint64
    splitter table on ``device`` and returns (canon, valid, member), the
    canonical codes in the flipped int64 convention (``ops/u64.py``);
    ``example_args`` are 4 rows of 16,384 symbols and 256 sorted
    splitters."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    chunks = rng.integers(0, 4, size=(4, 1 << 14), dtype=np.uint8)
    table = np.sort(rng.integers(0, 1 << 62, size=(256,), dtype=np.uint64))

    def fn(chunks: np.ndarray, table: np.ndarray):
        return _scan(chunks, table, dev)

    return fn, (chunks, table)


def _scan(chunks: np.ndarray, table: np.ndarray, dev: torch.device):
    b, n = chunks.shape
    packed = pack4_np(np.ascontiguousarray(chunks).reshape(-1)).reshape(b, n // 2)
    index = set_table(u64.from_u64(table, dev))
    return sh._scan_batch(torch.from_numpy(packed).to(dev), index, K)


def _mesh(n_devices: int, dev: torch.device) -> list:
    if dev.type == "cpu":
        return sh.make_mesh(["cpu"] * n_devices)
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    return sh.make_mesh([f"cuda:{i}" for i in range(n_devices)])


def exchange_rank(pid: int, n: int, coordinator: str, device: str, backend: str,
                  blocks_path: str, out_path: str, m: int, timeout_s: float) -> None:
    """One rank of the dry run's exchange: send row ``pid * n + j`` of the
    blocks (np.uint64) to rank j in rows padded to ``m``, reduce what it
    receives, and save (singletons, duplicated values)."""
    blocks = np.load(blocks_path)
    with td.process_group(pid, n, coordinator, device, backend, timeout_s) as (g, _store):
        buckets = [u64.from_u64(blocks[pid * n + j], g.device) for j in range(n)]
        singles, dups = td._exchange_and_reduce_owned(g, buckets, m=m)
    np.savez(out_path, singles=u64.to_u64(singles), dups=u64.to_u64(dups))


_RANK = ("import json, sys\n"
         "from agc_tpu_torch.graft_entry import exchange_rank\n"
         "exchange_rank(**json.loads(sys.argv[1]))\n")


def _exchange(n: int, dev: torch.device, blocks: np.ndarray, m: int, tmp: str,
              timeout_s: float = 600) -> None:
    """The owned-range exchange and reduction in a process group of n
    ranks: in this process for n == 1, else n spawned ranks (gloo on the
    CPU, NCCL with a card a rank); each rank's range against numpy."""
    backend = td.choose_backend(n, dev)
    blocks_path = os.path.join(tmp, "blocks.npy")
    np.save(blocks_path, blocks)
    coordinator = td.local_coordinator()
    args = [dict(pid=pid, n=n, coordinator=coordinator,
                 device=f"cuda:{pid}" if dev.type == "cuda" else "cpu", backend=backend,
                 blocks_path=blocks_path, out_path=os.path.join(tmp, f"rank{pid}.npz"), m=m,
                 timeout_s=timeout_s) for pid in range(n)]
    if n == 1:
        exchange_rank(**args[0])
    else:
        td.run_processes([[sys.executable, "-c", _RANK, json.dumps(a)] for a in args],
                         timeout_s)
    for j, a in enumerate(args):
        got = np.load(a["out_path"])
        sent = blocks[j::n].reshape(-1)  # row i * n + j of every rank i
        uniq, count = np.unique(sent, return_counts=True)
        if not (np.array_equal(got["singles"], uniq[count == 1])
                and np.array_equal(got["dups"], uniq[count > 1])):
            raise AssertionError(f"rank {j}'s reduced range differs from its inputs'")


def _write_fasta(path: str, seq: np.ndarray) -> None:
    body = np.frombuffer(b"ACGT", dtype=np.uint8)[seq].tobytes()
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        for i in range(0, len(body), 70):
            f.write(body[i: i + 70] + b"\n")


def _same_archive(a: str, b: str) -> bool:
    """Stream for stream, part for part (physical part order depends on
    when the async store ran)."""
    from .core import ArchiveReader

    ra, rb = ArchiveReader(a), ArchiveReader(b)
    try:
        names = set(ra.stream_names())
        return names == set(rb.stream_names()) and all(
            ra.n_parts(nm) == rb.n_parts(nm)
            and all(ra.get_part(nm, i) == rb.get_part(nm, i) for i in range(ra.n_parts(nm)))
            for nm in names)
    finally:
        ra.close()
        rb.close()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Build a mesh of ``n_devices`` (``["cpu"] * n`` on the CPU, the first
    n cards on ``"cuda"``: fewer raises) and check on tiny shapes, raising
    on any difference:

    1. one compression step (``make_compression_step``): 2n rows of 4,096
       symbols, 128 splitters, 4 new splitters a row; the scan against
       the single-device scan of all rows, the gathered splitters and the
       cut count;
    2. the owned-range exchange and reduction (m = 16, sentinel padding)
       in a process group of n ranks, each rank's range against numpy;
    3. ``mesh_create_archive`` of a reference and two samples (one with an
       indel), k = 17, segment 1000: equal part for part to the plain
       ``create_archive``, sample s1 extracted byte-equal.
    """
    from .core import Decompressor
    from .core.compressor import CompressorParams, create_archive

    dev = resolve_device(device)
    mesh = _mesh(n_devices, dev)
    rng = np.random.default_rng(0)

    # 1. the compression step
    b = 2 * n_devices
    chunks = rng.integers(0, 4, size=(b, 4096), dtype=np.uint8)
    table = np.sort(rng.integers(0, 1 << 62, size=(128,), dtype=np.uint64))
    local_new = rng.integers(0, 1 << 62, size=(b, 4), dtype=np.uint64)
    step = sh.make_compression_step(mesh, K)
    new = [u64.from_u64(local_new[2 * i: 2 * i + 2], d) for i, d in enumerate(mesh)]
    canon, member, gathered, n_cuts = step(sh.shard_chunks(mesh, chunks),
                                           sh.replicate_table(mesh, table), new)
    canon = torch.cat([c.to(mesh[0]) for c in canon])
    member = torch.cat([m.to(mesh[0]) for m in member])
    want_canon, _valid, want_member = _scan(chunks, table, mesh[0])
    if canon.shape != (b, 4096) or gathered.shape != (b, 4):
        raise AssertionError(f"step shapes {tuple(canon.shape)}, {tuple(gathered.shape)}")
    if not (torch.equal(canon, want_canon) and torch.equal(member, want_member)
            and np.array_equal(u64.to_u64(gathered), local_new)
            and int(n_cuts) == int(member.sum())):
        raise AssertionError("the mesh step differs from the single-device scan")

    # 2. the owned-range exchange: each rank's block of n owner-bucketed
    # rows of m // 2 k-mers, sentinel-padded to m
    m = 16
    blocks = rng.integers(0, 1 << 62, size=(n_devices * n_devices, m // 2), dtype=np.uint64)
    tmp = tempfile.mkdtemp(prefix="agc_torch_dryrun_")
    try:
        _exchange(n_devices, dev, blocks, m, tmp)

        # 3. a whole create with every membership scan on the mesh
        ref = rng.integers(0, 4, size=24000, dtype=np.uint8)
        files = [os.path.join(tmp, "ref.fa")]
        _write_fasta(files[0], ref)
        for i in range(2):
            mut = ref.copy()
            pos = rng.integers(0, len(mut), size=30)
            mut[pos] = (mut[pos] + 1) % 4
            if i == 1:
                mut = np.concatenate([mut[:11000], mut[11033:]])  # indel
            files.append(os.path.join(tmp, f"s{i}.fa"))
            _write_fasta(files[-1], mut)
        params = CompressorParams(kmer_length=17, segment_size=1000, pack_cardinality=2,
                                  min_match_len=15)
        plain, meshed = os.path.join(tmp, "plain.agc"), os.path.join(tmp, "mesh.agc")
        create_archive(plain, files, params, device=dev)
        sh.mesh_create_archive(meshed, files, params, mesh=mesh, chunk_len=4096, device=dev)
        if not _same_archive(plain, meshed):
            raise AssertionError("the mesh archive differs from the plain create's")
        d = Decompressor(meshed)
        try:
            got = d.get_contig_seq("s1", "chr1")
        finally:
            d.close()
        with open(files[2], "rb") as f:
            want = f.read().split(b"\n", 1)[1].replace(b"\n", b"")
        if got != want:
            raise AssertionError("the mesh archive's s1 does not extract byte-equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
