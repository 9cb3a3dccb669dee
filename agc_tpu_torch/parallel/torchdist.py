"""Multi-process (multi-host) ``create`` over ``torch.distributed``
(counterpart of ``agc_tpu/parallel/jaxdist.py``).

Every host runs one process of this worker, joined into one process
group; the dense exchanges are collectives of that group:

1. **K-mer pool merge, range-partitioned**: each process collects the
   canonical k-mers of its slice of the reference contigs on its device
   (``collect_kmers``, one ``kmer_canon`` launch a contig), buckets them
   by owner (``(kmer >> (64-2k)) % n``, the low bits of the meaningful
   field: codes are left-aligned) and exchanges the buckets with one
   ``all_to_all_single``; the received range is sorted and reduced to
   its singletons and duplicated values on the worker's device
   (``_exchange_and_reduce_owned``). Pools over the exchange budget
   (``AGC_TPU_DIST_EXCHANGE_BUDGET`` bytes) go in value-range chunks.
2. **Singleton table replication**: one padded ``all_gather``.
3. **Greedy splitter emission, contig-sharded**: each process scans its
   contigs against the singleton table (``kmer_dir_rc`` with its
   ``set_table``), walks them with ``greedy_splitter_walk`` and the
   emitted splitters are unioned with a second padded ``all_gather``.
4. **Data-parallel compression**: samples round-robin across processes
   (``_CapturingCompressor``); adaptive mode (-a) unions the pending new
   splitters at every sample barrier with one padded ``all_gather``.
5. **Merge on process 0**: the shard results (pickled) reach it through
   the process group (``gather``), and it replays them with
   ``_merge_shards``; the rendezvous store carries only the merge-done
   flag.

Backends: NCCL needs a CUDA card a rank; several ranks sharing one card
use gloo, on host tensors, while the sort and the masks of step 1 still
run on each worker's device (``create_archive_torchdist`` chooses and
prints the backend).

Codes in the exchanges follow the port's convention (``ops/u64.py``):
flipped int64, so ``torch.sort`` gives the unsigned order and the padding
``SENTINEL`` (all-ones u64: rc(all-ones) == 0, so it is never a canonical
code) sorts last. Padding is always stripped by COUNT, never by value:
-f's fallback records carry the all-ones ``EMPTY`` as a real value.
"""

from __future__ import annotations

import argparse
import base64
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import resolve_device, u64

_TIMEOUT_S = 1800  # a collective or the rendezvous waits no longer


# ---------------------------------------------------------------------------
# padded collective helpers
# ---------------------------------------------------------------------------


class _Group:
    """This process's place in the process group: its rank, the world
    size, the device its work runs on and the device its collectives'
    tensors live on (the host for gloo, the card for NCCL)."""

    def __init__(self, pid: int, n: int, device, comm_device):
        self.pid, self.n = pid, n
        self.device = torch.device(device)
        self.comm = torch.device(comm_device)


def _allgather_counts(g: _Group, value: int) -> np.ndarray:
    """Every process learns every process's ``value``."""
    out = [torch.empty(1, dtype=torch.int64, device=g.comm) for _ in range(g.n)]
    dist.all_gather(out, torch.tensor([value], dtype=torch.int64, device=g.comm))
    return torch.cat(out).cpu().numpy()


def _allgather_u64(g: _Group, values: torch.Tensor) -> torch.Tensor:
    """Union-style gather of ragged int64 arrays (any bit patterns): pad
    to the global max, all_gather, strip each row's padding by its count.
    Returns the concatenation of all rows on this process's device."""
    counts = _allgather_counts(g, values.numel())
    m = max(1, int(counts.max()))
    row = torch.full((m,), u64.SENTINEL, dtype=torch.int64, device=g.comm)
    row[: values.numel()] = values.to(g.comm)
    out = [torch.empty(m, dtype=torch.int64, device=g.comm) for _ in range(g.n)]
    dist.all_gather(out, row)
    return torch.cat([r[: int(c)] for r, c in zip(out, counts)]).to(g.device)


def _reduce_owned(received: torch.Tensor):
    """Sort a received k-mer range (flipped int64, SENTINEL padding) and
    reduce it to (singletons, first of each duplicated value), both
    sorted, on the tensor's device (agc_tpu's ``_exchange_reduce_fn``
    after its all_to_all)."""
    s = torch.sort(received.reshape(-1)).values  # sentinels sort to the tail
    if not s.numel():
        return s, s
    ne = s[1:] != s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    diff_prev = torch.cat([one, ne])
    diff_next = torch.cat([ne, one])
    valid = s != u64.SENTINEL
    return s[diff_prev & diff_next & valid], s[diff_prev & ~diff_next & valid]


def _pow2(v: int) -> int:
    return max(1, 1 << int(v - 1).bit_length())


def _exchange_and_reduce_owned(g: _Group, buckets: list, m: int | None = None):
    """Range-partitioned k-mer pool merge: send bucket j (flipped int64)
    to process j (``all_to_all_single``), then sort the received range
    and reduce it on this process's device. Returns (global singletons,
    duplicated values) of the k-mer range this process owns, sorted.
    Rows are padded to the all-process maximum bucket size (pow2); pass
    ``m`` when the caller already knows that width."""
    if m is None:
        counts = _allgather_counts(g, max((b.numel() for b in buckets), default=0))
        m = _pow2(int(counts.max()))
    block = torch.full((g.n, m), u64.SENTINEL, dtype=torch.int64, device=g.comm)
    for j, b in enumerate(buckets):
        block[j, : b.numel()] = b.to(g.comm)
    received = torch.empty_like(block)
    dist.all_to_all_single(received, block)
    return _reduce_owned(received.to(g.device))


def owner_of(kmers: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The owning process of each flipped int64 code: the unsigned
    ``(kmer >> (64 - 2k)) % n``."""
    v = u64.flip(kmers)  # the raw u64 bit pattern
    s = 64 - 2 * k
    if s:
        return u64.lsr(v, s) % n  # < 2^(2k) <= 2^62: non-negative
    # k = 32: the unsigned remainder of a full 64-bit word
    return ((u64.lsr(v, 1) % n) * 2 + (v & 1)) % n


def chunk_of(kmers: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The value-range chunk of each flipped int64 code: its unsigned top
    log2(n_chunks) bits (n_chunks a power of two, >= 2)."""
    return u64.lsr(u64.flip(kmers), 64 - (n_chunks.bit_length() - 1))


# ---------------------------------------------------------------------------
# distributed splitter discovery
# ---------------------------------------------------------------------------


def _contig_hits(codes: np.ndarray, k: int, index, device):
    """Positions of ``codes``' k-mers in the set of ``index`` and their
    canonical codes (np.uint64), found on ``device``; only the hits are
    downloaded."""
    from ..ops.cuda_kmers import kmer_dir_rc
    from ..ops.kmers import _packed_row

    n = len(codes)
    udir, urc, _valid, member = kmer_dir_rc(_packed_row(codes, device), k, index)
    hits = member[0, :n].nonzero().reshape(-1)
    canon = torch.minimum(udir[0, hits], urc[0, hits])
    return hits.cpu().numpy(), u64.to_u64(canon)


def _distributed_splitters(g: _Group, reference_file: str, params) -> tuple:
    """Phases 1-3 of the module docstring. Returns the (identical on every
    process) splitter k-mer set, -f fallback records [(prev, cur, kmer,
    is_dir), ...] (empty without -f), and the adaptive-mode candidate
    tables (reference singletons / duplicated k-mers, sorted flipped
    int64 on the device; empty without -a)."""
    from ..core.compressor import _FallbackFilter, greedy_splitter_walk
    from ..core.genome_io import preprocess_raw_contig, read_contigs_raw
    from ..ops.cuda_kmers import set_table
    from ..ops.kmers import collect_kmers, scan_contig

    k = params.kmer_length
    pid, n = g.pid, g.n
    contigs = [
        preprocess_raw_contig(raw) for _, raw in read_contigs_raw(reference_file)
    ]
    my_contigs = list(range(pid, len(contigs), n))
    fb_filter = _FallbackFilter(params.fallback_frac)

    # 1. local k-mer occurrences -> range-partitioned exchange
    parts = [collect_kmers(contigs[ci], k, g.device) for ci in my_contigs]
    local = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64, device=g.device)
    del parts
    owner = owner_of(local, k, n)
    buckets = [local[owner == j] for j in range(n)]
    del local, owner
    # Pools past the exchange budget run in value-range chunks: every
    # bucket is sub-partitioned by the k-mers' top bits, one collective
    # round per chunk; chunks are value-disjoint AND value-ordered, so
    # per-chunk singleton/duplicate verdicts are globally correct and
    # their concatenation is already sorted.
    budget = int(os.environ.get("AGC_TPU_DIST_EXCHANGE_BUDGET", str(256 << 20)))
    global_max = int(_allgather_counts(g, max((b.numel() for b in buckets), default=0)).max())
    # budget accounting uses the PADDED row width; under value skew a
    # chunk's true max can exceed global_max/n_chunks, so the budget is a
    # target, not a hard bound (each chunk's count gather pads its round
    # to its real max)
    n_chunks = 1
    while n * _pow2((global_max + n_chunks - 1) // n_chunks) * 8 > budget and n_chunks < 1 << 16:
        n_chunks *= 2
    if n_chunks == 1:
        singles, dup_uniques = _exchange_and_reduce_owned(g, buckets, m=_pow2(global_max))
    else:
        keys = [chunk_of(b, n_chunks) for b in buckets]
        s_parts, d_parts = [], []
        for c in range(n_chunks):
            s, d = _exchange_and_reduce_owned(g, [b[key == c] for b, key in zip(buckets, keys)])
            s_parts.append(s)
            d_parts.append(d)
        singles, dup_uniques = torch.cat(s_parts), torch.cat(d_parts)
    del buckets

    # 2. replicate the singleton table (adaptive mode also the
    # duplicated-unique table: find_new_splitters excludes both from
    # promotion, agc_compressor.cpp:2054-2082)
    table = torch.sort(_allgather_u64(g, singles)).values
    empty = torch.empty(0, dtype=torch.int64, device=g.device)
    cand_singletons = cand_duplicated = empty
    if params.adaptive_compression:
        cand_duplicated = torch.sort(_allgather_u64(g, dup_uniques)).values
        cand_singletons = table

    # 3. greedy emission over my contig slice (the shared reference walk,
    # agc_compressor.cpp:762-825), union across processes; with -f the
    # walk also yields this slice's fallback records
    index = set_table(table)
    found: list[int] = []
    records: list[tuple] = []
    for ci in my_contigs:
        codes = contigs[ci]
        if len(codes) < k:
            continue
        if fb_filter:
            canon, udir, urc, valid, member = scan_contig(codes, k, index, g.device)
            hits = np.flatnonzero(member)
            hit_canon = canon[hits]
            fb_ctx = (valid, canon, udir, urc, fb_filter)
        else:
            hits, hit_canon = _contig_hits(codes, k, index, g.device)
            fb_ctx = None
        spl, fbs = greedy_splitter_walk(
            len(codes), k, params.segment_size, hits, hit_canon, fb_ctx
        )
        found.extend(spl)
        records.extend(fbs)
    del index

    merged = _allgather_u64(g, u64.from_u64(np.array(sorted(set(found)), dtype=np.uint64)))
    splitter_set = set(int(x) for x in u64.to_u64(merged))

    fallback_records = []
    if fb_filter:
        # union the fallback records (order is irrelevant: the voting
        # matcher counts pairs into sets); rows of 4 raw u64 words ride
        # the same padded all_gather
        flat = np.array(
            sorted({(p, c, km, int(d)) for p, c, km, d in records}), dtype=np.uint64
        ).reshape(-1)
        rows = _allgather_u64(g, torch.from_numpy(flat.view(np.int64)))
        rows = rows.cpu().numpy().view(np.uint64).reshape(-1, 4)
        fallback_records = sorted(
            {(int(r[0]), int(r[1]), int(r[2]), bool(r[3])) for r in rows}
        )
    return splitter_set, fallback_records, cand_singletons, cand_duplicated


class _CollectiveSplitterExchange:
    """Per-barrier union of pending new splitters across all processes
    (the reference's new_splitters token, agc_compressor.cpp:1187-1237,
    as one padded all_gather per sample barrier). Every process must
    perform the same TOTAL number of exchanges; processes that finish
    their sample shard early drain the remaining rounds with empty
    contributions (run_worker)."""

    def __init__(self, g: _Group):
        self.g = g
        self.rounds_done = 0

    def exchange(self, pending) -> list[int]:
        vals = np.array(sorted({int(x) for x in pending}), dtype=np.uint64)
        merged = _allgather_u64(self.g, torch.from_numpy(vals.view(np.int64)))
        self.rounds_done += 1
        return [int(x) for x in merged.cpu().numpy().view(np.uint64)]


def _gather_results(g: _Group, res) -> list | None:
    """Every process's shard result, pickled, to process 0 through the
    process group: rows padded to the largest, stripped by count."""
    blob = np.frombuffer(pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL), dtype=np.uint8)
    counts = _allgather_counts(g, len(blob))
    row = torch.zeros(int(counts.max()), dtype=torch.uint8, device=g.comm)
    row[: len(blob)] = torch.from_numpy(blob.copy())
    rows = [torch.empty_like(row) for _ in range(g.n)] if g.pid == 0 else None
    dist.gather(row, rows, dst=0)
    if g.pid != 0:
        return None
    return [pickle.loads(r[: int(c)].cpu().numpy().tobytes()) for r, c in zip(rows, counts)]


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


def run_worker(
    pid: int,
    n_procs: int,
    coordinator: str,
    out_path: str,
    input_files: list[str],
    params=None,
    device="cuda",
    backend: str = "gloo",
    timeout_s: float = _TIMEOUT_S,
) -> None:
    """One host's role in a distributed create. Call once per process;
    process 0 writes the archive. ``coordinator`` is process 0's
    host:port (its rendezvous store); ``device`` the device this
    process's work runs on; ``backend`` "gloo" (host tensors) or "nccl"
    (a CUDA card a rank)."""
    from ..core.compressor import CompressorParams

    params = params or CompressorParams()
    if params.concatenated_genomes:
        raise NotImplementedError(
            "distributed create does not support concatenated mode (-c): "
            "its grouping is defined by a single global contig stream"
        )
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device a rank")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), n_procs, is_master=pid == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=pid, world_size=n_procs,
                            timeout=timeout,
                            device_id=device if backend == "nccl" else None)
    g = _Group(pid, n_procs, device, device if backend == "nccl" else "cpu")
    try:
        _run(g, store, out_path, input_files, params)
    finally:
        dist.destroy_process_group()


def _run(g: _Group, store, out_path: str, input_files: list[str], params) -> None:
    from ..core.genome_io import sample_name_from_path
    from .distributed import _CapturingCompressor, _merge_shards

    seen: set = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    splitter_set, fallback_records, cand_singletons, cand_duplicated = (
        _distributed_splitters(g, files[0], params)
    )

    # phase 4: compress my sample shard. Adaptive mode synchronizes the
    # growing splitter table across processes: one exchange per sample
    # barrier, every process performing exactly max_rounds exchanges
    # (shard 0 holds the most samples under round-robin; shorter shards,
    # or shards that skipped a barrier for an unopenable/empty input,
    # drain the difference with empty contributions so the collectives
    # stay lockstep).
    my_files = [sf for i, sf in enumerate(sample_files) if i % g.n == g.pid]
    exchanger = (
        _CollectiveSplitterExchange(g)
        if params.adaptive_compression and g.n > 1
        else None
    )
    comp = _CapturingCompressor(
        params, splitter_set, g.pid, fallback_records,
        cand_singletons=cand_singletons, cand_duplicated=cand_duplicated,
        exchanger=exchanger, device=g.device,
    )
    comp.add_sample_files(my_files)
    if exchanger is not None:
        max_rounds = len(sample_files[0::g.n])
        while exchanger.rounds_done < max_rounds:
            comp._pending_new_splitters = exchanger.exchange(comp._pending_new_splitters)
            comp._merge_new_splitters()
    results = _gather_results(g, comp.result())
    del comp

    # phase 5: process 0 merges; the store carries the merge-done flag,
    # and a barrier keeps process 0 (the store's host) alive until every
    # process has read it
    if g.pid == 0:
        try:
            _merge_shards(out_path, params, sample_files, splitter_set, results,
                          device=g.device)
        except BaseException:
            # never leave a footerless partial archive at the user's path
            import contextlib

            with contextlib.suppress(OSError):
                os.unlink(out_path)
            store.set("agc_merge_done", "failed")
            raise
        store.set("agc_merge_done", "ok")
    elif store.get("agc_merge_done") != b"ok":
        raise RuntimeError("process 0's merge failed")
    dist.barrier()


def _parse_params(blob: str):
    from ..core.compressor import CompressorParams

    if not blob:
        return CompressorParams()
    return pickle.loads(base64.b64decode(blob))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="agc-tpu-torch-distributed-worker",
        description="one host's worker process of a distributed create",
    )
    ap.add_argument("--coordinator", required=True, help="host:port of process 0's store")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--procid", type=int, required=True)
    ap.add_argument("--out", required=True, help="output archive (written by process 0)")
    ap.add_argument("--params", default="", help="base64 pickled CompressorParams")
    ap.add_argument("--device", default="cuda", help="this process's device")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=_TIMEOUT_S,
                    help="seconds a collective or the rendezvous may wait")
    ap.add_argument("inputs", nargs="+", help="FASTA inputs (first is the reference)")
    a = ap.parse_args(argv)
    run_worker(a.procid, a.nprocs, a.coordinator, a.out, a.inputs,
               _parse_params(a.params), device=a.device, backend=a.backend,
               timeout_s=a.timeout)
    return 0


def choose_backend(n_procs: int, device="cuda") -> str:
    """NCCL where every rank has a CUDA card of its own, gloo otherwise
    (several ranks sharing a card, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_procs <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def create_archive_torchdist(
    out_path: str,
    input_files: list[str],
    params=None,
    n_procs: int = 2,
    coordinator: str | None = None,
    device="cuda",
    timeout_s: float = _TIMEOUT_S,
) -> None:
    """Local launcher: spawn ``n_procs`` worker processes on this machine
    (the single-machine shape of a multi-host run; each worker is exactly
    what one host would execute). With ``device="cuda"`` rank r works on
    card r modulo the card count; the backend is ``choose_backend``'s. A
    worker that fails stops the others; the whole run waits at most
    ``timeout_s`` seconds."""
    import socket

    if coordinator is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    dev = resolve_device(device)
    backend = choose_backend(n_procs, dev)
    print(f"torchdist: {n_procs} processes, backend {backend}, device {dev.type}",
          file=sys.stderr)
    blob = base64.b64encode(
        pickle.dumps(params, protocol=pickle.HIGHEST_PROTOCOL)
    ).decode() if params is not None else ""

    # the workers import this package from where this process found it
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for pid in range(n_procs):
        rank_dev = (f"cuda:{pid % torch.cuda.device_count()}"
                    if dev.type == "cuda" else "cpu")
        cmd = [
            sys.executable, "-m", "agc_tpu_torch.parallel.torchdist",
            "--coordinator", coordinator,
            "--nprocs", str(n_procs),
            "--procid", str(pid),
            "--out", out_path,
            "--device", rank_dev,
            "--backend", backend,
            "--timeout", str(timeout_s),
        ]
        if blob:
            cmd += ["--params", blob]
        cmd += list(input_files)
        procs.append(subprocess.Popen(cmd, env=env))
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            rc = [p.poll() for p in procs]
            if any(r not in (None, 0) for r in rc):
                raise RuntimeError(f"distributed workers failed: exit codes {rc}")
            if all(r == 0 for r in rc):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"distributed workers did not finish in {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


if __name__ == "__main__":
    sys.exit(main())
