"""Multi-device compression step: data-parallel contig scanning over a
list of devices (counterpart of ``agc_tpu/parallel/sharding.py``).

A mesh here is a list of ``torch.device``s, one process driving them all:

- contig chunks (rows) are split into one contiguous block a device;
- the splitter table is replicated: each device holds its own
  ``set_table`` of it (it is small: ~1 entry per segment_size bases);
- each device's scan is one ``kmer_dir_rc`` launch over its rows with
  that table (canonical codes, validity and membership a position);
- the new-splitter all-gather and the cut-count sum of agc_tpu's SPMD
  step are a concatenation and a sum on the first device.

``mesh_create_archive`` drives a whole create on the mesh's scans: the
scan outputs stay on their devices, and only the hits (positions and
both orientations' codes) are downloaded.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import resolve_device, u64
from ..ops.cuda_kmers import kmer_dir_rc, set_table
from ..ops.kmers import pack4_np


def make_mesh(devices=None) -> list:
    """The mesh's devices: ``devices`` (e.g. ``["cpu"] * 8``), or every
    CUDA device of this process."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def replicate_table(mesh: list, table) -> list:
    """The sorted splitter table (np.uint64, or a flipped int64 tensor) as
    one ``set_table`` a device."""
    if isinstance(table, np.ndarray):
        table = u64.from_u64(table)
    return [set_table(table.to(dev)) for dev in mesh]


def shard_chunks(mesh: list, chunks: np.ndarray) -> list:
    """A [B, N] batch of numeric symbols (255-padded, N even, B a multiple
    of the mesh size) as one nibble-packed row block a device."""
    b, n = chunks.shape
    packed = pack4_np(np.ascontiguousarray(chunks).reshape(-1)).reshape(b, n // 2)
    per = b // len(mesh)
    return [torch.from_numpy(packed[i * per:(i + 1) * per]).to(dev)
            for i, dev in enumerate(mesh)]


def _scan_batch(packed: torch.Tensor, index, k: int):
    """Per-position scan of one device's rows: (canon, valid, member),
    canonical codes in the flipped int64 convention (agc_tpu's
    ``_scan_batch``)."""
    udir, urc, valid, member = kmer_dir_rc(packed, k, index)
    return torch.minimum(udir, urc), valid, member


def _scan_batch_full(packed: torch.Tensor, index, k: int):
    """Like :func:`_scan_batch` but returns (member, udir, urc): the matcher
    needs both orientations of each splitter hit (agc_tpu's
    ``_scan_batch_full``)."""
    udir, urc, _valid, member = kmer_dir_rc(packed, k, index)
    return member, udir, urc


def make_compression_step(mesh: list, k: int):
    """The multi-device compression step: ``step(shards, tables,
    local_new_splitters)`` scans each device's row block against its
    table and returns the per-device (canon, member) lists, every
    device's new splitters gathered (concatenated on the first device)
    and the cut count summed there (agc_tpu's ``all_gather`` and
    ``psum``)."""
    root = mesh[0]

    def step(shards, tables, local_new_splitters):
        canon, member = [], []
        for packed, index in zip(shards, tables):
            c, _valid, m = _scan_batch(packed, index, k)
            canon.append(c)
            member.append(m)
        gathered = torch.cat([x.to(root) for x in local_new_splitters])
        n_cuts = sum(m.sum().to(root) for m in member)
        return canon, member, gathered, n_cuts

    return step


def make_compression_step_full(mesh: list, k: int):
    """Mesh step returning the per-device (member, udir, urc): the scan
    outputs the matcher consumes (see :func:`_scan_batch_full`)."""

    def step(shards, tables):
        return [_scan_batch_full(packed, index, k) for packed, index in zip(shards, tables)]

    return step


def _row_hits(member, udir, urc, lo, st, end):
    """The kept hits of one device's row block, on that device: positions
    in contig coordinates and both orientations' codes. A k-mer END
    position is kept inside [st, end) of its row: halo windows belong to
    the previous chunk."""
    rows, j = member.nonzero(as_tuple=True)
    keep = (j + lo[rows] >= st[rows]) & (j < end[rows] - lo[rows])
    rows, j = rows[keep], j[keep]
    return j + lo[rows], udir[rows, j], urc[rows, j]


def mesh_create_archive(
    out_path: str,
    input_files: list[str],
    params=None,
    mesh: list | None = None,
    chunk_len: int = 1 << 14,
    device="cuda",
) -> None:
    """Full create with every contig membership scan run over the mesh
    (contig chunks split across its devices, splitter table replicated):
    splitter discovery, all four matcher cases incl. missing-middle
    splits, barrier stores, metadata batches and footer drive on the
    mesh's scan results. The engine runs on ``device``; ``mesh`` defaults
    to every CUDA device for ``"cuda"`` and to the CPU for ``"cpu"``.
    Archives equal the single-device ``create_archive``'s on the same
    inputs: the mesh changes WHERE the scans run, never their outcome.
    """
    from ..core.compressor import Compressor, CompressorParams
    from ..core.genome_io import (
        preprocess_raw_contig,
        read_contigs_raw,
        sample_name_from_path,
    )

    params = params or CompressorParams()
    if params.adaptive_compression or params.concatenated_genomes or (
        params.fallback_frac
    ):
        raise NotImplementedError(
            "mesh_create_archive covers the default mode; adaptive/-c/-f "
            "use the distributed path (parallel/torchdist.py)"
        )
    if mesh is None:
        dev = resolve_device(device)
        mesh = make_mesh() if dev.type == "cuda" else [dev]
    n_dev = len(mesh)
    k = params.kmer_length
    if chunk_len % 2:
        raise ValueError("chunk_len must be even (rows are nibble-packed)")

    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    comp = Compressor(out_path, params, reference_file=files[0], device=device)
    try:
        comp._ensure_splitters()
        tables = replicate_table(mesh, comp.splitters) if len(comp.splitters) else None
        step = make_compression_step_full(mesh, k)

        def mesh_hits(codes: np.ndarray):
            """Membership scan of one contig over the mesh: chunk with a
            (k-1) halo, split rows across devices, scan, translate the
            member positions back to contig coordinates on each device and
            download only the hits."""
            n = len(codes)
            if tables is None or n < k:
                e = np.empty(0, dtype=np.int64)
                return e, e.astype(np.uint64), e.astype(np.uint64)
            plans = []  # (lo, end, start)
            start = 0
            while start < n:
                lo = max(0, start - (k - 1))
                end = min(lo + chunk_len, n)
                plans.append((lo, end, start))
                start = end
            rows_n = -(-len(plans) // n_dev) * n_dev
            mat = np.full((rows_n, chunk_len), 255, dtype=np.uint8)
            for r, (lo, end, _st) in enumerate(plans):
                mat[r, : end - lo] = codes[lo:end]
            bounds = np.zeros((3, rows_n), dtype=np.int64)
            bounds[:, : len(plans)] = np.asarray(plans, dtype=np.int64).T
            per = rows_n // n_dev
            pos_l, ud_l, ur_l = [], [], []
            for i, (member, udir, urc) in enumerate(step(shard_chunks(mesh, mat), tables)):
                lo, end, st = torch.from_numpy(
                    bounds[:, i * per:(i + 1) * per]).to(member.device)
                pos, ud, ur = _row_hits(member, udir, urc, lo, st, end)
                pos_l.append(pos.cpu().numpy())
                ud_l.append(u64.to_u64(ud))
                ur_l.append(u64.to_u64(ur))
            return np.concatenate(pos_l), np.concatenate(ud_l), np.concatenate(ur_l)

        for sname, path in sample_files:
            comp.collection.reset_prev_sample_name()
            for cid, raw in read_contigs_raw(path):
                if not comp.collection.register_sample_contig(sname, cid):
                    print(
                        f"Error: Pair sample_name:contig_name {sname}:{cid}"
                        " is already in the archive!",
                        file=sys.stderr,
                    )
                    continue
                codes = preprocess_raw_contig(raw, cid)
                comp._process_contig(sname, cid, codes, hits=mesh_hits(codes))
            comp._synchronize()
    except BaseException:
        comp.abort()
        raise
    comp.close()
