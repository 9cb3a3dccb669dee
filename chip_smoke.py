#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (agc_tpu_torch) runs on a GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):

1. environment: torch, the card, its power limit (nvidia-smi);
2. build of the CUDA kernels from agc_tpu_torch/csrc (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, outputs compared exactly (integer
   outputs: tolerance 0), both timed with CUDA events;
4. the main path: a chr-scale create (one 64 Mbase reference contig with
   repeat families + 2 resequenced samples, default parameters) through
   agc_tpu_torch.core.compressor.create_archive(device="cuda"), with the
   kernel launch counts of that run, two more timed creates, one create
   under torch.profiler for the device busy share of that same run,
   splitters checked against the port's plain versions run on the CPU,
   and every sample extracted byte-equal through agc_tpu_torch.AGCFile;
5. the port's CLI on the card: `create --device cuda`, then `getctg`;
6. card against CPU on a collection of 3 files x 24 contigs (20 kbases to
   2 Mbases each): archives equal stream for stream and part for part for
   default parameters, for -c (concatenated genomes) and for segment size
   1000 (over 8192 splitters: the large-table join scan).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
REF_MB = 64
N_SCAN = 4 << 20  # symbols per scan row (ops/kmers.py CHUNK)
N_SAMPLES = 2
SEED = 20260816
ALPHA = b"ACGT"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype, "shape/dtype mismatch")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def scan_rows(np, n_rows: int, n: int, seed: int):
    """Main-path scan rows: random bases, a poly-A row, an N-run row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, size=(n_rows, n), dtype=np.uint8)
    rows[1] = rows[0]
    rows[1, ::997] = (rows[1, ::997] + 1) % 4  # a close copy: shared hits
    rows[2, 100_000:400_000] = 0  # poly-A run
    rows[3, :] = 0  # all poly-A
    for s in range(0, n, 65536):  # N runs
        rows[4, s : s + 200] = 4
    rows[5, rng.integers(0, n, n // 50)] = 4  # scattered invalid symbols
    return rows


def structured_ref(np, rng, n: int):
    """Reference with repeat families: ~45% of the draws copy one of 48
    repeat units (0.5-8 kb) at ~1% divergence, the rest is unique
    backbone (the generator of bench.py, so the shape of
    tools/bench_chr.py)."""
    lib = [rng.integers(0, 4, size=int(rng.integers(500, 8000)), dtype=np.uint8)
           for _ in range(48)]
    pieces, total = [], 0
    while total < n:
        if rng.random() < 0.45:
            copy = lib[int(rng.integers(len(lib)))].copy()
            n_sub = max(1, len(copy) // 100)
            pos = rng.integers(0, len(copy), size=n_sub)
            copy[pos] = (copy[pos] + rng.integers(1, 4, size=n_sub)) % 4
            pieces.append(copy)
            total += len(copy)
        else:
            m = int(rng.integers(2000, 20000))
            pieces.append(rng.integers(0, 4, size=m, dtype=np.uint8))
            total += m
    return np.concatenate(pieces)[:n]


def mutate(np, rng, seq):
    """A resequenced sample: ~0.1% SNPs and up to 8 short indels."""
    out = seq.copy()
    n_sub = max(1, len(seq) // 1000)
    pos = rng.integers(0, len(seq), size=n_sub)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    pieces, cur = [], 0
    for _ in range(8):
        cut = int(rng.integers(cur + 1, cur + len(seq) // 8))
        if cut >= len(out) - 1:
            break
        pieces.append(out[cur:cut])
        if rng.random() < 0.5:
            cut += int(rng.integers(1, 50))  # deletion
        else:
            pieces.append(out[cut : cut + int(rng.integers(1, 50))])  # duplication
        cur = min(cut, len(out))
    pieces.append(out[cur:])
    return np.concatenate(pieces)


def write_fasta(np, path: str, contigs) -> None:
    """Write [(name, codes)] as FASTA with 80-base lines."""
    alpha = np.frombuffer(ALPHA, dtype=np.uint8)
    with open(path, "wb") as f:
        for name, seq in contigs:
            text = alpha[seq].tobytes()
            f.write(b">" + name.encode() + b"\n")
            f.write(b"\n".join(text[i : i + 80] for i in range(0, len(text), 80)) + b"\n")


def same_archive(reader_cls, a: str, b: str) -> bool:
    """Archives equal stream for stream and part for part (physical part
    order depends on the async store, so raw bytes are not compared)."""
    ra, rb = reader_cls(a), reader_cls(b)
    try:
        if sorted(ra.stream_names()) != sorted(rb.stream_names()):
            return False
        for name in ra.stream_names():
            if ra.n_parts(name) != rb.n_parts(name):
                return False
            for i in range(ra.n_parts(name)):
                if ra.get_part(name, i) != rb.get_part(name, i):
                    return False
        return True
    finally:
        ra.close()
        rb.close()


def device_time(torch, prof):
    """(busy ms, {activity: ms}) of the card in a torch.profiler run: busy
    is the union of the device spans (kernels, copies, memsets), the
    dict sums each activity's spans by name."""
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name == "Activity Buffer Request"):  # the profiler's own
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, by_name

def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from agc_tpu_torch import AGCFile
    from agc_tpu_torch.core import ArchiveReader
    from agc_tpu_torch.core.compressor import Compressor, CompressorParams, create_archive
    from agc_tpu_torch.ops import _build
    from agc_tpu_torch.ops import cuda_kmers as ck
    from agc_tpu_torch.ops import kmers as tk

    # -- 1. environment ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
          f"count {torch.cuda.device_count()}")
    print(card)
    dev = torch.device(DEVICE)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip())

    results = {}

    # -- 3. kernels against their plain versions ---------------------------
    n_scan = N_SCAN
    rows = scan_rows(np, 8, n_scan, SEED)
    packed = torch.from_numpy(np.stack([tk.pack4_np(r) for r in rows])).to(dev)
    err = 0
    scan_ms = plain_ms = None
    for k in (17, 21, 31, 32):
        ud, ur, v = tk.dir_rc_kmers_np(rows[0, :400_000], k)
        canon = np.unique(np.minimum(ud, ur)[v])
        for n_splitters in (40, 8192):
            pick = np.sort(canon[:: max(1, len(canon) // n_splitters)][:n_splitters])
            table = tk.make_scan_table(pick, k, dev)
            t_size = table.tmix.numel()
            caps = (tk._SCAN_CAP, 16) if n_splitters == 8192 else (tk._SCAN_CAP,)
            for cap in caps:
                a = ck.scan_fused(packed, k, table.tmix, cap)
                b = ck.scan_fused_plain(packed, k, table.tmix, cap)
                torch.cuda.synchronize()
                e = max_abs_err(torch, a, b)
                counts = a[:, 0].tolist()
                print(f"scan_fused k={k} table={t_size} cap={cap}: counts {counts} "
                      f"max_abs_err {e}")
                err = max(err, e)
                if cap == 16:
                    check(max(counts) > cap, "the forced cap overflow did not overflow")
            if k == 31 and n_splitters == 8192:
                scan_ms = cuda_ms(torch, lambda: ck.scan_fused(packed, k, table.tmix, tk._SCAN_CAP), 20)
                plain_ms = cuda_ms(torch, lambda: ck.scan_fused_plain(packed, k, table.tmix, tk._SCAN_CAP), 3)
    check(err == 0, f"scan_fused disagrees with its plain version (max_abs_err {err})")
    # the large-table join (plain torch ops, no kernel): card against CPU
    ud, ur, v = tk.dir_rc_kmers_np(rows[0, :400_000], 31)
    canon = np.unique(np.minimum(ud, ur)[v])
    pick = canon[:: max(1, len(canon) // 9000)]  # > 8192 splitters: a join table
    jt_dev, jt_cpu = tk.make_scan_table(pick, 31, dev), tk.make_scan_table(pick, 31, "cpu")
    check(jt_dev.kind == "join", "the join table is not a join table")
    jcap = tk._cap_total_for(2, n_scan)
    j_dev = tk.scan_batch_join_global_p4(packed[:2], 31, jt_dev.thi, jt_dev.tlo, jcap)
    j_cpu = tk.scan_batch_join_global_p4(packed[:2].cpu(), 31, jt_cpu.thi, jt_cpu.tlo, jcap)
    e = max_abs_err(torch, j_dev.cpu(), j_cpu)
    print(f"join scan (torch ops) table={jt_dev.thi.numel()}: count {int(j_dev[0])}, "
          f"card vs CPU max_abs_err {e}")
    check(e == 0, "the join scan differs between the card and the CPU")
    results["scan_fused"] = dict(
        source="agc_tpu_torch/csrc/scan_fused.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:232",
        max_abs_err=err, ms=scan_ms, plain_ms=plain_ms,
        shape=f"8 x {n_scan} symbols, k=31, 16384-entry table, cap {tk._SCAN_CAP}",
    )
    del packed

    rng = np.random.default_rng(SEED)
    ref = structured_ref(np, rng, REF_MB << 20)
    k = 31
    cpacked = torch.from_numpy(tk.pack4_np(ref)[None, :]).to(dev)
    canon = ck.kmer_canon(cpacked, k)
    e = max_abs_err(torch, canon, ck.kmer_canon_plain(cpacked, k))
    check(e == 0, f"kmer_canon disagrees with its plain version (max_abs_err {e})")
    results["kmer_canon"] = dict(
        source="agc_tpu_torch/csrc/kmer_canon.cu",
        replaces="agc_tpu/ops/pallas_kmers.py:106",
        max_abs_err=e,
        ms=cuda_ms(torch, lambda: ck.kmer_canon(cpacked, k), 10),
        plain_ms=cuda_ms(torch, lambda: ck.kmer_canon_plain(cpacked, k), 2),
        shape=f"1 contig x {len(ref)} symbols, k=31",
    )
    print(f"kmer_canon k=31 n={len(ref)}: max_abs_err {e}")

    flat = canon[0].contiguous()
    pool = tk.sort_kmers(flat)
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    reals = torch.full((1,), len(ref), dtype=torch.int64, device=dev)
    seg = max(CompressorParams().segment_size, k)
    cap = len(ref) // seg + 2
    g = ck.greedy_walk(flat, starts, reals, pool, seg, cap)
    gp = ck.greedy_walk_plain(flat, starts, reals, pool, seg, cap)
    e = max_abs_err(torch, g, gp)
    check(e == 0, f"greedy_walk disagrees with its plain version (max_abs_err {e})")
    check(int(g[0, 0]) > 100, f"greedy_walk emitted only {int(g[0, 0])} splitters")
    results["greedy_walk"] = dict(
        source="agc_tpu_torch/csrc/greedy_walk.cu",
        replaces="agc_tpu/ops/kmers.py:599",
        max_abs_err=e,
        ms=cuda_ms(torch, lambda: ck.greedy_walk(flat, starts, reals, pool, seg, cap), 5),
        plain_ms=cuda_ms(torch, lambda: ck.greedy_walk_plain(flat, starts, reals, pool, seg, cap), 2),
        shape=f"1 contig x {len(ref)} positions, pool {pool.numel()}, seg {seg}",
    )
    print(f"greedy_walk: {int(g[0, 0])} emissions, max_abs_err {e}")
    del cpacked, canon, flat, pool, g, gp
    torch.cuda.empty_cache()

    # -- 4. the main path: chr-scale create --------------------------------
    from torch.profiler import ProfilerActivity, profile

    tmp = tempfile.mkdtemp(prefix="agc_torch_smoke_")
    try:
        files = [os.path.join(tmp, "ref.fa")]
        write_fasta(np, files[0], [("chr1", ref)])
        seqs = {"ref": ref}
        for i in range(N_SAMPLES):
            seqs[f"s{i}"] = mutate(np, rng, ref)
            files.append(os.path.join(tmp, f"s{i}.fa"))
            write_fasta(np, files[-1], [("chr1", seqs[f"s{i}"])])
        total = sum(len(s) for s in seqs.values())
        out = os.path.join(tmp, "smoke.agc")

        def timed_create(params) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            create_archive(out, files, params, device=DEVICE)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        ck.reset_launches()
        # default parameters; verbosity 1 only adds the stage timings on stderr
        walls = [timed_create(CompressorParams(verbosity=1))]
        launches = dict(ck.LAUNCHES)
        print(f"create: {total} bases in {walls[0]:.4f} s = {total / walls[0] / 1e6:.2f} "
              f"Mbases/s ({card}); archive {os.path.getsize(out)} bytes; launches {launches}")
        for name in results:
            check(launches[name] > 0, f"the create never launched {name}")
            results[name]["launches"] = launches[name]
        walls += [timed_create(CompressorParams()) for _ in range(2)]
        print(f"create walls (s): {[round(w, 4) for w in walls]}; Mbases/s: "
              f"{[round(total / w / 1e6, 2) for w in walls]} ({card})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pwall = timed_create(CompressorParams())
        busy, by_name = device_time(torch, prof)
        print(f"profiled create: wall {pwall:.4f} s, device busy {busy:.3f} ms, "
              f"busy share {busy / 1e3 / pwall:.5f} of that run ({card})")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  device {ms:9.3f} ms  {name[:100]}")

        reader = ArchiveReader(out)
        data, _n = reader.get_part("splitters", 0)
        reader.close()
        got = set(np.frombuffer(data, dtype="<u8").tolist())
        t0 = time.perf_counter()
        cpu = Compressor(os.path.join(tmp, "cpu.agc"), CompressorParams(),
                         reference_file=files[0], device="cpu")
        want = cpu.splitter_set_snapshot()
        cpu.abort()
        print(f"splitters: {len(got)} on the card, {len(want)} from the plain "
              f"versions on the CPU ({time.perf_counter() - t0:.1f} s)")
        check(got == want and len(got) > 100, "splitters differ from the CPU plain version")

        alpha = np.frombuffer(ALPHA, dtype=np.uint8)
        with AGCFile(out) as agc:
            for name, seq in seqs.items():
                check(agc.GetCtgSeq(name, "chr1").encode("latin-1") == alpha[seq].tobytes(),
                      f"sample {name} does not extract byte-equal")
        print(f"extract: {len(seqs)} samples byte-equal")

        # -- 5. the CLI on the card ----------------------------------------
        cli_out = os.path.join(tmp, "cli.agc")
        cli = [sys.executable, "-m", "agc_tpu_torch.cli.main"]
        r = subprocess.run(cli + ["create", "--device", DEVICE, "-o", cli_out, *files],
                           cwd=REPO, capture_output=True, timeout=600)
        check(r.returncode == 0, f"CLI create exited {r.returncode}: {r.stderr[-2000:]!r}")
        r = subprocess.run(cli + ["getctg", cli_out, "chr1@s1"],
                           cwd=REPO, capture_output=True, timeout=600)
        check(r.returncode == 0, f"CLI getctg exited {r.returncode}: {r.stderr[-2000:]!r}")
        body = b"".join(r.stdout.split(b"\n")[1:])
        check(body == alpha[seqs["s1"]].tobytes(), "CLI getctg does not extract byte-equal")
        print("CLI: create --device cuda, then getctg chr1@s1 byte-equal")
        del seqs

        # -- 6. card against CPU on a many-contig collection ----------------
        crng = np.random.default_rng(SEED + 1)
        base = [structured_ref(np, crng, int(n))
                for n in crng.integers(20_000, 2_000_000, 24)]
        cfiles = []
        for fi in range(3):
            cfiles.append(os.path.join(tmp, f"m{fi}.fa"))
            write_fasta(np, cfiles[-1], [
                (f"ctg{ci}.{fi}", b if fi == 0 else mutate(np, crng, b))
                for ci, b in enumerate(base)
            ])
        cbases = sum(len(b) for b in base)
        for label, params in (
            ("default", CompressorParams()),
            ("-c", CompressorParams(concatenated_genomes=True)),
            ("segment 1000", CompressorParams(segment_size=1000)),
        ):
            a, b = os.path.join(tmp, "card.agc"), os.path.join(tmp, "cpu.agc")
            t0 = time.perf_counter()
            create_archive(a, cfiles, params, device=DEVICE)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            create_archive(b, cfiles, params, device="cpu")
            t_cpu = time.perf_counter() - t0
            reader = ArchiveReader(a)
            n_split = reader.get_part("splitters", 0)[1]
            reader.close()
            equal = same_archive(ArchiveReader, a, b)
            print(f"collection ({label}; 3 files x 24 contigs, reference {cbases} bases): "
                  f"{n_split} splitters; card {t_card:.2f} s, CPU {t_cpu:.2f} s; "
                  f"archives equal part for part: {equal}")
            check(equal, f"card and CPU archives differ ({label})")
        check(n_split > 8192, "segment 1000 did not reach the join-scan table size")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    for name, r in results.items():
        print(f"{name}: {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms "
              f"({r['shape']}; {card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
