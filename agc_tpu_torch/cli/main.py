"""Command line of the port: ``python -m agc_tpu_torch.cli.main``.

A copy of agc_tpu's CLI. Subcommand surface and option semantics match
the reference CLI (reference: src/app/main.cpp:31-73,
src/app/application.{h,cpp}):

    create append getcol getset getctg listref listset listctg info

``create`` and ``append`` take ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain PyTorch versions); ``--shards`` above 1 raises
until the multi-device creates are ported (ROADMAP A.5).
"""

from __future__ import annotations

import argparse
import sys
import time


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def _add_create_opts(p: argparse.ArgumentParser, append: bool = False) -> None:
    p.add_argument("-a", "--adaptive", action="store_true", help="adaptive mode (add new splitters for non-matching contigs)")
    p.add_argument("-b", "--batch", type=int, default=50, help="internal batch size (pack cardinality) [1, 1e9]")
    p.add_argument("-c", "--concatenated", action="store_true", help="treat each contig as a separate sample")
    p.add_argument("-f", "--fallback-frac", type=float, default=0.0, help="fraction of fallback minimizers [0, 0.05]")
    if not append:
        p.add_argument("-k", "--kmer-len", type=int, default=31, help="k-mer length [17, 32]")
        p.add_argument("-l", "--min-match-len", type=int, default=20, help="min. match length [15, 32]")
        p.add_argument("-s", "--segment-size", type=int, default=60000, help="expected segment size [100, 1e6]")
    p.add_argument("-t", "--threads", type=int, default=0, help="no. of threads (0 = auto)")
    p.add_argument("-v", "--verbosity", type=int, default=0, help="verbosity [0, 2]")
    p.add_argument("-d", "--no-cmd-line", action="store_true", help="do not store the command line")
    p.add_argument(
        "--device", default="cuda",
        help="torch device for the k-mer kernels: cuda (default) or cpu "
        "(their plain PyTorch versions)",
    )
    p.add_argument(
        "-i", "--input-list", default="",
        help="file with FASTA file names, one per line (alternative to "
        "listing them on the command line; reference: create -i)",
    )


def _add_out_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("-o", "--output", default="", help="output file/dir (default: stdout)")
    p.add_argument("-g", "--gzip-level", type=int, default=0, help="gzip output, level [0, 9]")
    p.add_argument("-l", "--line-length", type=int, default=80, help="FASTA line length [40, 2e9]")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("-p", "--no-prefetch", action="store_true", help="disable archive prefetch (lower memory)")
    p.add_argument("--fast", action="store_true", help="fast decompression mode (always on in agc-tpu; accepted for compatibility)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="agc-tpu",
        description="TPU-native assembled genomes compressor (AGC-compatible archives)",
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("create", help="create archive from FASTA files (first file is the reference)")
    p.add_argument("inputs", nargs="*", help="FASTA files (plain or gzipped); the first is the reference")
    p.add_argument("-o", "--output", default="", help="output archive (default: stdout)")
    _add_create_opts(p)
    p.add_argument(
        "--profile", choices=("zstd", "tpu-rans"), default="zstd",
        help="archive profile: zstd (reference-compatible, default) or "
        "tpu-rans (TPU-native entropy stage; readable by agc-tpu and its "
        "C API, convertible with 'agc-tpu convert')",
    )
    p.add_argument(
        "--shards", type=int, default=1,
        help="data-parallel shards (multi-host scale-out; output archives "
        "extract identically for any shard count)",
    )

    p = sub.add_parser("append", help="append FASTA files to an existing archive")
    p.add_argument("in_archive")
    p.add_argument("inputs", nargs="*")
    p.add_argument("-o", "--output", default="", help="output archive (default: stdout)")
    _add_create_opts(p, append=True)

    p = sub.add_parser("getcol", help="extract all samples")
    p.add_argument("in_archive")
    p.add_argument("-o", "--output", default="", help="output directory (default: stdout)")
    p.add_argument("-g", "--gzip-level", type=int, default=0)
    p.add_argument("-l", "--line-length", type=int, default=80)
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("-p", "--no-prefetch", action="store_true")
    p.add_argument("-r", "--no-ref", action="store_true", help="skip the reference sample")
    p.add_argument("-f", "--fast", action="store_true", help="fast mode (always on in agc-tpu; accepted for compatibility)")

    p = sub.add_parser("getset", help="extract listed samples")
    p.add_argument("in_archive")
    p.add_argument("samples", nargs="+")
    _add_out_opts(p)
    p.add_argument("-s", "--streaming", action="store_true", help="streaming mode (constant memory)")

    p = sub.add_parser("getctg", help="extract contigs: ctg[@sample][:from-to]")
    p.add_argument("in_archive")
    p.add_argument("contigs", nargs="+")
    _add_out_opts(p)
    p.add_argument("-s", "--streaming", action="store_true")

    p = sub.add_parser("listref", help="print the reference sample name")
    p.add_argument("in_archive")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-p", "--no-prefetch", action="store_true")

    p = sub.add_parser("listset", help="list samples")
    p.add_argument("in_archive")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-p", "--no-prefetch", action="store_true")

    p = sub.add_parser("listctg", help="list contigs of listed samples")
    p.add_argument("in_archive")
    p.add_argument("samples", nargs="+")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-p", "--no-prefetch", action="store_true")

    p = sub.add_parser(
        "convert",
        help="rewrite an archive in another profile (agc-tpu extension): "
        "zstd (reference-compatible) <-> tpu-rans (TPU-native entropy)",
    )
    p.add_argument("in_archive")
    p.add_argument("out_archive")
    p.add_argument(
        "--profile", choices=("zstd", "tpu-rans"), required=True,
        help="target archive profile",
    )
    p.add_argument("-v", "--verbosity", type=int, default=0)

    p = sub.add_parser("info", help="archive info")
    p.add_argument("in_archive")
    p.add_argument("-o", "--output", default="", help="output file (default: stderr)")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("-p", "--no-prefetch", action="store_true")

    p = sub.add_parser(
        "check",
        help="verify archive integrity (agc-tpu extension): metadata "
        "plus a full decode of every contig; -q checks structure only",
    )
    p.add_argument("in_archive")
    p.add_argument("-q", "--quick", action="store_true",
                   help="structure/metadata only (no contig decode)")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("-p", "--no-prefetch", action="store_true")

    return ap


def _out_stream(path: str):
    """Writable stream for -o; used as a context manager. With no path it
    yields sys.stdout WITHOUT closing it on exit (an in-process caller —
    tests, scripts invoking main() twice — must keep its stdout)."""
    import contextlib

    if not path:
        return contextlib.nullcontext(sys.stdout)
    return open(path, "w")


def main(argv: list[str] | None = None) -> int:
    # die silently when the downstream pipe closes (| head), like the
    # reference C++ binary's default SIGPIPE disposition
    try:
        import signal

        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # non-POSIX / non-main thread
        pass
    args = build_parser().parse_args(argv)
    t0 = time.time()
    try:
        rc = _dispatch(args)
    except (KeyError, FileNotFoundError, ValueError, IndexError, OSError) as e:
        # IndexError/OSError: truncated or corrupted archives surface as
        # parse failures deep in the readers; report them cleanly like
        # the reference's "Corrupted archive!" paths
        if isinstance(e, BrokenPipeError):  # subclass of OSError
            return 141  # silent, like the reference binary's SIGPIPE exit
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if getattr(args, "verbosity", 0) > 0:
        print(f"***\nCompleted in           : {time.time() - t0:.3f} s", file=sys.stderr)
    return rc


def _threads(args) -> int:
    import os

    t = getattr(args, "threads", 0)
    return t if t > 0 else max(1, (os.cpu_count() or 2) // 2)


def _dispatch(args) -> int:
    mode = args.mode

    if mode in ("create", "append"):
        from ..core.compressor import CompressorParams, append_archive, create_archive

        params = CompressorParams(
            concatenated_genomes=args.concatenated,
            adaptive_compression=args.adaptive,
            fallback_frac=_clamp(args.fallback_frac, 0.0, 0.05),
            pack_cardinality=_clamp(args.batch, 1, 1_000_000_000),
            verbosity=args.verbosity,
            profile=getattr(args, "profile", "zstd"),
        )
        # reference: the full command line is recorded unless -d
        # (main.cpp:31-44, 116-117); only v1/v2 collections persist it
        cmd_line = (
            None
            if getattr(args, "no_cmd_line", False)
            else "agc-tpu " + " ".join(sys.argv[1:])
        )
        inputs = list(args.inputs)
        if getattr(args, "input_list", ""):
            with open(args.input_list) as f:
                inputs.extend(
                    line.strip() for line in f if line.strip()
                )
        if not inputs:
            print("Error: no input FASTA files given", file=sys.stderr)
            return 1
        args.inputs = inputs
        # reference convention (application.cpp:108,177): the archive goes
        # to stdout unless -o names a file
        to_stdout = not args.output
        if to_stdout:
            import tempfile

            fd, out_archive = tempfile.mkstemp(suffix=".agc")
            import os as _os

            _os.close(fd)
        else:
            out_archive = args.output
        try:
            if mode == "create":
                params.kmer_length = _clamp(args.kmer_len, 17, 32)
                params.min_match_len = _clamp(args.min_match_len, 15, 32)
                params.segment_size = _clamp(args.segment_size, 100, 1_000_000)
                if getattr(args, "shards", 1) > 1:
                    raise NotImplementedError(
                        "not ported to agc_tpu_torch yet: --shards and the "
                        "distributed creates (parallel/, ROADMAP A.5)"
                    )
                else:
                    create_archive(
                        out_archive, args.inputs, params, cmd_line=cmd_line,
                        device=args.device,
                    )
            else:
                append_archive(
                    args.in_archive, out_archive, args.inputs, params,
                    cmd_line=cmd_line, device=args.device,
                )
            if to_stdout:
                with open(out_archive, "rb") as f:
                    import shutil

                    shutil.copyfileobj(f, sys.stdout.buffer)
                sys.stdout.buffer.flush()
        finally:
            if to_stdout:
                import os as _os

                try:
                    _os.unlink(out_archive)
                except OSError:
                    pass
        return 0

    if mode == "convert":
        from ..core.convert import convert_archive

        try:
            convert_archive(args.in_archive, args.out_archive, args.profile)
        except (ValueError, OSError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        return 0

    from ..core.decompressor import Decompressor

    prefetch = not getattr(args, "no_prefetch", False)
    if args.mode in ("listref", "listset", "listctg", "info"):
        # metadata-only modes never benefit from buffering the whole
        # archive in RAM (the reference buffers here too; we skip it)
        prefetch = False

    if mode == "getcol":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        d.get_collection_files(
            args.output,
            line_length=_clamp(args.line_length, 40, 2_000_000_000),
            no_threads=_threads(args),
            gzip_level=_clamp(args.gzip_level, 0, 9),
            no_ref=args.no_ref,
        )
        d.close()
        return 0

    if mode == "getset":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        if args.streaming:
            d.get_streaming(
                args.output or None,
                sample_names=args.samples,
                line_length=_clamp(args.line_length, 40, 2_000_000_000),
                gzip_level=_clamp(args.gzip_level, 0, 9),
            )
        else:
            d.get_sample_file(
                args.output or None,
                args.samples,
                line_length=_clamp(args.line_length, 40, 2_000_000_000),
                no_threads=_threads(args),
                gzip_level=_clamp(args.gzip_level, 0, 9),
            )
        d.close()
        return 0

    if mode == "getctg":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        d.app_warnings = True
        if args.streaming:
            d.get_streaming(
                args.output or None,
                contig_queries=args.contigs,
                line_length=_clamp(args.line_length, 40, 2_000_000_000),
                gzip_level=_clamp(args.gzip_level, 0, 9),
            )
        else:
            d.get_contig_file(
                args.output or None,
                args.contigs,
                line_length=_clamp(args.line_length, 40, 2_000_000_000),
                gzip_level=_clamp(args.gzip_level, 0, 9),
            )
        d.close()
        return 0

    if mode == "listref":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        with _out_stream(args.output) as f:
            f.write(d.get_reference_sample())
        d.close()
        return 0

    if mode == "listset":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        with _out_stream(args.output) as f:
            for s in d.list_samples():
                f.write(s + "\n")
        d.close()
        return 0

    if mode == "listctg":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        with _out_stream(args.output) as f:
            for sn in args.samples:
                f.write(sn + "\n")
                for c in d.list_contigs(sn) or []:
                    f.write("   " + c + "\n")
        d.close()
        return 0

    if mode == "info":
        d = Decompressor(args.in_archive, prefetch=prefetch)
        p = d.get_params()
        out = open(args.output, "w") if args.output else sys.stderr
        print(f"No. samples      : {d.get_no_samples()}", file=out)
        print(f"k-mer length     : {p['kmer_length']}", file=out)
        print(f"Min. match length: {p['min_match_len']}", file=out)
        if p["segment_size"]:
            print(f"Segment size     : {p['segment_size']}", file=out)
        print(f"Batch size       : {p['pack_cardinality']}", file=out)
        print(f"Reference name   : {d.get_reference_sample()}", file=out)
        prof = d.file_type_info.get("compression-profile", "zstd")
        if prof != "zstd":
            # non-default profile decides reference-tool compatibility:
            # always surface it (agc-tpu extension key)
            print(f"Archive profile  : {prof}", file=out)
        print("Command lines:", file=out)
        for cmd, when in getattr(d.collection, "cmd_lines", []):
            print(f"{when} : {cmd}", file=out)
        if args.verbosity > 0:
            print("File type info:", file=out)
            for k in sorted(d.file_type_info):
                print(f"  {k} : {d.file_type_info[k]}", file=out)
        if args.output:
            out.close()
        d.close()
        return 0

    if mode == "check":
        try:
            d = Decompressor(args.in_archive, prefetch=prefetch)
        except Exception as e:
            print(f"FAIL: cannot open archive: {e}", file=sys.stderr)
            return 1
        problems: list[str] = []
        n_contigs = 0
        n_bases = 0

        def check_one(s, c, segments):
            """-> decoded base count, or an error string."""
            try:
                if not segments:
                    return 0
                want = sum(x.raw_length for x in segments) - (
                    len(segments) - 1
                ) * d.kmer_length
                if args.quick:
                    return 0
                seq = d.decompress_contig(segments)
                if len(seq) != want:
                    return f"{s}:{c}: decoded {len(seq)} bases, metadata says {want}"
                return len(seq)
            except Exception as e:
                return f"{s}:{c}: {e}"

        try:
            samples = d.list_samples()
            tasks = []
            for s in samples:
                desc = d.collection.get_sample_desc(s) or []
                for c, segments in desc:
                    tasks.append((s, c, segments))
            n_contigs = len(tasks)
            n_thr = _threads(args)
            if n_thr > 1 and not args.quick and len(tasks) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=n_thr) as pool:
                    results = list(
                        pool.map(lambda t: check_one(*t), tasks)
                    )
            else:
                results = [check_one(*t) for t in tasks]
            for r in results:
                if isinstance(r, str):
                    problems.append(r)
                else:
                    n_bases += r
        except Exception as e:
            problems.append(f"collection metadata: {e}")
        finally:
            d.close()
        for msg in problems[:20]:
            print(f"FAIL: {msg}", file=sys.stderr)
        if problems:
            print(
                f"Archive FAILED verification: {len(problems)} problem(s) "
                f"across {n_contigs} contigs",
                file=sys.stderr,
            )
            return 1
        detail = "" if args.quick else f", {n_bases} bases decoded"
        print(
            f"Archive OK: {len(samples)} samples, {n_contigs} contigs{detail}",
            file=sys.stderr,
        )
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
