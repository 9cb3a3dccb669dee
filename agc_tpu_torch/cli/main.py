"""Command line of the port: ``python -m agc_tpu_torch.cli.main``.

``create`` and ``append`` run through the port (``--device``, default
``cuda``); every other subcommand (getcol, getset, getctg, the listings,
info, convert, check) is host-only and goes to ``agc_tpu.cli.main``
unchanged. Subcommands and options otherwise match agc_tpu's CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from agc_tpu.cli import main as _tpu_cli


def build_parser() -> argparse.ArgumentParser:
    """agc_tpu's parser with ``--device`` on create and append."""
    ap = _tpu_cli.build_parser()
    sub = next(
        a for a in ap._actions if isinstance(a, argparse._SubParsersAction)
    )
    for name in ("create", "append"):
        sub.choices[name].add_argument(
            "--device", default="cuda",
            help="torch device for the k-mer kernels: cuda (default) or "
            "cpu (their plain PyTorch versions)",
        )
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("create", "append"):
        return _tpu_cli.main(argv)
    try:
        import signal

        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # non-POSIX / non-main thread
        pass
    args = build_parser().parse_args(argv)
    t0 = time.time()
    try:
        rc = _create_or_append(args)
    except (KeyError, FileNotFoundError, ValueError, IndexError, OSError) as e:
        if isinstance(e, BrokenPipeError):
            return 141
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.verbosity > 0:
        print(f"***\nCompleted in           : {time.time() - t0:.3f} s", file=sys.stderr)
    return rc


def _create_or_append(args) -> int:
    from ..core.compressor import CompressorParams, append_archive, create_archive

    clamp = _tpu_cli._clamp
    params = CompressorParams(
        concatenated_genomes=args.concatenated,
        adaptive_compression=args.adaptive,
        fallback_frac=clamp(args.fallback_frac, 0.0, 0.05),
        pack_cardinality=clamp(args.batch, 1, 1_000_000_000),
        verbosity=args.verbosity,
        profile=getattr(args, "profile", "zstd"),
    )
    if args.mode == "create":
        if args.shards > 1:
            raise NotImplementedError(
                "not ported to agc_tpu_torch yet: --shards (parallel/, ROADMAP A.5)"
            )
        params.kmer_length = clamp(args.kmer_len, 17, 32)
        params.min_match_len = clamp(args.min_match_len, 15, 32)
        params.segment_size = clamp(args.segment_size, 100, 1_000_000)
    # reference: the full command line is recorded unless -d
    cmd_line = None if args.no_cmd_line else "agc-tpu " + " ".join(sys.argv[1:])
    inputs = list(args.inputs)
    if args.input_list:
        with open(args.input_list) as f:
            inputs.extend(line.strip() for line in f if line.strip())
    if not inputs:
        print("Error: no input FASTA files given", file=sys.stderr)
        return 1
    # reference convention: the archive goes to stdout unless -o names a file
    to_stdout = not args.output
    if to_stdout:
        fd, out_archive = tempfile.mkstemp(suffix=".agc")
        os.close(fd)
    else:
        out_archive = args.output
    try:
        if args.mode == "create":
            create_archive(out_archive, inputs, params, cmd_line=cmd_line,
                           device=args.device)
        else:
            append_archive(args.in_archive, out_archive, inputs, params,
                           cmd_line=cmd_line, device=args.device)
        if to_stdout:
            import shutil

            with open(out_archive, "rb") as f:
                shutil.copyfileobj(f, sys.stdout.buffer)
            sys.stdout.buffer.flush()
    finally:
        if to_stdout:
            try:
                os.unlink(out_archive)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
