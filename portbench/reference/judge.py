"""What decides ``correct``: the archives the window wrote, read by the
frozen reader and held against the inputs and AGC's rules.

Every number compared is a count of faults with the limit 0 (each
comparison is exact):

- ``samples_wrong``: samples of the archive that are missing, unexpected,
  or whose contigs (names, order, every symbol) do not decode to the
  input, or that do not decode at all;
- ``splitters_wrong``: splitters that differ from AGC's discovery on the
  reference (under ``-a``: reference splitters missing, and added
  splitters that are k-mers of the reference), plus a parameter stored
  that is not the configuration's;
- ``cuts_wrong``: checked contigs whose segments break AGC's cut rules;
- ``bytes_unaccounted``: bytes of the file that no part holds or that two
  parts claim, so ``archive_ratio`` divides by the archive's own bytes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import discovery
from .archive import Archive, Container

LIMITS = {"samples_wrong": 0, "splitters_wrong": 0, "cuts_wrong": 0,
          "bytes_unaccounted": 0}


def expected_samples(samples, concatenated: bool) -> list:
    """[(sample name, [(contig header, codes)])] an archive of ``samples``
    holds: one a file, or under ``-c`` one a contig, named by its header's
    first word."""
    if not concatenated:
        return [(s.name, s.contigs) for s in samples]
    return [(h.split()[0], [(h, c)]) for s in samples for h, c in s.contigs]


def layout_only(path: str) -> tuple[str, int]:
    """(digest of the archive's streams and parts, bytes unaccounted). Two
    archives with one digest hold the same parts and differ at most in
    where the container put them, as threads that store in parallel may."""
    h = hashlib.sha256()
    try:
        c = Container(path)
        for name in sorted(c.streams):
            h.update(name.encode() + b"\0")
            for i in range(len(c.streams[name])):
                data, meta = c.part(name, i)
                h.update(len(data).to_bytes(8, "little") + meta.to_bytes(8, "little") + data)
        return h.hexdigest(), c.unaccounted()
    except Exception as exc:  # judged in full, where it fails every number
        return f"unreadable {path} {exc!r}", 0


def judge(path: str, want: list, ref: discovery.Discovery, cfg: dict,
          check_cuts) -> dict:
    """The compared numbers of one archive. ``want``: expected_samples;
    ``check_cuts(sample_name) -> bool`` picks the samples whose cuts are
    checked."""
    p = cfg
    try:
        arc = Archive(path)
        layout = arc.sample_layout()
        splitters = arc.splitters()
    except Exception as exc:  # an archive that does not open fails them all
        print(f"archive {path} does not open: {exc!r}")
        return {"samples_wrong": len(want), "splitters_wrong": len(ref.splitters) + 1,
                "cuts_wrong": len(want), "bytes_unaccounted": 1}
    names = [n for n, _ in want]
    wrong = len(set(layout) - set(names)) + int(list(layout) != names and
                                                  set(layout) == set(names))
    cuts_wrong = 0
    for name, contigs in want:
        got = layout.get(name)
        if got is None or [c for c, _ in got] != [h for h, _ in contigs]:
            wrong += 1
            continue
        try:
            ok = all(np.array_equal(arc.contig(segs), codes)
                     for (_, segs), (_, codes) in zip(got, contigs))
        except Exception as exc:
            print(f"sample {name} does not decode: {exc!r}")
            ok = False
        wrong += int(not ok)
        if ok and check_cuts(name):
            cuts_wrong += sum(
                discovery.cut_faults(codes, [s[3] for s in segs], arc.k, splitters,
                                     ref.splitters, p["adaptive_compression"],
                                     p["concatenated_genomes"]) > 0
                for (_, segs), (_, codes) in zip(got, contigs))

    if p["adaptive_compression"]:
        added = np.setdiff1d(splitters, ref.splitters)
        split_wrong = (len(np.setdiff1d(ref.splitters, splitters))
                       + int(discovery.member(added, ref.kmers).sum()))
    else:
        split_wrong = len(np.setxor1d(splitters, ref.splitters))
    split_wrong += int((arc.k, arc.min_match, arc.pack, arc.segment_size) != (
        p["kmer_length"], p["min_match_len"], p["pack_cardinality"], p["segment_size"]))
    return {"samples_wrong": wrong, "splitters_wrong": split_wrong,
            "cuts_wrong": cuts_wrong, "bytes_unaccounted": arc.c.unaccounted()}
