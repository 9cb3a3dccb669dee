"""What a generator hands the harness: FASTA files and their sequences.

A generator module (``gen/<name>.py``) exposes ``make(params, seed,
workdir, n_extra) -> Inputs``. Sequences are numeric codes as AGC holds
them (A, C, G, T = 0..3, N = 4), so the reference compares what an
archive decodes to with what was written, symbol for symbol.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

ALPHABET = np.frombuffer(b"ACGTN", dtype=np.uint8)
N_CODE = 4
LINE = 80


@dataclass
class Sample:
    """One input file: ``name`` is the sample name AGC derives from the
    path (the stem), ``contigs`` the (header, codes) pairs it holds."""

    name: str
    path: str
    contigs: list

    @property
    def symbols(self) -> int:
        return sum(len(c) for _, c in self.contigs)


@dataclass
class Inputs:
    """``reference`` and ``samples`` make one create; ``extra`` are further
    samples (appends); ``warmup`` the samples of the set-up create."""

    reference: Sample
    samples: list
    extra: list = field(default_factory=list)
    warmup: list = field(default_factory=list)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's seed. Any whole number is a
    seed: it is taken modulo 2**64, so large and negative seeds work."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def spread(values, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values cycled from ``values`` and shuffled: every seed draws the
    same multiset of sizes, in another order, so seeds do the same work."""
    out = np.resize(np.asarray(values), n)
    rng.shuffle(out)
    return out


def revcomp(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


def write_fasta(path: str, contigs) -> None:
    """Write [(header, codes)] as FASTA with 80-symbol lines."""
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            full = len(seq) // LINE
            lines = np.empty((full, LINE + 1), dtype=np.uint8)
            lines[:, :LINE] = ALPHABET[seq[: full * LINE]].reshape(full, LINE)
            lines[:, LINE] = ord("\n")
            f.write(lines.tobytes())
            if len(seq) % LINE:
                f.write(ALPHABET[seq[full * LINE:]].tobytes() + b"\n")


def sample(workdir: str, name: str, contigs) -> Sample:
    path = os.path.join(workdir, f"{name}.fa")
    write_fasta(path, contigs)
    return Sample(name, path, contigs)
