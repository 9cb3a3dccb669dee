"""Human haplotype assemblies of one chromosome (HPRC/HPP style).

The reference is a leading N run (an unplaced arm) followed by sequence
with repeat families: a share of the pieces copies one of a library of
repeat units at about 1% divergence, the rest is unique backbone (the
shape of the repository's ``chip_smoke.py`` generator, copied here so the
yardstick does not move with that script, with its sizes and shares made
fixed sets).

The reference comes from the configuration's own seed, the same in every
run, as a deployment's reference (GRCh38) is one sequence; the run's seed
draws the haplotypes. Each haplotype is the reference's assembled sequence (the leading N run
left out, as an assembly does not carry the reference's gap) with SNPs,
short indels and structural insertions and deletions at fixed rates, a
few scaffold gaps of N, cut into contigs at random breaks, each contig
reverse-complemented with a fixed probability, as assemblers emit either
strand. Counts follow from the rates and lengths, and sizes are drawn
from fixed sets in a seeded order, so every seed does the same work.
"""

from __future__ import annotations

import numpy as np

from portbench.inputs import N_CODE, Inputs, revcomp, rng_for, sample, spread


def structured(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    lo, hi = p["unit_length"]
    sizes = np.linspace(lo, hi, p["repeat_units"]).round().astype(np.int64)
    units = [rng.integers(0, 4, size=int(s), dtype=np.uint8) for s in spread(sizes, len(sizes), rng)]
    b_lo, b_hi = p["backbone_length"]
    share = p["repeat_share"]
    mean = share * sizes.mean() + (1 - share) * (b_lo + b_hi) / 2
    count = int(n / mean * 1.1) + 100  # pieces enough to pass n
    repeat = spread(np.arange(100) < round(100 * share), count, rng)
    which = spread(np.arange(len(units)), int(repeat.sum()), rng)
    backbone = spread(np.linspace(b_lo, b_hi, 64).round().astype(np.int64),
                      count - len(which), rng)
    pieces, total, r, b = [], 0, 0, 0
    for is_repeat in repeat.tolist():
        if total >= n:
            break
        if is_repeat:
            copy = units[which[r]].copy()
            r += 1
            n_sub = max(1, int(len(copy) * p["unit_divergence"]))
            pos = rng.integers(0, len(copy), size=n_sub)
            copy[pos] = (copy[pos] + rng.integers(1, 4, size=n_sub)) % 4
            pieces.append(copy)
        else:
            pieces.append(rng.integers(0, 4, size=int(backbone[b]), dtype=np.uint8))
            b += 1
        total += len(pieces[-1])
    return np.concatenate(pieces)[:n]


def reference(p: dict) -> np.ndarray:
    r = p["reference"]
    body = structured(rng_for(r["seed"], 0), r["length"] - r["leading_n"], r)
    return np.concatenate([np.full(r["leading_n"], N_CODE, np.uint8), body])


def haplotype(rng: np.random.Generator, assembled: np.ndarray, p: dict,
              n_contigs: int) -> list:
    """The contigs (codes) of one haplotype of ``assembled``."""
    seq = assembled.copy()
    n = len(seq)
    pos = rng.integers(0, n, size=n // p["snp_every"])
    seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4

    i_lo, i_hi = p["indel_length"]
    s_lo, s_hi = p["sv_length"]
    lengths, insert = [], []
    for count, sizes in ((n // p["indel_every"], lambda m: np.arange(i_lo, i_hi + 1)),
                         (n // p["sv_every"],
                          lambda m: np.linspace(s_lo, s_hi, max(m, 1)).round().astype(np.int64))):
        # half insertions, half deletions, each of the same set of sizes
        for kind, m in ((1, count // 2), (0, count - count // 2)):
            lengths.append(spread(sizes(m), m, rng))
            insert.append(np.full(m, kind))
    lengths, insert = np.concatenate(lengths), np.concatenate(insert)
    at = rng.integers(0, n, size=len(lengths))
    order = np.argsort(at, kind="stable")
    pieces, cur = [], 0
    for a, ln, ins in zip(at[order].tolist(), lengths[order].tolist(),
                          insert[order].tolist()):
        if a < cur:  # inside the previous deletion
            continue
        pieces.append(seq[cur:a])
        if ins:
            pieces.append(rng.integers(0, 4, size=ln, dtype=np.uint8))
            cur = a
        else:
            cur = min(a + ln, n)
    pieces.append(seq[cur:])
    seq = np.concatenate(pieces)

    gap = p["gap_length"]
    for a in rng.integers(0, len(seq) - gap, size=p["gaps"]).tolist():
        seq[a : a + gap] = N_CODE

    least = p["min_contig"]
    while True:
        cuts = np.sort(rng.integers(least, len(seq) - least, size=n_contigs - 1))
        if n_contigs == 1 or np.diff(np.concatenate([[0], cuts, [len(seq)]])).min() >= least:
            break
    contigs = np.split(seq, cuts)
    flip = rng.random(len(contigs)) < p["revcomp_share"]
    return [revcomp(c) if f else c for c, f in zip(contigs, flip)]


def make(p: dict, seed: int, workdir: str, n_extra: int) -> Inputs:
    ref = reference(p)
    ref_sample = sample(workdir, "chr21", [("chr21", ref)])
    assembled = ref[p["reference"]["leading_n"]:]
    total = p["haplotypes"] + n_extra
    lo, hi = p["contigs"]
    n_contigs = spread(np.arange(lo, hi + 1), total, rng_for(seed, 1))
    haps = []
    for i in range(total):
        name = f"hap{i + 1:02d}"
        contigs = haplotype(rng_for(seed, 2, i), assembled, p, int(n_contigs[i]))
        haps.append(sample(workdir, name, [
            (f"{name}#ctg{j + 1:06d}", c) for j, c in enumerate(contigs)
        ]))
    samples = haps[: p["haplotypes"]]
    return Inputs(ref_sample, samples, extra=haps[p["haplotypes"]:], warmup=samples[:1])
