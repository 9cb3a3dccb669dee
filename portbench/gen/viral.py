"""A viral surveillance collection (SARS-CoV-2 style).

The reference is random sequence of the virus's length. Lineages differ
from it by substitutions and short deletions. The reference and the
lineages come from the configuration's ``lineage_seed``, the same for
every run, as the circulating lineages are the same whoever samples them:
a lineage's variant that falls on one of the reference's few splitters
changes the segments of every genome of that lineage, and drawn anew a
run, these few events made one seed's create four times another's. The
run's seed draws the genomes: each takes a lineage and adds private
substitutions; a share of the genomes carries
runs of N (amplicon dropouts); both ends are trimmed. The genomes come as
one concatenated multi-FASTA, as AGC's README has such collections
compressed with ``-c``. Every count and length is drawn from a fixed set
in a seeded order, so every seed does the same work.
"""

from __future__ import annotations

import numpy as np

from portbench.inputs import N_CODE, Inputs, rng_for, sample, spread


def lineage(rng: np.random.Generator, ref: np.ndarray, n_sub: int,
            del_lengths) -> np.ndarray:
    seq = ref.copy()
    pos = rng.choice(len(seq), size=n_sub, replace=False)
    seq[pos] = (seq[pos] + rng.integers(1, 4, size=n_sub)) % 4
    keep = np.ones(len(seq), bool)
    for ln in del_lengths:
        a = int(rng.integers(0, len(seq) - ln))
        keep[a : a + ln] = False
    return seq[keep]


def make(p: dict, seed: int, workdir: str, n_extra: int) -> Inputs:
    if n_extra:
        raise ValueError("the viral generator makes no further samples")
    rng = rng_for(p["lineage_seed"], 0)
    ref = rng.integers(0, 4, size=p["reference_length"], dtype=np.uint8)
    ref_sample = sample(workdir, "reference", [(p["reference_name"], ref)])

    subs, dels = p["lineage_substitutions"], p["lineage_deletions"]
    d_lo, d_hi = p["deletion_length"]
    del_len = spread(np.arange(d_lo, d_hi + 1), sum(dels), rng)
    starts = np.cumsum([0, *dels])
    lineages = [lineage(rng, ref, s, del_len[starts[i] : starts[i + 1]])
                for i, s in enumerate(subs)]

    rng = rng_for(seed, 1)
    n = p["genomes"]
    which = spread(np.arange(len(lineages)), n, rng)
    p_lo, p_hi = p["private_substitutions"]
    private = spread(np.arange(p_lo, p_hi + 1), n, rng)
    with_n = np.zeros(n, np.int64)
    carriers = rng.permutation(n)[: round(p["n_run_share"] * n)]
    r_lo, r_hi = p["n_runs"]
    with_n[carriers] = spread(np.arange(r_lo, r_hi + 1), len(carriers), rng)
    l_lo, l_hi = p["n_run_length"]
    run_len = spread(np.arange(l_lo, l_hi + 1), int(with_n.sum()), rng)
    t_lo, t_hi = p["trim"]
    left = spread(np.arange(t_lo, t_hi + 1), n, rng)
    right = spread(np.arange(t_lo, t_hi + 1), n, rng)

    genomes, r = [], 0
    for i in range(n):
        seq = lineages[which[i]].copy()
        pos = rng.integers(0, len(seq), size=private[i])
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        for _ in range(with_n[i]):
            ln = int(run_len[r])
            r += 1
            a = int(rng.integers(0, len(seq) - ln))
            seq[a : a + ln] = N_CODE
        genomes.append((f"g{i + 1:04d}", seq[left[i] : len(seq) - right[i]]))
    collection = sample(workdir, "genomes", genomes)
    warmup = sample(workdir, "warmup", genomes[: p["warmup_genomes"]])
    return Inputs(ref_sample, [collection], warmup=[warmup])
