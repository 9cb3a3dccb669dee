"""The generators: the same seed gives the same inputs, other seeds the
same amount of work, at the rates the configurations state."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench.inputs import N_CODE

from .conftest import tiny


def make(name: str, seed: int, tmp_path, n_extra: int = 0):
    spec = tiny(name)
    gen = harness.load("gen", spec.config["generator"])
    tmp_path.mkdir(parents=True, exist_ok=True)
    return gen.make(spec.config["generator_params"], seed, str(tmp_path), n_extra), spec


def flat(inputs):
    return [(s.name, h, c) for s in [inputs.reference, *inputs.samples, *inputs.extra]
            for h, c in s.contigs]


@pytest.mark.parametrize("name", ["hpp-chr21x10.create", "sars-cov-2-1k.create"])
def test_same_seed_same_inputs(name, tmp_path):
    a, _ = make(name, 2**31 + 7, tmp_path / "a")
    b, _ = make(name, 2**31 + 7, tmp_path / "b")
    c, _ = make(name, 2**31 + 8, tmp_path / "c")
    fa, fb, fc = flat(a), flat(b), flat(c)
    assert [(n, h) for n, h, _ in fa] == [(n, h) for n, h, _ in fb]
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(fa, fb))
    assert not all(np.array_equal(x[2], y[2]) for x, y in zip(fa, fc))
    for s in [a.reference, *a.samples]:
        with open(s.path, "rb") as f:
            body = b"".join(line for line in f.read().split(b"\n") if not line.startswith(b">"))
        assert body == np.frombuffer(b"ACGTN", np.uint8)[
            np.concatenate([c for _, c in s.contigs])].tobytes()


def test_seeds_do_the_same_work(tmp_path):
    """Sizes are fixed sets in a seeded order: totals barely move."""
    sizes = []
    for seed in (1, 2, -3, 2**40):
        inputs, _ = make("hpp-chr21x10.create", seed, tmp_path / str(seed))
        sizes.append([s.symbols for s in inputs.samples])
        assert sorted(len(s.contigs) for s in inputs.samples) == [2, 3, 4]
    sizes = np.array(sizes)
    assert np.ptp(sizes, axis=0).max() < 0.02 * sizes.min()


def test_hpp_rates(tmp_path):
    inputs, spec = make("hpp-chr21x10.create", 11, tmp_path, n_extra=2)
    g = spec.config["generator_params"]
    ref = inputs.reference.contigs[0][1]
    lead = g["reference"]["leading_n"]
    assert len(ref) == g["reference"]["length"]
    assert (ref[:lead] == N_CODE).all() and (ref[lead:] < 4).all()
    assert len(inputs.samples) == g["haplotypes"] and len(inputs.extra) == 2
    assert inputs.warmup == inputs.samples[:1]
    body = ref[lead:]
    for s in inputs.samples:
        seqs = [c for _, c in s.contigs]
        assert min(map(len, seqs)) >= g["min_contig"]
        n = np.concatenate(seqs)
        assert 0 < (n == N_CODE).sum() <= g["gaps"] * g["gap_length"]  # gaps may overlap
        # insertions and deletions balance: the length stays near the body's
        assert abs(len(n) - len(body)) < 0.02 * len(body)
    # orientation: about half the contigs are reverse-complemented; an
    # unflipped contig shares its first 31-mer with the reference
    heads = {body[i : i + 31].tobytes() for i in range(len(body) - 30)}
    direct = [c[:31].tobytes() in heads for s in inputs.samples for _, c in s.contigs]
    assert 0 < sum(direct) < len(direct)


def test_hpp_snp_rate(tmp_path):
    """A haplotype's first contig, read in its own orientation against the
    reference: mismatches near one per ``snp_every`` before the first indel."""
    spec = tiny("hpp-chr21x10.create")
    gen = harness.load("gen", "hpp")
    g = dict(spec.config["generator_params"], indel_every=10**9, sv_every=10**9,
             gaps=0, contigs=[1, 1], revcomp_share=0.0)
    inputs = gen.make(g, 5, str(tmp_path), 0)
    body = inputs.reference.contigs[0][1][g["reference"]["leading_n"]:]
    hap = inputs.samples[0].contigs[0][1]
    diff = (hap != body).sum()
    expect = len(body) // g["snp_every"]
    assert 0.9 * expect < diff <= expect


def test_viral_rates(tmp_path):
    inputs, spec = make("sars-cov-2-1k.create", 3, tmp_path)
    g = spec.config["generator_params"]
    genomes = inputs.samples[0].contigs
    assert len(genomes) == g["genomes"]
    assert len(inputs.warmup[0].contigs) == g["warmup_genomes"]
    with_n = sum((c == N_CODE).any() for _, c in genomes)
    assert with_n == round(g["n_run_share"] * g["genomes"])
    ref_len = g["reference_length"]
    t_hi = g["trim"][1]
    longest_del = max(g["lineage_deletions"]) * g["deletion_length"][1]
    for _, c in genomes:
        assert ref_len - 2 * t_hi - longest_del <= len(c) <= ref_len
    assert len({h for h, _ in genomes}) == len(genomes)
