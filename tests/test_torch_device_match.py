"""The estimate prepass, the split search and -f's shortlist of
agc_tpu_torch's engine against agc_tpu's, on the CPU (the port's plain
versions, agc_tpu's XLA programs): archives equal part for part.

agc_tpu's default ``AGC_TPU_DEVICE_MATCH=auto`` runs the batched estimate
prepass on a contig whose one-splitter searches reach
``_DEVICE_MATCH_MIN_SYMS`` pair-symbols; its shortlist decides which
candidates the host estimates exactly, so it can change archive bytes.
The gate is read from the environment when the class is defined, so
these tests lower the class attribute on both engines.
"""

import random

import numpy as np
import pytest

from agc_tpu.core import compressor as tpu_comp
from agc_tpu_torch.core import compressor as port_comp
from agc_tpu_torch.ops import match as M
from agc_tpu_torch.ops.kmers import canon_kmers_np

from test_torch_create import _tpu_params, assert_same_archive, tpu_append
from util import mutate as mutate_str
from util import random_seq, write_fa

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _wfa(path, contigs):
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n" + ALPHA[seq].tobytes() + b"\n")


def _mutate(rng, seq, rate=0.002, cut=None):
    m = seq.copy()
    pos = rng.integers(0, len(m), size=max(1, int(len(m) * rate)))
    m[pos] = (m[pos] + rng.integers(1, 4, size=len(pos))) % 4
    if cut:
        m = np.concatenate([m[: cut[0]], m[cut[1] :]])
    return m


def _splitter_positions(ref_path, codes, params):
    """Positions (window ends) of the reference's splitters, ascending."""
    comp = port_comp.Compressor(ref_path + ".probe.agc", params, reference_file=ref_path,
                                device="cpu")
    splitters = comp.splitter_set_snapshot()
    comp.abort()
    canon, valid = canon_kmers_np(codes, params.kmer_length)
    return [int(p) for p in np.flatnonzero(valid) if int(canon[p]) in splitters]


def _workload(tmp_path, n=200_000, n_samples=4, seed=41, segment_size=8000):
    """A reference contig and samples with deletions and truncated ends.
    Around a few splitters s_a, samples delete s_a+1, then s_a+1 and s_a+2,
    so s_a has four terminators; others end just after s_a, so their tail
    segment's one-splitter search has those four candidates."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=n, dtype=np.uint8)
    files = [str(tmp_path / "ref.fa")]
    _wfa(files[0], [("c1", ref)])
    pos = _splitter_positions(files[0], ref, port_comp.CompressorParams(
        segment_size=segment_size))
    anchors = pos[2:-4:4][:4]
    seqs = {}
    for i in range(n_samples):
        m = _mutate(rng, ref)
        contigs = [("c1", m)]
        if i % 2 == 0:  # deletions of one, then two splitters after each anchor
            drop = np.zeros(n, dtype=bool)
            for j, a in enumerate(anchors):
                nxt = pos[pos.index(a) + 1 : pos.index(a) + 2 + (j + i // 2) % 2]
                for p in nxt:
                    drop[p - 60 : p + 20] = True
            contigs = [("c1", m[~drop])]
        else:  # pieces ending just after an anchor
            contigs += [(f"t{j}", m[max(0, a - 30_000 + 1000 * i) : a + 500])
                        for j, a in enumerate(anchors)]
        files.append(str(tmp_path / f"s{i}.fa"))
        _wfa(files[-1], contigs)
        seqs[f"s{i}"] = contigs
    return files, seqs


def _create(mod, out, files, params, **kw):
    """Create through a package's Compressor; returns its stage timers."""
    comp = mod.Compressor(out, params, reference_file=files[0], **kw)
    try:
        comp.add_sample_files([(mod.sample_name_from_path(f), f) for f in files])
        comp.close()
    except BaseException:
        comp.abort()
        raise
    return comp.timers


def _both(tmp_path, files, params):
    """The same create through agc_tpu and the port (device='cpu'); the
    archives must be equal. Returns both engines' device_match units."""
    ours, ref = str(tmp_path / "port.agc"), str(tmp_path / "tpu.agc")
    t_port = _create(port_comp, ours, files, params, device="cpu")
    t_tpu = _create(tpu_comp, ref, files, _tpu_params(params))
    assert_same_archive(ours, ref)
    return t_port.units["device_match"], t_tpu.units["device_match"]


@pytest.fixture
def low_gate(monkeypatch):
    """Lower the auto gate on both engines (the variable stays unset)."""
    monkeypatch.delenv("AGC_TPU_DEVICE_MATCH", raising=False)
    monkeypatch.delenv("AGC_TPU_DEVICE_SPLIT", raising=False)
    monkeypatch.setattr(port_comp.Compressor, "_DEVICE_MATCH_MIN_SYMS", 1 << 10)
    monkeypatch.setattr(tpu_comp.Compressor, "_DEVICE_MATCH_MIN_SYMS", 1 << 10)


def test_default_gate_runs_the_prepass_as_agc_tpu(tmp_path, low_gate, monkeypatch):
    """Under the default auto mode, with the gate lowered, both engines run
    the estimate prepass and write equal archives; the shortlist pruned
    candidates in the port's run."""
    files, _ = _workload(tmp_path)
    pruned = []
    real = M.shortlist

    def spy(ests, margin, extra):
        keep = real(ests, margin, extra)
        pruned.append(len(ests) - len(keep))
        return keep

    monkeypatch.setattr(M, "shortlist", spy)
    port_units, tpu_units = _both(tmp_path, files, port_comp.CompressorParams(segment_size=8000))
    assert port_units > 0 and port_units == tpu_units
    assert pruned and max(pruned) > 0


def test_gate_not_reached_runs_no_prepass(tmp_path, monkeypatch):
    monkeypatch.delenv("AGC_TPU_DEVICE_MATCH", raising=False)
    files, _ = _workload(tmp_path, n_samples=2)
    assert _both(tmp_path, files, port_comp.CompressorParams(segment_size=8000)) == (0, 0)


def test_forced_device_match(tmp_path, monkeypatch):
    """AGC_TPU_DEVICE_MATCH=1: the prepass and the split search on every
    contig."""
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "1")
    files, _ = _workload(tmp_path, seed=42)
    port_units, tpu_units = _both(tmp_path, files, port_comp.CompressorParams(segment_size=8000))
    assert port_units > 0 and port_units == tpu_units


def test_device_split_opt_in(tmp_path, low_gate, monkeypatch):
    """AGC_TPU_DEVICE_SPLIT=1 under auto: the split search where 2n clears
    the gate."""
    monkeypatch.setenv("AGC_TPU_DEVICE_SPLIT", "1")
    calls = []
    real = M.split_point_device

    def spy(*args):
        calls.append(real(*args))
        return calls[-1]

    monkeypatch.setattr(M, "split_point_device", spy)
    files, _ = _workload(tmp_path, seed=43)
    port_units, tpu_units = _both(tmp_path, files, port_comp.CompressorParams(segment_size=8000))
    assert port_units == tpu_units
    assert [c for c in calls if c is not None]


def test_device_match_off(tmp_path, low_gate, monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")
    files, _ = _workload(tmp_path, n_samples=2, seed=44)
    assert _both(tmp_path, files, port_comp.CompressorParams(segment_size=8000)) == (0, 0)


def _fallback_workload(tmp_path):
    """-f input with segments over 10000 (short segments never estimate):
    a sample with a deletion and heavily mutated pieces whose splitter
    k-mers are gone, so the fallback votes rank several groups."""
    rng = random.Random(5)
    base = random_seq(rng, 120000)
    files = [str(tmp_path / f"{x}.fa") for x in "rst"]
    write_fa(files[0], [("c1", base)])
    write_fa(files[1], [("c1", mutate_str(rng, base[:40000] + base[52000:], 60, 6))])
    write_fa(files[2], [(f"p{i}", mutate_str(rng, base[s : s + 9000], 450, 1))
                        for i, s in enumerate(range(1000, 110000, 4500))])
    return files


def test_fallback_shortlist(tmp_path, monkeypatch):
    """-f under the forced prepass: _find_cand_fallback's device shortlist
    ranks the pruned candidate groups."""
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "1")
    files = _fallback_workload(tmp_path)
    ranked = []
    real = port_comp.Compressor._find_cand_fallback

    def spy(self, segment, max_val):
        before = self.timers.units["device_match"]
        out = real(self, segment, max_val)
        ranked.append(self.timers.units["device_match"] > before)
        return out

    monkeypatch.setattr(port_comp.Compressor, "_find_cand_fallback", spy)
    params = port_comp.CompressorParams(fallback_frac=0.2, kmer_length=17, segment_size=12000,
                                        min_match_len=15)
    _both(tmp_path, files, params)
    assert any(ranked)


def test_device_match_append_packed_groups(tmp_path, monkeypatch):
    """Appending reads groups packed: their references are unavailable, so
    they estimate as 0 and give no split, in both engines."""
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "1")
    files, seqs = _workload(tmp_path, n_samples=3, seed=45)
    params = port_comp.CompressorParams(segment_size=8000)
    base_p, base_t = str(tmp_path / "bp.agc"), str(tmp_path / "bt.agc")
    _create(port_comp, base_p, files, params, device="cpu")
    _create(tpu_comp, base_t, files, _tpu_params(params))
    assert_same_archive(base_p, base_t)
    rng = np.random.default_rng(99)
    extra = _mutate(rng, seqs["s0"][0][1], cut=(50_000, 58_000))[3000:]
    x = str(tmp_path / "x.fa")
    _wfa(x, [("c1", extra)])
    out_p, out_t = str(tmp_path / "ap.agc"), str(tmp_path / "at.agc")
    port_comp.append_archive(base_p, out_p, [x], params, device="cpu")
    tpu_append(base_t, out_t, [x], _tpu_params(params))
    assert_same_archive(out_p, out_t)
    from agc_tpu_torch.core import Decompressor

    d = Decompressor(out_p)
    try:
        assert d.get_contig_seq("x", "c1") == ALPHA[extra].tobytes()
    finally:
        d.close()


def test_prepass_error_surfaces(tmp_path, low_gate, monkeypatch):
    """An error of the prepass job is raised where a segment consumes its
    hint, not swallowed."""
    def broken(*_a, **_k):
        raise RuntimeError("estimate failed")

    monkeypatch.setattr(M, "estimate_batch", broken)
    files, _ = _workload(tmp_path, n_samples=2, seed=46)
    out = tmp_path / "x.agc"
    with pytest.raises(RuntimeError, match="estimate failed"):
        port_comp.create_archive(str(out), files, port_comp.CompressorParams(segment_size=8000),
                                 device="cpu")
    assert not out.exists()
