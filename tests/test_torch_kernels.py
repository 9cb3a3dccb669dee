"""The port's k-mer programs (kernels' plain versions on the CPU) against
agc_tpu's JAX programs on the same inputs. Integer outputs must be equal:
no tolerance.

- kmer_canon  vs kmer_core_via_pallas (Pallas, interpret mode) and
  canon_rows_p4;
- scan_fused  vs scan_fused_pallas (interpret mode) at hits, and vs
  scan_batch_compact_p4's decoded hit vectors, including a cap overflow;
- the large-table join (dir_mix + member_mix) vs scan_batch_join_global_p4,
  with fills and with a cap overflow;
- member_mix vs member_mix_pallas (interpret mode); dir_mix vs _dir_halves;
- greedy_walk (through find_splitter_emissions_packed) vs
  find_splitter_emissions_from_chunks / _batched / _packed;
- the port's ScanBatcher vs the exact host scan.
Inputs are made with numpy from a seed: random, poly-A and N-run content.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agc_tpu.ops import kmers as JK
from agc_tpu.ops.pallas_kmers import (
    kmer_core_via_pallas,
    member_mix_pallas,
    scan_fused_pallas,
)
from agc_tpu_torch.ops import cuda_kmers as CK
from agc_tpu_torch.ops import kmers as TK
from agc_tpu_torch.ops import u64

KS = [15, 17, 21, 31, 32]


def _chunk(seed: int, n: int = 4096) -> np.ndarray:
    """Random bases with a poly-A run, N runs and scattered invalid
    symbols."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=n, dtype=np.uint8)
    c[n // 8 : n // 8 + 300] = 0  # poly-A
    c[n // 2 : n // 2 + 40] = 4  # N run
    c[rng.integers(0, n, 12)] = 4
    c[3 * n // 4 : 3 * n // 4 + 5] = 9  # other IUPAC code
    return c


def _packed(rows) -> torch.Tensor:
    return torch.from_numpy(np.stack([TK.pack4_np(r) for r in rows]))


def _jax_canon(udir, urc, valid):
    canon = np.minimum(np.asarray(udir), np.asarray(urc))
    return np.where(np.asarray(valid), canon, np.uint64(0xFFFFFFFFFFFFFFFF))


@pytest.mark.parametrize("k", KS)
def test_kmer_canon_plain_matches_pallas_and_canon_rows(k):
    rows = [_chunk(k), np.zeros(4096, np.uint8), _chunk(k + 100)]
    got = u64.to_u64(CK.kmer_canon_plain(_packed(rows), k))
    pallas = _jax_canon(*kmer_core_via_pallas(jnp.asarray(rows[0]), k, interpret=True))
    assert np.array_equal(got[0], pallas)
    mat = np.stack([TK.pack4_np(r) for r in rows])
    want = np.asarray(JK.canon_rows_p4(jnp.asarray(mat), k))
    assert np.array_equal(got, want)
    # the wrapper on a CPU tensor takes the plain version
    assert np.array_equal(u64.to_u64(CK.kmer_canon(_packed(rows), k)), want)


def _table_pair(codes, k, n_splitters):
    """The same splitter set as agc_tpu and port ScanTables."""
    ud, ur, v = JK.dir_rc_kmers_np(codes, k)
    canon = np.unique(np.minimum(ud, ur)[v])
    step = max(1, len(canon) // n_splitters)
    pick = np.sort(canon[::step][:n_splitters])
    return JK.make_scan_table(pick, k), TK.make_scan_table(pick, k, "cpu")


@pytest.mark.parametrize("k", KS)
def test_scan_fused_plain_matches_pallas_at_hits(k):
    codes = _chunk(7 * k)
    jt, tt = _table_pair(codes, k, 40)
    assert jt.kind == tt.kind == "cmp"
    _dlo, _dhi, member = scan_fused_pallas(jnp.asarray(codes), k, jt.tlo, True)
    hits = np.flatnonzero(np.asarray(member))
    assert len(hits) >= 40
    vec = u64.to_u32(CK.scan_fused_plain(_packed([codes]), k, tt.tmix, 4096))[0]
    count = int(vec[0])
    cap = 4096
    assert count == len(hits)
    assert np.array_equal(vec[1 + cap - count : 1 + cap], hits)
    for off, half in ((cap, _dlo), (2 * cap, _dhi)):
        assert np.array_equal(
            vec[1 + off + cap - count : 1 + off + cap], np.asarray(half)[hits]
        )


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_splitters,cap", [(30, 256), (8192, 256), (60, 8)])
def test_scan_batch_compact_matches_jax(k, n_splitters, cap):
    rows = [_chunk(k), _chunk(k + 1), np.zeros(4096, np.uint8)]
    rows[1][:2000] = rows[0][:2000]  # shared content: hits in two rows
    jt, tt = _table_pair(np.concatenate(rows), k, n_splitters)
    assert jt.kind == "cmp"
    mat = np.stack([TK.pack4_np(r) for r in rows])
    want = np.asarray(JK.scan_batch_compact_p4(jnp.asarray(mat), k, jt.tlo, cap))
    got = u64.to_u32(TK.scan_batch_compact_p4(torch.from_numpy(mat), k, tt.tmix, cap))
    assert np.array_equal(got[:, 0], want[:, 0])  # exact counts
    if cap == 8:
        assert want[:2, 0].min() > cap  # the overflow case overflows
    for r in range(len(rows)):
        a = TK._decode_scan_vec(got[r], cap, tt)
        b = JK._decode_scan_vec(want[r], cap, jt)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("k", KS)
def test_scan_join_matches_jax(k):
    rows = [_chunk(k, 8192), _chunk(k + 3, 8192)]
    jt, tt = _table_pair(np.concatenate(rows), k, 9000)
    assert jt.kind == tt.kind == "join"
    mat = np.stack([TK.pack4_np(r) for r in rows])
    for cap_total in (16384, 2048, 16):
        want = np.asarray(
            JK.scan_batch_join_global_p4(jnp.asarray(mat), k, jt.thi, jt.tlo, cap_total)
        )
        got = u64.to_u32(
            TK.scan_batch_join_global_p4(torch.from_numpy(mat), k, tt.tmix, cap_total)
        )
        assert np.array_equal(got, want)
        if cap_total < 16384:
            assert want[0] > cap_total  # the last cap_total members kept
        else:
            assert 0 < want[0] < cap_total  # leading fills: gpos -1, halves of 0
            assert want[1] == 0xFFFFFFFF and want[1 + cap_total] == got[1 + cap_total]


@pytest.mark.parametrize("k", [17, 31])
def test_dir_mix_plain_matches_dir_halves(k):
    """dir_mix's plain version equals agc_tpu's _dir_halves at every
    position, invalid ones included (the join's fills read position 0)."""
    rows = [_chunk(k, 2048), _chunk(k + 5, 2048)]
    dlo, dhi, valid = CK.dir_mix(_packed(rows), k)
    for r, codes in enumerate(rows):
        wl, wh, wv = JK._dir_halves(jnp.asarray(codes), k)
        assert np.array_equal(u64.to_u32(dlo[r]), np.asarray(wl))
        assert np.array_equal(u64.to_u32(dhi[r]), np.asarray(wh))
        assert np.array_equal(valid[r].numpy(), np.asarray(wv))


@pytest.mark.parametrize("seed", [5, 6])
def test_member_mix_plain_matches_pallas(seed):
    """member_mix against member_mix_pallas (interpret mode), as
    tests/test_pallas_kmers.py runs it: a table with padding entries and
    mixes with bit 31 set."""
    rng = np.random.default_rng(seed)
    mix = rng.integers(0, 1 << 32, 2048, dtype=np.int64).astype(np.uint32)
    mix[::3] |= np.uint32(1 << 31)
    mix[7] = 0xDEADBEEF  # equals the padding value
    tbl = np.unique(np.concatenate([mix[::37], rng.integers(0, 1 << 32, 40).astype(np.uint32)]))
    pad = np.full(128, 0xDEADBEEF, dtype=np.uint32)
    pad[: len(tbl)] = tbl[:128]
    want = np.asarray(member_mix_pallas(jnp.asarray(mix), jnp.asarray(pad), True))
    got = CK.member_mix(u64.from_u32(mix), u64.from_u32(np.sort(pad))).numpy()
    assert np.array_equal(got, want)
    assert got.sum() > 40 and got[7] and (mix[got] >= np.uint32(1 << 31)).any()


def _reference_contigs(seed, lens):
    """Contigs with repeated blocks, so the singleton walk has to skip."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        c = rng.integers(0, 4, size=n, dtype=np.uint8)
        if n > 6000:
            c[2000:3500] = c[500:2000]
            c[n - 900 : n - 100] = c[4000:4800]
            c[5000:5030] = 4
        out.append(c)
    return out


def _port_emissions(contigs, k, seg):
    canon, placements = TK.collect_kmers_device_packed(contigs, k, "cpu")
    pool = TK.sort_kmers(canon)
    return TK.find_splitter_emissions_packed(canon, placements, k, pool, seg)


def _assert_same_emissions(a, b):
    assert len(a) == len(b)
    for (p1, k1, t1, tk1), (p2, k2, t2, tk2) in zip(a, b):
        assert np.array_equal(p1, p2)
        assert np.array_equal(np.asarray(k1, np.uint64), np.asarray(k2, np.uint64))
        assert t1 == t2
        if t1 is not None:
            assert np.uint64(tk1) == np.uint64(tk2)


@pytest.mark.parametrize("k", KS)
def test_greedy_matches_jax_from_chunks_and_batched(k):
    contigs = _reference_contigs(k, [30000])
    seg = 700
    codes = contigs[0]
    recs = JK.collect_kmers_device(codes, k)
    pool = JK.sort_kmers(jnp.concatenate([r[0] for r in recs]))
    want = JK.find_splitter_emissions_from_chunks(recs, len(codes), k, pool, seg)
    got = _port_emissions(contigs, k, seg)
    assert len(want[0]) > 10
    _assert_same_emissions(got, [want])
    batched = JK.find_splitter_emissions_batched([recs], [len(codes)], k, pool,
                                                 seg, singleton=True)
    _assert_same_emissions(got, batched)


@pytest.mark.parametrize("k", [17, 31])
def test_greedy_matches_jax_packed_many_contigs(k):
    contigs = _reference_contigs(100 + k, [9000, 20, 7000, 40, 12000])
    contigs[3][:] = contigs[0][:40]  # a duplicated short contig
    seg = 500
    canon_flat, placements = JK.collect_kmers_device_packed(contigs, k)
    pool = JK.sort_kmers(canon_flat)
    want = JK.find_splitter_emissions_packed(canon_flat, placements, k, pool,
                                             seg, singleton=True)
    _assert_same_emissions(_port_emissions(contigs, k, seg), want)


@pytest.mark.parametrize("table_kind", ["cmp", "join"])
def test_scan_batcher_matches_exact_host_scan(table_kind):
    k = 21
    rng = np.random.default_rng(9)
    contigs = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (50000, 3000, 700, 12)]
    contigs[1][100:130] = 4
    ud, ur, v = TK.dir_rc_kmers_np(contigs[0], k)
    canon = np.unique(np.minimum(ud, ur)[v])
    # dense hits overflow the 256-hit row cap and force a retry
    pick = canon[::4] if table_kind == "cmp" else canon[::3]
    pick = np.sort(pick[:8192] if table_kind == "cmp" else pick)
    table = TK.make_scan_table(pick, k, "cpu")
    assert table.kind == table_kind
    batcher = TK.ScanBatcher(k, table)
    tokens = [batcher.add(c) for c in contigs]
    batcher.flush()
    for c, tok in zip(contigs, tokens):
        got = batcher.collect(tok)
        want = TK.scan_members_host(c, k, table)
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
    assert len(want[0]) == 0 and len(TK.scan_members_host(contigs[0], k, table)[0]) > 256
