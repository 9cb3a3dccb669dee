"""The port's match layer (agc_tpu_torch/ops/match.py, ops/cuda_match.py)
against agc_tpu's (agc_tpu/ops/match.py) on the CPU: the same numpy inputs
through both, every output an integer, tolerance 0.

Mirrors tests/test_match_device.py's cases (estimates against the numpy
twin and agc_tpu's estimate_batch, rc orientation, bucket mixes, LRU
eviction, duplicate gids, packed groups, stride validation, split points),
plus the pieces: slot tables against _ref_index_kernel, segment rows
against _seg_rows_kernel / _seg_rows_strided_kernel, and
match_estimate_plain (the CUDA kernel's plain version) against
_estimate_kernel on hard cases.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agc_tpu.core.lz import LZDiff
from agc_tpu.ops import match as JM
from agc_tpu_torch.ops import cuda_match as cm
from agc_tpu_torch.ops import match as M

jax.config.update("jax_enable_x64", True)


def _rand_seq(rng, n):
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def _mutate(rng, seq, rate):
    out = seq.copy()
    n_sub = max(1, int(len(seq) * rate))
    pos = rng.integers(0, len(seq), size=n_sub)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    return out


def _rc(seq):
    out = seq[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def _both_ests(queries, refs, key_len=17, budget=None):
    """The same queries through agc_tpu's and the port's estimate_batch;
    returns the port's queries after checking the estimates are equal."""
    provider = (lambda g: None if refs.get(g) is None else refs[g].tobytes())
    jq = [JM.MatchQuery(q.codes, q.cands) for q in queries]
    JM.estimate_batch(jq, JM.RefBank(key_len, budget_bytes=budget), provider)
    M.estimate_batch(queries, M.RefBank(key_len, budget_bytes=budget, device="cpu"), provider)
    for a, b in zip(jq, queries):
        assert a.ests.tolist() == b.ests.tolist()
    return queries


def _device_est(seg, ref, key_len, use_rc=False):
    q = M.MatchQuery(seg, [(7, use_rc)])
    _both_ests([q], {7: ref}, key_len)
    return int(q.ests[0])


def _packed(rows, b):
    mat = np.full((len(rows), b), 255, dtype=np.uint8)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    return JM.pack4_np(mat.reshape(-1)).reshape(len(rows), b // 2)


def test_device_estimate_matches_numpy_twin():
    rng = np.random.default_rng(0)
    key_len = 17
    for trial in range(4):
        ref = _rand_seq(rng, 3000 + 117 * trial)
        seg = _mutate(rng, ref, 0.01)
        if trial == 2:  # sprinkle Ns
            seg[100:130] = 4
        if trial == 3:
            seg = seg[200:2500]
        dev = _device_est(seg, ref, key_len)
        assert dev == M.estimate_np(seg, ref, key_len) == JM.estimate_np(seg, ref, key_len)


def test_rc_orientation_matches_direct_of_rc():
    rng = np.random.default_rng(1)
    key_len = 17
    ref = _rand_seq(rng, 2500)
    seg = _mutate(rng, ref, 0.005)
    assert _device_est(seg, ref, key_len, use_rc=True) == _device_est(_rc(seg), ref, key_len)


def test_ranking_matches_exact_estimator():
    """The port's device ranking equals agc_tpu's and agrees with the
    exact host walk on clearly separated candidates."""
    rng = np.random.default_rng(2)
    base = _rand_seq(rng, 20000)
    seg = _mutate(rng, base, 0.002)
    cands = [
        _mutate(rng, base, 0.001),
        _mutate(rng, base, 0.02),
        _rand_seq(rng, 20000),
        np.concatenate([base[10000:], base[:10000]]),
    ]
    q = M.MatchQuery(seg, [(i, False) for i in range(len(cands))])
    _both_ests([q], dict(enumerate(cands)))
    exact = []
    for c in cands:
        lz = LZDiff(min_match_len=20)
        lz.prepare(c.tobytes())
        exact.append(lz.estimate(seg.tobytes()))
    assert int(np.argmin(q.ests)) == int(np.argmin(exact))
    assert q.ests[2] == max(q.ests)
    keep = M.shortlist(q.ests, margin=0.25, extra=1)
    assert keep == JM.shortlist(q.ests, margin=0.25, extra=1)
    assert int(np.argmin(exact)) in keep


def test_batch_multiple_queries_and_bucket_mix():
    rng = np.random.default_rng(3)
    key_len = 17
    refs = {0: _rand_seq(rng, 1800), 1: _rand_seq(rng, 9000)}  # two slot widths
    queries = []
    for i in range(3):
        seg = _mutate(rng, refs[i % 2], 0.01)
        queries.append(M.MatchQuery(seg, [(0, False), (1, True), (1, False)]))
    # a segment of another length bucket in the same batch
    queries.append(M.MatchQuery(_rand_seq(rng, 20000), [(0, False), (1, False)]))
    _both_ests(queries, refs)
    for i, q in enumerate(queries[:3]):
        assert int(np.argmin(q.ests)) == (0 if i % 2 == 0 else 2)
        assert q.ests[0] == M.estimate_np(q.codes, refs[0], key_len)
        assert q.ests[2] == M.estimate_np(q.codes, refs[1], key_len)


def test_refbank_eviction_and_reuse():
    rng = np.random.default_rng(4)
    bank = M.RefBank(17, budget_bytes=80_000, device="cpu")
    refs = {i: _rand_seq(rng, 4000) for i in range(12)}
    for i in range(12):
        assert bank.get(i, lambda g=i: refs[g].tobytes()) is not None
    assert len(bank) < 12
    assert bank.get(0, lambda: refs[0].tobytes()) is not None
    # short, None and too long references are refused
    assert bank.get(99, lambda: None) is None
    assert bank.get(98, lambda: b"\x00" * 4) is None
    assert bank.get(97, lambda: b"\x00" * 20) is None  # below key_len + 4
    ta, tb, h = bank.get(96, lambda: b"\x00" * 21)
    assert h == 1024 and ta.shape == tb.shape == (1024,)


def test_refbank_eviction_under_estimate_pressure():
    """Estimates stay equal to agc_tpu's and the twin while the bank
    budget evicts consolidated rows between dispatches."""
    rng = np.random.default_rng(7)
    key_len = 17
    refs = {i: _rand_seq(rng, 4000) for i in range(10)}
    bank = M.RefBank(key_len, budget_bytes=150_000, device="cpu")
    jbank = JM.RefBank(key_len, budget_bytes=150_000)
    for round_no in range(3):
        for lo in range(0, 10, 2):
            gids = [lo, lo + 1]
            seg = _mutate(rng, refs[lo], 0.01)
            q = M.MatchQuery(seg, [(g, False) for g in gids])
            jq = JM.MatchQuery(seg, q.cands)
            M.estimate_batch([q], bank, lambda g: refs[g].tobytes())
            JM.estimate_batch([jq], jbank, lambda g: refs[g].tobytes())
            twin = [M.estimate_np(seg, refs[g], key_len) for g in gids]
            assert q.ests.tolist() == jq.ests.tolist() == twin, (round_no, lo)
    assert len(bank) < 10
    assert len(bank) == len(jbank)


def test_refbank_duplicate_gids_one_row():
    rng = np.random.default_rng(8)
    key_len = 17
    ref = _rand_seq(rng, 3000)
    bank = M.RefBank(key_len, device="cpu")
    queries = [M.MatchQuery(_mutate(rng, ref, 0.01), [(5, False)]) for _ in range(6)]
    M.estimate_batch(queries, bank, lambda g: ref.tobytes())
    m, _row = bank._row_of[5]
    assert len(bank._built[m][1]) == 1
    for q in queries:
        assert int(q.ests[0]) == M.estimate_np(q.codes, ref, key_len)


def test_refbank_concurrent_estimates():
    """The prepass worker and the matcher share one bank: estimates made
    from more threads than cores at once, under a budget that evicts all
    the time, equal those of one thread with a fresh bank."""
    rng = np.random.default_rng(11)
    refs = {i: _rand_seq(rng, 3000 + 2000 * (i % 3)) for i in range(12)}
    segs = [_mutate(rng, refs[i % 12], 0.01) for i in range(24)]
    cands = [[(g, bool(g % 2)) for g in range(12) if (g + i) % 3 == 0] for i in range(24)]

    def provider(g):
        return refs[g].tobytes()

    want = []
    for seg, c in zip(segs, cands):
        q = M.MatchQuery(seg, c)
        M.estimate_batch([q], M.RefBank(17, device="cpu"), provider)
        want.append(q.ests.tolist())
    bank = M.RefBank(17, budget_bytes=300_000, device="cpu")
    got, errors = [None] * len(segs), []

    def work(ixs):
        try:
            for i in ixs:
                q = M.MatchQuery(segs[i], cands[i])
                M.estimate_batch([q], bank, provider)
                got[i] = q.ests.tolist()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(range(t, len(segs), 8),))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert got == want


def test_probe_stride_validation(monkeypatch):
    for bad, kl in (("6", None), ("20", 17), ("x", None), ("0", None)):
        monkeypatch.setenv("AGC_TPU_MATCH_STRIDE", bad)
        with pytest.raises(ValueError):
            M.probe_stride(key_len=kl)
        with pytest.raises(ValueError):
            JM.probe_stride(key_len=kl)
    monkeypatch.setenv("AGC_TPU_MATCH_STRIDE", "8")
    assert M.probe_stride(key_len=17) == JM.probe_stride(key_len=17) == 8


@pytest.mark.parametrize("stride", ["8", "16"])
def test_estimates_at_wider_strides(monkeypatch, stride):
    monkeypatch.setenv("AGC_TPU_MATCH_STRIDE", stride)
    rng = np.random.default_rng(9)
    refs = {0: _rand_seq(rng, 5000), 1: _rand_seq(rng, 5000)}
    seg = _mutate(rng, refs[1], 0.01)
    q = M.MatchQuery(seg, [(0, False), (1, False), (1, True)])
    _both_ests([q], refs, key_len=20)
    assert q.ests[1] == M.estimate_np(seg, refs[1], 20)


def test_split_point_matches_numpy_twin():
    rng = np.random.default_rng(6)
    key_len = 17
    left = _rand_seq(rng, 4000)
    right = _rand_seq(rng, 4000)
    for o1_rc, o2_rc in [(False, False), (True, False), (False, True), (True, True)]:
        seg = np.concatenate([_mutate(rng, left, 0.005)[:3000],
                              _mutate(rng, right, 0.005)[:3000]])
        refs = {1: _rc(left) if o1_rc else left, 2: _rc(right) if o2_rc else right}
        provider = lambda g: refs[g].tobytes()  # noqa: E731
        dev = M.split_point_device(seg, M.RefBank(key_len, device="cpu"),
                                   1, o1_rc, 2, o2_rc, provider)
        want = JM.split_point_device(seg, JM.RefBank(key_len), 1, o1_rc, 2, o2_rc, provider)
        twin = M.split_point_np(seg, refs[1], o1_rc, refs[2], o2_rc, key_len)
        assert dev == want == twin, (o1_rc, o2_rc, dev, want, twin)
        assert abs(dev - 3000) < 200, (o1_rc, o2_rc, dev)
    # a packed group (no reference codes) gives no split
    assert M.split_point_device(seg, M.RefBank(key_len, device="cpu"), 1, False, 2, False,
                                lambda g: None) is None


def test_packed_group_scores_zero():
    rng = np.random.default_rng(5)
    seg = _rand_seq(rng, 2000)
    ref = _rand_seq(rng, 2000)
    q = M.MatchQuery(seg, [(0, False), (1, False)])
    _both_ests([q], {0: None, 1: ref})
    assert q.ests[0] == 0 and q.ests[1] > 0


@pytest.mark.parametrize("key_len", [16, 17, 29])
def test_slot_tables_match_ref_index_kernel(key_len):
    rng = np.random.default_rng(key_len)
    for n in (21, 2048, 9000, 33000):
        ref = _rand_seq(rng, n)
        ref[rng.integers(0, n, n // 50)] = 4
        b = M._pow4(n, 2048)
        log2_h = (b // 4 * 2).bit_length() - 1
        packed = _packed([ref], b)
        jta, jtb = (np.asarray(x) for x in JM._ref_index_kernel(jnp.asarray(packed[0]), key_len,
                                                                 log2_h))
        ta, tb = M.ref_slot_tables(torch.from_numpy(packed), key_len, log2_h)
        np.testing.assert_array_equal(ta[0].numpy(), jta)
        np.testing.assert_array_equal(tb[0].numpy(), jtb)
        nta, ntb, _ = M.build_slot_tables_np(ref, key_len)
        np.testing.assert_array_equal(ta[0].numpy(), nta)
        np.testing.assert_array_equal(tb[0].numpy(), ntb)


@pytest.mark.parametrize("key_len,stride", [(16, 4), (17, 4), (17, 8), (17, 16), (29, 8)])
def test_segment_rows_match_agc_tpu(key_len, stride):
    """Full-resolution and strided rows of both orientations, segments of
    several true lengths (one shorter than key_len, one all N) in one
    bucket."""
    rng = np.random.default_rng(100 + key_len + stride)
    b = 4096
    lens = np.array([4096, 3001, key_len - 1, 700, 0], dtype=np.int32)
    rows = []
    for n in lens:
        r = _rand_seq(rng, int(n))
        r[rng.integers(0, max(1, n), max(1, n // 40))[: int(n)]] = 4
        rows.append(r)
    rows[3][:] = 4
    packed = _packed(rows, b)
    jk, ja, ji = (np.asarray(x) for x in JM._seg_rows_kernel(jnp.asarray(packed),
                                                              jnp.asarray(lens), key_len))
    tk, ta, ti = M.seg_rows(torch.from_numpy(packed), torch.from_numpy(lens), key_len)
    np.testing.assert_array_equal(tk.numpy(), jk.view(np.int64))
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(ti.numpy(), ji)
    got = M.seg_rows_strided(torch.from_numpy(packed), torch.from_numpy(lens), key_len, stride)
    want = JM._seg_rows_strided_kernel(jnp.asarray(packed), jnp.asarray(lens), key_len, stride)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.view(np.int64) if w.dtype == np.uint64 else w)


def _hard_estimate_case(rng, key_len, stride, t, tile=256):
    """Inputs of one estimate dispatch with its edges forced: a one-row and
    a several-row bank (the last matrix row used), rows that are all
    invalid, hits in the first and last probe block, and a run that starts
    right after a tile boundary of the kernel."""
    n_refs = 3
    b = M._pow4(4 * t, 2048)
    log2_h = (b // 4 * 2).bit_length() - 1
    refs = [_rand_seq(rng, int(rng.integers(2 * key_len, b))) for _ in range(n_refs)]
    bank = cm.slot_bank(*M.ref_slot_tables(torch.from_numpy(_packed(refs, b)), key_len, log2_h))
    ref_keys = M._start_keys(torch.from_numpy(_packed(refs, b)), key_len)[:, ::4]
    pool = ref_keys[ref_keys != -1]
    first = ref_keys[0][ref_keys[0] != -1]  # keys of bank row 0
    q = 6
    keys = torch.from_numpy(rng.integers(0, 1 << (2 * key_len), (q, t)).astype(np.int64))
    take = torch.from_numpy(rng.random((q, t)) < 0.4)
    keys = torch.where(take, pool[torch.from_numpy(rng.integers(0, pool.numel(), (q, t)))], keys)
    keys[:, rng.random(t) < 0.05] = -1
    keys[1] = -1  # all invalid
    keys[2, 0] = keys[2, -1] = first[0]  # hits in the first and last block
    keys[3, tile - key_len // stride - 2 : tile] = -1  # no cover before the tile edge
    keys[3, tile] = first[1]  # a run starts right after it
    r = key_len % stride
    a_lo = torch.from_numpy(rng.integers(0, r + 1, (q, t)).astype(np.int32))
    a_hi = torch.from_numpy(rng.integers(0, stride - r + 1, (q, t)).astype(np.int32))
    nrun = torch.from_numpy(rng.integers(0, 40, q).astype(np.int32))
    p = 40
    rows = torch.from_numpy(rng.integers(0, q, p).astype(np.int32))
    cands = torch.from_numpy(rng.integers(0, n_refs, p).astype(np.int32))
    cands[-1] = n_refs - 1
    rows[:q] = torch.arange(q, dtype=torch.int32)
    cands[2] = cands[3] = 0
    return keys, a_lo, a_hi, nrun, rows, cands, bank


def _estimate_kernel(keys, a_lo, a_hi, nrun, rows, cands, bank, key_len, stride):
    """agc_tpu's _estimate_kernel on the same inputs, its two slot tables
    taken from the interleaved bank."""
    return np.asarray(JM._estimate_kernel(
        jnp.asarray(keys.numpy().view(np.uint64)), jnp.asarray(a_lo.numpy()),
        jnp.asarray(a_hi.numpy()), jnp.asarray(nrun.numpy()), jnp.asarray(rows.numpy()),
        jnp.asarray(cands.numpy()), jnp.asarray(bank[..., 0].numpy()),
        jnp.asarray(bank[..., 1].numpy()), key_len, stride))


def _scheduled(keys, a_lo, a_hi, nrun, rows, cands, bank, key_len, stride):
    """match_estimate as the kernel schedules it: the pairs in a stable
    sort by bank row, each estimate scattered back to its pair."""
    order = torch.sort(cands, stable=True).indices
    out = torch.empty(rows.numel(), dtype=torch.int64)
    out[order] = cm.match_estimate(keys, a_lo, a_hi, nrun, rows[order], cands[order], bank,
                                   key_len, stride)
    return out


@pytest.mark.parametrize("key_len,stride", [(16, 4), (17, 4), (17, 8), (17, 16), (16, 8)])
def test_match_estimate_plain_matches_estimate_kernel(key_len, stride):
    rng = np.random.default_rng(key_len * 100 + stride)
    args = _hard_estimate_case(rng, key_len, stride, t=600)
    keys, a_lo, a_hi, nrun, rows, cands, bank = args
    got = cm.match_estimate(*args, key_len, stride)  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), cm.match_estimate_plain(*args, key_len, stride))
    np.testing.assert_array_equal(got.numpy(), _estimate_kernel(*args, key_len, stride))
    np.testing.assert_array_equal(_scheduled(*args, key_len, stride).numpy(), got.numpy())
    # an all-invalid row: every ACGT symbol is a literal, no run
    assert (got[rows == 1] == a_lo[1].sum() + a_hi[1].sum() + nrun[1]).all()
    # a one-row bank
    one = (keys, a_lo, a_hi, nrun, rows, torch.zeros_like(cands), bank[:1].contiguous())
    np.testing.assert_array_equal(cm.match_estimate(*one, key_len, stride).numpy(),
                                  _estimate_kernel(*one, key_len, stride))


@pytest.mark.parametrize("case", ["repeats out of order", "one candidate", "one-row bank"])
@pytest.mark.parametrize("key_len,stride", [(17, 4), (16, 8)])
def test_match_estimate_schedule_matches_estimate_kernel(case, key_len, stride):
    """Pair lists that the kernel's bank-row schedule reorders: candidates
    that repeat out of order (runs broken up, the last row first), one
    candidate for every pair, and a one-row bank; scattered back, the
    estimates equal agc_tpu's _estimate_kernel pair for pair."""
    rng = np.random.default_rng(key_len * 10 + stride + len(case))
    keys, a_lo, a_hi, nrun, rows, cands, bank = _hard_estimate_case(rng, key_len, stride, t=700)
    n_refs = bank.shape[0]
    p = 96
    rows = torch.from_numpy(rng.integers(0, keys.shape[0], p).astype(np.int32))
    if case == "repeats out of order":
        cands = torch.from_numpy(np.tile([2, 0, 1, 0, 2, 2, 1], -(-p // 7))[:p].astype(np.int32))
        cands[0] = n_refs - 1
    elif case == "one candidate":
        cands = torch.full((p,), 1, dtype=torch.int32)
    else:
        cands = torch.zeros(p, dtype=torch.int32)
        bank = bank[1:2].contiguous()
    args = (keys, a_lo, a_hi, nrun, rows, cands, bank)
    want = _estimate_kernel(*args, key_len, stride)
    np.testing.assert_array_equal(_scheduled(*args, key_len, stride).numpy(), want)
    np.testing.assert_array_equal(cm.match_estimate(*args, key_len, stride).numpy(), want)


def test_match_estimate_rejects_bad_inputs():
    rng = np.random.default_rng(3)
    keys, a_lo, a_hi, nrun, rows, cands, bank = _hard_estimate_case(rng, 17, 4, t=300)
    with pytest.raises(ValueError, match="power of two"):
        cm.match_estimate(keys, a_lo, a_hi, nrun, rows, cands, bank[:, :-1], 17, 4)
    with pytest.raises(ValueError, match="int32"):
        cm.match_estimate(keys, a_lo, a_hi, nrun, rows.long(), cands, bank, 17, 4)
    with pytest.raises(ValueError, match="below"):
        cm.match_estimate(keys, a_lo, a_hi, nrun, rows, cands, bank, 17, 0)
    with pytest.raises(ValueError, match="H, 2"):
        cm.match_estimate(keys, a_lo, a_hi, nrun, rows, cands, bank[..., 0], 17, 4)


def estimate_kernel_model(keys, a_lo, a_hi, nrun, rows, cands, bank, key_len, stride):
    """match_estimate as csrc/match_estimate.cu computes it, block after
    block: coverage from the index of the last hit alone (a hit at u covers
    blocks u .. u + q0 - 1 from offset r on, and u + q0 below it), runs
    from the latest run start, no prefix counts."""
    q0, r = divmod(key_len, stride)
    h = bank.shape[1]
    log2_h = h.bit_length() - 1
    out = []
    for row, cand in zip(rows.tolist(), cands.tolist()):
        q = keys[row]
        ok = q != -1
        bkt = torch.where(ok, cm.bucket_of(q, log2_h), 0)
        ea, eb = bank[cand, bkt, 0], bank[cand, bkt, 1]
        fp = cm.fp_of(q)
        ha = ok & (ea != cm._SLOT_SENT) & ((ea >> cm._POS_BITS) == fp)
        hb = ok & (eb >= 0) & ((eb >> cm._POS_BITS) == fp)
        rpos = torch.where(ha, ea & cm._POS_MASK, torch.where(hb, eb & cm._POS_MASK, 0))
        hits, rpos = (ha | hb).tolist(), rpos.tolist()
        lo, hi = a_lo[row].tolist(), a_hi[row].tolist()
        acc, last, prev_diag = int(nrun[row]), -(1 << 30), 0
        for t in range(len(hits)):
            prev = last
            last = t if hits[t] else prev
            cov_hi, cov_lo = last > t - q0, last >= t - q0
            acc += (0 if cov_lo else lo[t]) + (0 if cov_hi else hi[t])
            if (cov_lo if r else cov_hi) and not prev > t - 1 - q0:
                diag = rpos[t] - t * stride
                acc += len(str(abs(diag - prev_diag))) + 4
                prev_diag = diag
        out.append(acc)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("key_len,stride", [(16, 4), (17, 4), (17, 16)])
def test_estimate_kernel_model_equals_plain(key_len, stride):
    """The kernel's last-hit formulation of coverage and run starts equals
    the plain version's prefix counts on the hard cases."""
    rng = np.random.default_rng(key_len + 7 * stride)
    args = _hard_estimate_case(rng, key_len, stride, t=1100, tile=1024)
    np.testing.assert_array_equal(estimate_kernel_model(*args, key_len, stride).numpy(),
                                  cm.match_estimate_plain(*args, key_len, stride).numpy())
