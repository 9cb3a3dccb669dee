"""The port's stage timers and spans (``agc_tpu_torch/utils/profiling.py``):
exact accumulation from many threads, no profiler call while none runs,
the create's spans on every thread under a profiler that records them all,
the engine thread's waits under one that records its own thread only, how
much of a create the engine thread's spans cover, and the benchmark's
readers of the engine's waits."""

from __future__ import annotations

import json
import random
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from agc_tpu_torch.core.compressor import CompressorParams, append_archive, create_archive
from agc_tpu_torch.utils import profiling
from agc_tpu_torch.utils.profiling import StageTimers, device_trace, span

from util import make_collection

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUTER = "test.create"
ALL_THREADS = _ExperimentalConfig(profile_all_threads=True)
PARAMS = CompressorParams(segment_size=4000)


def _create_files(tmp_path):
    files = make_collection(tmp_path, random.Random(5), n_samples=3,
                            contig_lens=(60000, 40000, 30000))
    return [p for _, p in files]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One CPU create under each profiler: every thread recorded, and the
    starting thread only (as the benchmark's harness starts it). The
    device-match prepass is forced so the engine also waits on the match
    worker."""
    mp = pytest.MonkeyPatch()
    mp.setenv("AGC_TPU_DEVICE_MATCH", "1")
    tmp = tmp_path_factory.mktemp("traced")
    paths = _create_files(tmp)
    create_archive(str(tmp / "warm.agc"), paths, PARAMS, device="cpu")
    out = {}
    try:
        for mode, config in (("all", ALL_THREADS), ("own", None)):
            with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
                with record_function(OUTER):
                    timers = create_archive(str(tmp / f"{mode}.agc"), paths, PARAMS,
                                            device="cpu")
            out[mode] = (list(prof.events()), timers)
    finally:
        mp.undo()
    return out


def _spans(events, prefix="agc."):
    """{name: set of thread ids} of the spans named ``prefix``*."""
    got: dict = {}
    for e in events:
        if e.name.startswith(prefix):
            got.setdefault(e.name, set()).add(e.thread)
    return got


def _union_us(intervals) -> float:
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


# --- StageTimers -----------------------------------------------------------


@pytest.mark.parametrize("method", ["add", "stage", "count"])
def test_threads_accumulate_exactly(method):
    """Many threads on one key: the sums are exact (0.5 s and whole units
    add up without rounding)."""
    timers = StageTimers()
    n_threads, n_calls = 8, 2000
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(n_calls):
            if method == "add":
                timers.add("k", 0.5, 3)
            elif method == "stage":
                with timers.stage("k", 3):
                    pass
            else:
                timers.count("k", 3)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timers.units["k"] == 3 * n_threads * n_calls
    if method == "add":
        assert timers.times["k"] == 0.5 * n_threads * n_calls
    elif method == "stage":
        assert timers.times["k"] > 0
    else:
        assert "k" not in timers.times


def test_report_lists_counts_and_the_scan_fill():
    timers = StageTimers()
    timers.add("match_contig", 2.0, 4_000_000)
    timers.count("scan_dispatches", 2)
    timers.count("scan_symbols", 300)
    timers.count("scan_capacity", 400)
    report = timers.report()
    assert "match_contig" in report and "2.00 Mbases/s" in report
    assert "scan_dispatches" in report and "scan fill" in report and "75.0%" in report


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running, neither ``span`` nor ``stage`` enters
    ``record_function``, and ``device_trace`` without its directory does
    nothing."""
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.delenv("AGC_TPU_PROFILE_DIR", raising=False)
    assert not profiling._profiling()
    timers = StageTimers()
    with span("x"):
        with timers.stage("y", 1):
            with device_trace("off"):
                pass
    assert timers.units["y"] == 1


def test_span_on_a_worker_thread_under_a_running_profiler():
    """The flag the spans read is the process's: a worker thread opens
    its span while a profiler started on another thread runs."""
    seen = []

    def work():
        seen.append(profiling._profiling())
        with span("worker"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=ALL_THREADS) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert seen == [True]
    assert "agc.worker" in _spans(prof.events())


# --- a create under the profiler -------------------------------------------


@pytest.mark.parametrize("name", [
    "splitter_discovery", "disc_collect", "parse_fasta", "wait_parse", "pack_dispatch",
    "scan_pack", "scan_upload", "scan_launch", "scan_download", "scan_collect",
    "match_contig", "device_match", "wait_match", "barrier", "store_segments",
    "store_barrier", "store_finish", "wait_store", "close_finalize",
])
def test_create_records_its_spans(traced, name):
    """Each stage of the create is recorded as a span under a profiler
    that records every thread."""
    got = _spans(traced["all"][0])
    assert "agc." + name in got, sorted(got)


def test_worker_threads_are_traced(traced):
    events = traced["all"][0]
    got = _spans(events)
    threads = set().union(*got.values())
    assert len(threads) > 1
    engine = next(e.thread for e in events if e.name == OUTER)
    for name in ("agc.store_barrier", "agc.scan_pack", "agc.parse_fasta", "agc.device_match"):
        assert got[name] - {engine}, f"{name} ran on the engine thread only"


def test_engine_waits_traced_on_the_starting_thread_only(traced):
    """A profiler started without the all-threads option, as the
    benchmark's harness starts it, still records the engine's waits."""
    events = traced["own"][0]
    got = _spans(events)
    engine = next(e.thread for e in events if e.name == OUTER)
    for name in ("agc.wait_store", "agc.wait_parse", "agc.wait_match", "agc.close_finalize"):
        assert got.get(name) == {engine}, (name, sorted(got))
    assert "agc.store_barrier" not in got and "agc.scan_pack" not in got


@pytest.mark.parametrize("mode", ["all", "own"])
def test_timers_at_verbosity_zero(traced, mode):
    timers = traced[mode][1]
    assert PARAMS.verbosity == 0
    for name in ("wait_store", "wait_parse", "wait_match", "close_finalize", "barrier",
                 "store_barrier", "store_encode", "store_finish"):
        assert timers.times[name] > 0, name
    assert timers.units["scan_dispatches"] > 0
    assert 0 < timers.units["scan_symbols"] <= timers.units["scan_capacity"]
    assert timers.units["scan_rows"] >= timers.units["scan_dispatches"]


@pytest.mark.parametrize("mode", ["all", "own"])
def test_engine_spans_cover_the_create(traced, mode):
    """The engine thread's agc.* spans cover at least 90% of the create's
    wall time (0.95-0.99 measured on the CPU at this size; the rest is the
    engine's construction before its first stage)."""
    events = traced[mode][0]
    outer = next(e for e in events if e.name == OUTER)
    inside = [(e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("agc.") and e.thread == outer.thread]
    wall = outer.time_range.end - outer.time_range.start
    coverage = _union_us(inside) / wall
    print(f"engine span coverage {coverage:.4f} of {wall / 1e6:.3f} s")
    assert coverage >= 0.9


def test_device_trace_records_every_thread(tmp_path, monkeypatch):
    """The program's own exporter traces the workers too."""
    paths = _create_files(tmp_path)
    monkeypatch.setenv("AGC_TPU_PROFILE_DIR", str(tmp_path / "trace"))
    create_archive(str(tmp_path / "a.agc"), paths, PARAMS, device="cpu")
    with open(tmp_path / "trace" / "create.json") as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if str(e.get("name", "")).startswith("agc."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert {"agc.store_barrier", "agc.wait_store", "agc.close_finalize"} <= set(tids)
    assert len(set().union(*tids.values())) > 1


def test_device_trace_leaves_a_running_profiler_alone(tmp_path, monkeypatch):
    monkeypatch.setenv("AGC_TPU_PROFILE_DIR", str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with device_trace("inner"):
            with span("inside"):
                torch.ones(4).sum()
    assert not (tmp_path / "inner.json").exists()
    assert "agc.inside" in _spans(prof.events())


def test_append_returns_its_timers(tmp_path):
    paths = _create_files(tmp_path)
    base = str(tmp_path / "base.agc")
    create_archive(base, paths[:2], PARAMS, device="cpu")
    timers = append_archive(base, str(tmp_path / "out.agc"), paths[2:], PARAMS, device="cpu")
    assert isinstance(timers, StageTimers)
    assert timers.units["match_contig"] == sum(
        sum(len(l.strip()) for l in open(p) if not l.startswith(">")) for p in paths[2:])
    for name in ("wait_parse", "barrier", "close_finalize"):
        assert timers.times[name] > 0, name


# --- the benchmark's readers of the engine's waits -------------------------


@pytest.mark.parametrize("metric,stage", [
    ("store_wait_s_per_gbase", "wait_store"),
    ("match_wait_s_per_gbase", "wait_match"),
    ("parse_wait_s_per_gbase", "wait_parse"),
])
def test_wait_metric_readers(metric, stage):
    from portbench import harness

    spec = harness.find_cell("hpp-chr21x10.create")
    reader = harness.load("metrics", metric)
    untimed = [{"symbols": 10**9, "timers": {"match_contig": 1.0}},
               {"symbols": 10**9, "timers": None}]
    assert reader.read(harness.Run(spec, untimed, 1.0, 1.0)) is None
    timed = [{"symbols": 2 * 10**9, "timers": {stage: 3.0, "match_contig": 1.0}},
             {"symbols": 10**9, "timers": {stage: 1.5}},
             {"symbols": 10**9, "timers": None}]
    assert reader.read(harness.Run(spec, timed, 1.0, 1.0)) == pytest.approx(1.5)
    assert metric in {m["name"] for m in spec.per_layer}
