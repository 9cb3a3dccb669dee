"""The close's finish of every live group's last packs
(``Compressor._finish_groups``): fanned across a pool of ``_n_threads``
workers under the barrier store's rule, in turn otherwise. The engine's
width is forced through ``os.cpu_count`` as the compressor module sees
it (``_n_threads`` is half of it): 1 keeps the serial loop, 4 fans.

At AGC's pack cardinality (50) no delta pack of a three-sample collection
fills before the close, so every group's packs are written by the finish.
The archive must be the serial one to the byte, for a create and an
append; the tpu-rans profile stays serial; a group whose finish raises
fails the close and leaves no file behind."""

from __future__ import annotations

import filecmp
import os
import random
import sys
from types import SimpleNamespace

import pytest

from agc_tpu.core.compressor import CompressorParams as TpuParams
from agc_tpu.core.compressor import append_archive as tpu_append
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu_torch.core import compressor as port_compressor
from agc_tpu_torch.core.archive import ArchiveWriter
from agc_tpu_torch.core.codecs import ss_base, ss_delta_name, ss_ref_name
from agc_tpu_torch.core.compressor import (
    Compressor,
    CompressorParams,
    append_archive,
    create_archive,
)
from agc_tpu_torch.core.segment import SegmentWriter
from agc_tpu_torch.utils.profiling import StageTimers
from test_torch_create import assert_same_archive

from util import make_collection, mutate, random_seq, write_fa

WIDTHS = [1, 4]


@pytest.fixture
def device_match_off(monkeypatch):
    monkeypatch.setenv("AGC_TPU_DEVICE_MATCH", "0")


@pytest.fixture
def finishes(monkeypatch):
    """Records, for each close, the live-group count and whether the
    finish fanned."""
    seen = []
    orig = Compressor._finish_groups

    def spy(self, live):
        seen.append((len(live), self._fans(len(live))))
        return orig(self, live)

    monkeypatch.setattr(Compressor, "_finish_groups", spy)
    return seen


def _set_width(monkeypatch, width):
    monkeypatch.setattr(port_compressor.os, "cpu_count", lambda: 2 * width)


def _collection(tmp_path):
    files = make_collection(tmp_path, random.Random(5), n_samples=3)
    return [p for _, p in files]


def _extra(tmp_path, base_path):
    rng = random.Random(9)
    with open(base_path) as f:
        body = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    extra = str(tmp_path / "extra.fa")
    write_fa(extra, [("c1", mutate(rng, body[:60000], 150, 10)),
                     ("c3", random_seq(rng, 4000))])
    return extra


def _create(monkeypatch, width, out, paths, params):
    _set_width(monkeypatch, width)
    return create_archive(out, paths, params, device="cpu")


def _append(monkeypatch, width, src, out, paths, params):
    _set_width(monkeypatch, width)
    return append_archive(src, out, paths, params, device="cpu")


@pytest.mark.parametrize("width", WIDTHS)
def test_create_same_bytes_at_width(tmp_path, monkeypatch, device_match_off,
                                    finishes, width):
    paths = _collection(tmp_path)
    params = CompressorParams(segment_size=3000)
    serial, ours = str(tmp_path / "serial.agc"), str(tmp_path / "ours.agc")
    _create(monkeypatch, 1, serial, paths, params)
    timers = _create(monkeypatch, width, ours, paths, params)
    assert filecmp.cmp(serial, ours, shallow=False)
    (n_serial, fanned_serial), (n_live, fanned) = finishes
    assert n_live == n_serial > 40 and not fanned_serial
    assert fanned == (width > 1)
    assert timers.units["store_finish_fanned"] == (n_live if width > 1 else 0)
    ref = str(tmp_path / "tpu.agc")
    tpu_create(ref, paths, TpuParams(**vars(params)))
    assert_same_archive(ours, ref)


@pytest.mark.parametrize("width", WIDTHS)
def test_append_same_bytes_at_width(tmp_path, monkeypatch, device_match_off,
                                    finishes, width):
    """An append rehydrates every old group's last pack and finishes it
    again; a group whose last pack is its only delta part has no stream
    registered before the close."""
    paths = _collection(tmp_path)
    extra = _extra(tmp_path, paths[0])
    params = CompressorParams(segment_size=3000)
    base = str(tmp_path / "base.agc")
    _create(monkeypatch, 1, base, paths, params)
    serial, ours = str(tmp_path / "serial.agc"), str(tmp_path / "ours.agc")
    _append(monkeypatch, 1, base, serial, [extra], params)
    timers = _append(monkeypatch, width, base, ours, [extra], params)
    assert filecmp.cmp(serial, ours, shallow=False)
    n_live, fanned = finishes[-1]
    assert n_live == finishes[-2][0] > 40 and not finishes[-2][1]
    assert fanned == (width > 1)
    assert timers.units["store_finish_fanned"] == (n_live if width > 1 else 0)
    tpu_params = TpuParams(**vars(params))
    ref, ref2 = str(tmp_path / "tpu.agc"), str(tmp_path / "tpu2.agc")
    tpu_create(ref, paths, tpu_params)
    tpu_append(ref, ref2, [extra], tpu_params)
    assert_same_archive(ours, ref2)


@pytest.mark.parametrize("width", WIDTHS)
def test_tpu_rans_finish_stays_serial(tmp_path, monkeypatch, device_match_off,
                                      finishes, width):
    paths = _collection(tmp_path)
    params = CompressorParams(segment_size=3000, profile="tpu-rans")
    serial, ours = str(tmp_path / "serial.agc"), str(tmp_path / "ours.agc")
    _create(monkeypatch, 1, serial, paths, params)
    timers = _create(monkeypatch, width, ours, paths, params)
    assert filecmp.cmp(serial, ours, shallow=False)
    assert finishes[-1][0] > 40 and not finishes[-1][1]
    assert timers.units["store_finish_fanned"] == 0


def _finish_many(path, n_threads, n_groups=300):
    """Groups of a reference and three deltas each, finished by
    ``_finish_groups`` on an engine of ``n_threads``; returns its timers."""
    rng = random.Random(13)
    writer = ArchiveWriter(path)
    live = []
    for gid in range(n_groups):
        writer.register_stream(ss_ref_name(3000, gid))
        writer.register_stream(ss_delta_name(3000, gid))
        seg = SegmentWriter(ss_base(3000, gid), writer, 50, 20, 3000)
        ref = random_seq(rng, 2000)
        for seq in (ref, *(mutate(rng, ref, 40, 4) for _ in range(3))):
            seg.add(seq.encode())
        live.append(seg)
    engine = SimpleNamespace(_entropy_batcher=None, _n_threads=n_threads,
                             timers=StageTimers())
    engine._fans = lambda n: Compressor._fans(engine, n)
    Compressor._finish_groups(engine, live)
    writer.close()
    return engine.timers


def test_fanned_finish_under_thread_switches(tmp_path):
    """More workers than cores, switching threads every few microseconds:
    the archive writer's buffers and the timers, which every worker
    shares, still give the serial loop's bytes and an exact count."""
    serial, fanned = str(tmp_path / "serial.agc"), str(tmp_path / "fanned.agc")
    _finish_many(serial, 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-6)
    try:
        timers = _finish_many(fanned, 4 * (os.cpu_count() or 1))
    finally:
        sys.setswitchinterval(old)
    assert timers.units["store_finish_fanned"] == 300
    assert filecmp.cmp(serial, fanned, shallow=False)


@pytest.mark.parametrize("width", WIDTHS)
def test_failed_group_finish_leaves_no_file(tmp_path, monkeypatch,
                                            device_match_off, finishes, width):
    paths = _collection(tmp_path)
    out = str(tmp_path / "out.agc")
    failing = ss_base(3000, 20)
    orig = SegmentWriter.finish

    def finish(self):
        if self.name == failing:
            raise RuntimeError("planted finish failure")
        return orig(self)

    monkeypatch.setattr(SegmentWriter, "finish", finish)
    with pytest.raises(RuntimeError, match="planted finish failure"):
        _create(monkeypatch, width, out, paths,
                CompressorParams(segment_size=3000))
    assert finishes[-1][0] > 40
    assert finishes[-1][1] == (width > 1)
    assert not os.path.exists(out)
