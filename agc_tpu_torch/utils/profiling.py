"""Stage timing + device profiling hooks of the port.

``StageTimers`` accumulates wall time, bases and counts per pipeline stage,
from any thread. Each ``stage()`` also opens a ``span()``: a
``torch.profiler.record_function`` range named ``agc.<stage>`` while a
``torch.profiler`` runs, and nothing else when none does, so one instrument
feeds both the stage report and a trace. ``device_trace`` wraps a region in
a ``torch.profiler`` trace (CPU and, when present, CUDA activity, every
thread) when ``AGC_TPU_PROFILE_DIR`` is set, writing a Chrome trace file
there; it is a no-op otherwise, and under a profiler that already runs.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

from torch.autograd import profiler as _profiler

__all__ = ["StageTimers", "device_trace", "span"]

SPAN_PREFIX = "agc."


def _profiling() -> bool:
    """Whether a ``torch.profiler`` runs in this process. The module flag
    torch sets on start and stop is read on every thread alike, where
    ``torch.autograd._profiler_enabled()`` is per thread and reads False
    on the worker threads a profiler records."""
    return _profiler._is_profiler_enabled


class span:
    """A ``record_function`` range ``agc.<name>`` on the calling thread
    while a profiler runs; one flag check otherwise."""

    __slots__ = ("_name", "_range")

    def __init__(self, name: str):
        self._name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = _profiler.record_function(SPAN_PREFIX + self._name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class _Stage(span):
    """``StageTimers.stage``'s context: the span, and the seconds and
    units added to the timers when it ends."""

    __slots__ = ("_timers", "_units", "_t0")

    def __init__(self, timers: "StageTimers", name: str, units: int):
        super().__init__(name)
        self._timers = timers
        self._units = units

    def __enter__(self):
        super().__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        super().__exit__(*exc)
        self._timers.add(self._name, seconds, self._units)


class StageTimers:
    """Accumulates wall time + units (bases) per pipeline stage, and counts.

    ``times`` and ``units`` are written only under the lock, by ``stage``,
    ``add`` and ``count``, so stages timed on worker threads add up
    exactly. A count is a ``units`` entry with no time."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.units: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def stage(self, name: str, units: int = 0) -> _Stage:
        """A context that times its body as ``name`` (with ``units``
        bases) inside the span ``agc.<name>``."""
        return _Stage(self, name, units)

    def add(self, name: str, seconds: float, units: int = 0) -> None:
        """Seconds (and units) of ``name`` measured by the caller."""
        with self._lock:
            self.times[name] += seconds
            self.units[name] += units

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.units[name] += n

    def report(self) -> str:
        lines = ["*** Stage timings ***"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t = self.times[name]
            u = self.units[name]
            rate = f"  {u / t / 1e6:8.2f} Mbases/s" if u and t > 0 else ""
            lines.append(f"{name:28s}: {t:8.3f} s{rate}")
        counts = sorted(n for n in self.units if n not in self.times)
        if counts:
            lines.append("*** Counts ***")
            lines += [f"{name:28s}: {self.units[name]}" for name in counts]
            if self.units.get("scan_capacity"):
                fill = self.units["scan_symbols"] / self.units["scan_capacity"]
                lines.append(f"{'scan fill':28s}: {100 * fill:.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(label: str = "agc_tpu_torch"):
    trace_dir = os.environ.get("AGC_TPU_PROFILE_DIR")
    if not trace_dir or _profiling():
        # a caller's profiler records the region (with its agc.* spans)
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # every thread: the workers' spans beside the engine's
    all_threads = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=all_threads) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
