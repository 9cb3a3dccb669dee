"""Stage timing + device profiling hooks of the port.

``StageTimers`` accumulates wall time and bases per pipeline stage (a copy
of agc_tpu's). ``device_trace`` wraps a region in a ``torch.profiler``
trace (CPU and, when present, CUDA activity) when ``AGC_TPU_PROFILE_DIR``
is set, writing a Chrome trace file there; it is a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

__all__ = ["StageTimers", "device_trace"]


class StageTimers:
    """Accumulates wall time + units (bases) per pipeline stage."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.units: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.units[name] += units

    def report(self) -> str:
        lines = ["*** Stage timings ***"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t = self.times[name]
            u = self.units[name]
            rate = f"  {u / t / 1e6:8.2f} Mbases/s" if u and t > 0 else ""
            lines.append(f"{name:28s}: {t:8.3f} s{rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(label: str = "agc_tpu_torch"):
    trace_dir = os.environ.get("AGC_TPU_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
