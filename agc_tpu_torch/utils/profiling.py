"""Stage timing + device profiling hooks of the port.

``StageTimers`` is agc_tpu's (host-only). ``device_trace`` wraps a region
in a ``torch.profiler`` trace (CPU and, when present, CUDA activity) when
``AGC_TPU_PROFILE_DIR`` is set, writing a Chrome trace file there; it is a
no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os

from agc_tpu.utils.profiling import StageTimers

__all__ = ["StageTimers", "device_trace"]


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
