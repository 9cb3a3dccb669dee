"""Reduce a ``torch.profiler`` trace of the measured window to the device's
busy time, its kernel time, the operations that took most time and the
longest idle gaps, each labelled with what the host was doing."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SPAN = "portbench."  # prefix of the harness's own spans, one an operation
TOP = 10
# the profiler's own bookkeeping, not work of the program
_OWN = ("Activity Buffer Request",)


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(spans: np.ndarray) -> np.ndarray:
    """Merged, sorted [start, end] rows of possibly overlapping spans."""
    if not len(spans):
        return spans
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    out = [list(spans[0])]
    for s, e in spans[1:]:
        if s > out[-1][1]:
            out.append([s, e])
        elif e > out[-1][1]:
            out[-1][1] = e
    return np.array(out)


def summarize(events, cuda_type, cpu_type) -> Trace | None:
    """``events``: ``prof.events()``; the device types to tell the card's
    activity (kernels, copies, memsets) from the host's. None when the
    window holds no span of the harness."""
    dev, dev_names, host, host_names, spans = [], [], [], [], []
    for e in events:
        r = e.time_range
        if e.device_type == cuda_type:
            # a range annotated on the host shows on the device's timeline
            # too: it is no device work
            if not (e.name in _OWN or e.name.startswith(SPAN)
                    or getattr(e, "is_user_annotation", False)):
                dev.append((r.start, r.end))
                dev_names.append(e.name)
        elif e.device_type == cpu_type:
            if e.name.startswith(SPAN):
                spans.append((r.start, r.end, e.name[len(SPAN):]))
            else:
                host.append((r.start, r.end))
                host_names.append(e.name)
    if not spans:
        return None
    w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)
    dev_a = np.array(dev, dtype=np.float64).reshape(-1, 2)
    names = np.array(dev_names, dtype=object)
    inside = (dev_a[:, 1] > w0) & (dev_a[:, 0] < w1)
    dev_a, names = np.clip(dev_a[inside], w0, w1), names[inside]
    dur = dev_a[:, 1] - dev_a[:, 0]
    merged = _union(dev_a)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0
    is_kernel = np.array([not (n.startswith("Memcpy") or n.startswith("Memset"))
                          for n in names], bool)
    kernel = float(dur[is_kernel].sum()) if len(dur) else 0.0

    by_name: dict = {}
    for n, d in zip(names.tolist(), dur.tolist()):
        by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:TOP]
    host_a = np.array(host, dtype=np.float64).reshape(-1, 2)
    span_a = np.array([s[:2] for s in spans], dtype=np.float64)
    idle = []
    for g0, g1 in gaps.tolist():
        mid = (g0 + g1) / 2
        cover = np.flatnonzero((host_a[:, 0] <= mid) & (host_a[:, 1] >= mid))
        if len(cover):
            label = host_names[cover[np.argmin(host_a[cover, 1] - host_a[cover, 0])]]
        else:
            own = np.flatnonzero((span_a[:, 0] <= mid) & (span_a[:, 1] >= mid))
            label = spans[own[0]][2] if len(own) else "between operations"
        idle.append([label, (g1 - g0) / 1e6])
    return Trace((w1 - w0) / 1e6, busy / 1e6, kernel / 1e6,
                 [[n, d / 1e6] for n, d in top], idle)
