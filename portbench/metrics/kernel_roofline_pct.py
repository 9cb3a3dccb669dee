"""The least time the cell's device work needs (``roofline.py``, counted
from the inputs) as a share of the kernel time the profiler recorded in
the traced window, all kernels whatever their names. Under ``-a`` the
barriers' new-splitter scans are left out of the count, so the share is a
lower bound there."""


def read(run):
    if run.trace is None or run.least_s is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * run.least_s / run.trace.kernel_s
