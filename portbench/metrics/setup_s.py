"""From process start to the window's start: inputs, imports, the kernel
build where the checkout has none, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
