"""Every input symbol of the window's operations over the time from the
window's start to the end of its last operation (host clock)."""


def read(run):
    return run.symbols / run.window_s / 1e6
