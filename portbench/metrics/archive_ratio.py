"""The window's input symbols over the archive bytes its operations
wrote (an append's: the output's size less the input's)."""


def read(run):
    written = sum(op["bytes"] for op in run.ops)
    return run.symbols / written if written > 0 else None
