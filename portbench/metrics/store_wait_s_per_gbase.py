"""Seconds the engine thread waited on the store worker (the program's
``wait_store`` stage timer: back-pressure, the joins before a metadata
batch, an estimate or the close), per Gbase of the window's input."""


def read(run):
    return run.stage_s_per_gbase("wait_store")
