"""Seconds the engine waited on the scan pipeline for splitter hits (the
``scan_collect`` stage timer), per Gbase of the window's input."""


def read(run):
    return run.stage_s_per_gbase("scan_collect")
