"""Splitter discovery's seconds (the program's ``splitter_discovery``
stage timer), per Gbase of the window's input."""


def read(run):
    return run.stage_s_per_gbase("splitter_discovery")
