"""Seconds the engine thread waited on the device-match worker for its
estimates (the program's ``wait_match`` stage timer), per Gbase of the
window's input."""


def read(run):
    return run.stage_s_per_gbase("wait_match")
