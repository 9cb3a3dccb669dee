"""Seconds the engine thread waited on the FASTA producer for a sample's
contigs (the program's ``wait_parse`` stage timer), per Gbase of the
window's input."""


def read(run):
    return run.stage_s_per_gbase("wait_parse")
