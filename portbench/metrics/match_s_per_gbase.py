"""Host matching's seconds (the ``match_contig`` stage timer, summed over
threads), per Gbase of the window's input."""


def read(run):
    return run.stage_s_per_gbase("match_contig")
