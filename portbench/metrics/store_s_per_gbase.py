"""The store's seconds: LZ, zstd and the container (the ``store_segments``,
``store_encode`` and ``close_finalize`` stage timers, summed over
threads), per Gbase of the window's input. ``close_finalize`` is timed
only at verbosity 1, which traced runs set."""


def read(run):
    return run.stage_s_per_gbase("store_segments", "store_encode", "close_finalize")
