"""decompress_GiB_s: decompressed bytes of every decompress request that
completed in the second half of the window, over that half's wall time."""


def read(run):
    h = run.halves["decompress"]
    return h.bytes / h.wall_s / 2**30 if h.requests else None
