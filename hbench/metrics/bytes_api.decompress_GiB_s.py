"""bytes_api.decompress_GiB_s: decompress_GiB_s where it is not bounded end to
end, in the cells whose rate the shared host's speed sets (PERF.md §2):
decompressed bytes of every decompress request that completed in the
second half of the window, over that half's wall time (host clock)."""


def read(run):
    h = run.halves["decompress"]
    return h.bytes / h.wall_s / 2**30 if h.requests else None
