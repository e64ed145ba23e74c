"""bytes_api.compress_GiB_s: compress_GiB_s where it is not bounded end to end,
in the cells whose rate the shared host's speed sets (PERF.md §2): input
bytes of every compress request that completed in the first half of the
window, over that half's wall time (host clock)."""


def read(run):
    h = run.halves["compress"]
    return h.bytes / h.wall_s / 2**30 if h.requests else None
