"""sharded.decompress_GiB_s: the sharded codec's decompress rate, where the host sets
the pace (PERF.md §2): the bytes of every decompress request that completed in
its half of the window, over that half's wall time (host clock, rank 0)."""


def read(run):
    h = run.halves["decompress"]
    return h.bytes / h.wall_s / 2**30 if h.requests and h.wall_s else None
