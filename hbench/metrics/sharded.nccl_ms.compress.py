"""sharded.nccl_ms.compress: device milliseconds a compress request of NCCL's
kernels (the operations whose names start with ``nccl``, less the
profiler's ``nccl:<collective>`` ranges, which span the same kernels)
in rank 0's traced slice of the compress half (profiler).  A kernel's time
includes its wait for the other ranks.  None where the slice has no such
kernel."""


def read(run):
    t = run.halves["compress"].trace
    if not t or not t["requests"]:
        return None
    s = sum(v for n, v in t["ops"].items() if n.startswith("nccl") and not n.startswith("nccl:"))
    return 1e3 * s / t["requests"] if s else None
