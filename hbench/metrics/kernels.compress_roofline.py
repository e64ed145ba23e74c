"""kernels.compress_roofline: a compress request's least time (its
bytes over the HBM rate, `peaks`) over the device time of every operation
it ran in the traced slice, in percent."""

from hbench import peaks


def read(run):
    h = run.halves["compress"]
    t = h.trace
    if not t or not t["requests"] or not t["device_s"] or not h.work_bytes:
        return None
    return 100 * h.work_bytes / peaks.HBM_BYTES_PER_S / (t["device_s"] / t["requests"])
