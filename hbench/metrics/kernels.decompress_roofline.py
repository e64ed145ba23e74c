"""kernels.decompress_roofline: a decompress request's least time (the
words holding its codes read, its bytes written, over the HBM rate) over
the device time of every operation it ran in the traced slice, in percent."""

from hbench import peaks


def read(run):
    h = run.halves["decompress"]
    t = h.trace
    if not t or not t["requests"] or not t["device_s"] or not h.work_bytes:
        return None
    return 100 * h.work_bytes / peaks.HBM_BYTES_PER_S / (t["device_s"] / t["requests"])
