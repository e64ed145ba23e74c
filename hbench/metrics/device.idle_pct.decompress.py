"""device.idle_pct.decompress: the share of the decompress half's traced
slice in which no operation ran on the device (profiler), in percent."""


def read(run):
    t = run.halves["decompress"].trace
    return 100 * (1 - t["busy_s"] / t["window_s"]) if t and t["window_s"] else None
