"""device.idle_pct.compress: the share of the compress half's traced slice
in which no operation ran on the device (profiler), in percent."""


def read(run):
    t = run.halves["compress"].trace
    return 100 * (1 - t["busy_s"] / t["window_s"]) if t and t["window_s"] else None
