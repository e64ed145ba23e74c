"""serialize.ms_per_block: mean host milliseconds of a call of the codec
class's ``serialize`` (one a block) in the window, timed by a wrapper the
traced run puts at the class boundary."""


def read(run):
    s = run.spans["serialize"]
    return sum(s) / len(s) * 1e3 if s else None
