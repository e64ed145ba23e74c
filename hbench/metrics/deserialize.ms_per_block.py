"""deserialize.ms_per_block: mean host milliseconds of a call of the codec
class's ``deserialize`` (one a block) in the window, timed as serialize."""


def read(run):
    s = run.spans["deserialize"]
    return sum(s) / len(s) * 1e3 if s else None
