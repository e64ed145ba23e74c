"""api.encode_call_ms: mean host milliseconds of a compress call, from the
call to its return, before the synchronize (the untraced requests)."""


def read(run):
    c = run.halves["compress"].call_s
    return sum(c) / len(c) * 1e3 if c else None
