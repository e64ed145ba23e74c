"""ratio: input bytes over the bytes of their blobs: the blobs the window's
compress requests returned, or, where requests return device arrays, the
HTP3 blob of each block or page that set-up encoded, serialized after the
window."""


def read(run):
    return run.ratio or None
