"""wrappers.launches.compress: kernel launches through the program's
wrappers (``huffman_tpu_torch.ops._cuda.LAUNCHES``) a compress request."""


def read(run):
    h = run.halves["compress"]
    return h.launches / h.requests if h.requests and h.launches else None
