"""api.decode_prepared_share: the share of ``decode_device`` calls on a card
that took the prepared path, one checked C call a block
(``huffman_tpu_torch.ops._cuda.DECODE_PATHS``: "prepared" over "prepared"
plus "checked", over set-up's calls and the window's).  None where the
program keeps no such counter or made no such call."""


def read(run):
    try:
        from huffman_tpu_torch.ops import _cuda
    except ImportError:
        return None
    paths = getattr(_cuda, "DECODE_PATHS", None)
    if not paths:
        return None
    calls = paths.get("prepared", 0) + paths.get("checked", 0)
    return paths.get("prepared", 0) / calls if calls else None
