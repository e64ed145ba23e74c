"""ref.table_ms: host ms of the 12-bit table build in one ``TorchRefCodec``
compress on its device path (the canonical coding of the block's counts
in NumPy and its packed encode table;
``huffman_tpu_torch.models.torch_ref_codec.COUNTS["compress"]`` table_ns
over calls, over set-up's calls and the window's).  None where the
program keeps no such counter or no call took the card's path."""


def read(run):
    try:
        from huffman_tpu_torch.models import torch_ref_codec
    except ImportError:
        return None
    c = getattr(torch_ref_codec, "COUNTS", {}).get("compress")
    return c["table_ns"] / c["calls"] / 1e6 if c and c["calls"] else None
