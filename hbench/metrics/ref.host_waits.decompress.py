"""ref.host_waits.decompress: the sites where the host waited for the card in
one ``TorchRefCodec`` decompress on its device path (a ``.cpu()`` copy, a
boolean-mask select or scatter, which syncs for its count;
``huffman_tpu_torch.models.torch_ref_codec.COUNTS["decompress"]`` waits
over calls, over set-up's calls and the window's).  None where the
program keeps no such counter or no call took the card's path."""


def read(run):
    try:
        from huffman_tpu_torch.models import torch_ref_codec
    except ImportError:
        return None
    c = getattr(torch_ref_codec, "COUNTS", {}).get("decompress")
    return c["waits"] / c["calls"] if c and c["calls"] else None
