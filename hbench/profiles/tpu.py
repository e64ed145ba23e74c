"""The ``tpu`` profile: ``TorchCodec`` at the configuration's lanes and
block size, held to the plain reference (`check`, `reference`); a request
moves at least the bytes that `peaks` counts."""

from hbench.check import Tally  # noqa: F401
from hbench.peaks import compress_bytes, decompress_bytes  # noqa: F401


def make_codec(config: dict, device):
    from huffman_tpu_torch.models.torch_codec import TorchCodec

    codec = TorchCodec(config["lanes"], device=device)
    codec.block_bytes = config["block_bytes"]
    return codec
