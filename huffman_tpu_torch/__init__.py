"""huffman_tpu_torch: the Huffman codec of ``huffman_tpu`` in PyTorch + CUDA.

A port of ``huffman_tpu`` (JAX/Pallas) that writes and reads the same
blobs: HTP3 (the ``tpu`` profile, `TorchCodec`) and the reference's
K-stream format (the ``ref`` profile, `TorchRefCodec`, with its numpy
oracle `GoldenCodec`).  The kernels (histogram, table build, lane
encode, lane decode) are hand-written CUDA C++ for Hopper (``csrc/``),
built with nvcc at first use; each has a plain PyTorch version beside it
that serves CPU tensors.  Files: ``python -m huffman_tpu_torch.cli``.

This package imports ``torch`` and numpy only, never ``jax`` or
``huffman_tpu``.

    from huffman_tpu_torch import TorchCodec
    codec = TorchCodec(device="cuda")
    blob = codec.compress(data)
    assert codec.decompress(blob) == data
"""

from .constants import NUM_SYMBOLS, TPU_MAX_CODE_LEN
from .golden import GoldenCodec
from .models.torch_codec import TorchCodec, TorchCompressed
from .models.torch_ref_codec import TorchRefCodec

__all__ = [
    "NUM_SYMBOLS",
    "TPU_MAX_CODE_LEN",
    "GoldenCodec",
    "TorchCodec",
    "TorchCompressed",
    "TorchRefCodec",
]
