"""huffman_tpu_torch: the ``tpu``-profile Huffman codec in PyTorch + CUDA.

A port of ``huffman_tpu`` (JAX/Pallas) that writes and reads the same
HTP3 blobs.  The four kernels of the single-block round trip (histogram,
table build, lane encode, lane decode) are hand-written CUDA C++ for
Hopper (``csrc/``), built with nvcc at first use; each has a plain
PyTorch version beside it that serves CPU tensors.

This package imports ``torch`` and numpy only, never ``jax`` or
``huffman_tpu``.

    from huffman_tpu_torch import TorchCodec
    codec = TorchCodec(device="cuda")
    blob = codec.compress(data)
    assert codec.decompress(blob) == data
"""

from .constants import NUM_SYMBOLS, TPU_MAX_CODE_LEN
from .models.torch_codec import TorchCodec, TorchCompressed

__all__ = ["NUM_SYMBOLS", "TPU_MAX_CODE_LEN", "TorchCodec", "TorchCompressed"]
