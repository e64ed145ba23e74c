"""huffman_tpu_torch: the Huffman codec of ``huffman_tpu`` in PyTorch + CUDA.

A port of ``huffman_tpu`` (JAX/Pallas) that writes and reads the same
blobs: HTP3 (the ``tpu`` profile, `TorchCodec`) and the reference's
K-stream format (the ``ref`` profile, `TorchRefCodec`, with its numpy
oracle `GoldenCodec`).  The kernels (histogram, table build, lane
encode, lane decode) are hand-written CUDA C++ for Hopper (``csrc/``),
built with nvcc at first use; each has a plain PyTorch version beside it
that serves CPU tensors.  Inputs over one block go through the block
container (``container``), which keeps two blocks in flight on the card.
Files: ``python -m huffman_tpu_torch.cli``; measurement tools:
``python3 -m huffman_tpu_torch.tools.<tool>``; debug helpers: ``debug``.

This package imports ``torch`` and numpy only, never ``jax`` or
``huffman_tpu``.

    from huffman_tpu_torch import TorchCodec
    codec = TorchCodec(device="cuda")
    blob = codec.compress(data)
    assert codec.decompress(blob) == data
"""

from .constants import MAX_CODE_LEN, NUM_SYMBOLS, STREAM_SLOP, TPU_MAX_CODE_LEN
from .coding import (
    CanonicalCoding,
    decode_tables_1x,
    decode_tables_2x,
    histogram,
    make_canonical_coding,
)
from .format import ParsedHeader, parse_header, slice_sizes, write_header
from .golden import GoldenCodec, compress, decompress
from . import container, native
from .models.torch_codec import TorchCodec, TorchCompressed
from .models.torch_ref_codec import TorchRefCodec
from .utils import debug


def __getattr__(name):
    # Loaded when first asked for, as huffman_tpu loads them, so that
    # importing the package does not import the sharded path's
    # torch.distributed machinery.
    if name == "NativeCodec":
        from .native import NativeCodec

        return NativeCodec
    if name == "ShardedCodec":
        from .parallel import ShardedCodec

        return ShardedCodec
    raise AttributeError(f"module 'huffman_tpu_torch' has no attribute {name!r}")


# The counterparts of ``huffman_tpu.__all__`` (TpuCodec -> TorchCodec,
# JaxCodec -> TorchRefCodec), and the port's own names.
__all__ = [
    "MAX_CODE_LEN",
    "NUM_SYMBOLS",
    "STREAM_SLOP",
    "CanonicalCoding",
    "histogram",
    "make_canonical_coding",
    "decode_tables_1x",
    "decode_tables_2x",
    "ParsedHeader",
    "parse_header",
    "slice_sizes",
    "write_header",
    "GoldenCodec",
    "compress",
    "decompress",
    "TorchCodec",
    "TorchRefCodec",
    "NativeCodec",
    "ShardedCodec",
    "TPU_MAX_CODE_LEN",
    "TorchCompressed",
]
