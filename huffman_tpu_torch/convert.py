"""Carry a compressed block between this package and ``huffman_tpu`` in
memory, as numpy arrays.

A ``huffman_tpu`` ``TpuCompressed`` holds ``words`` (W, K) uint32,
``bit_counts`` (K,) int32, ``raw_size``, ``k`` and a ``tables`` dict of
int32 arrays (the ``build_coding_device`` keys, or the subset that
``deserialize`` makes).  `from_numpy` takes those fields as numpy arrays
and returns a `TorchCompressed` on a chosen device; `to_numpy` gives them
back.  `batch_from_numpy` and `batch_to_numpy` do the same for the
``(words (B, W, K) u32, bit_counts (B, K) i32, tables)`` triple of
``encode_batch``, whose tables carry a leading B.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.torch_codec import TorchCompressed


def from_numpy(
    words, bit_counts, raw_size: int, k: int, tables: dict, *, device
) -> TorchCompressed:
    """A `TorchCompressed` on ``device`` from numpy fields."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    if words.ndim != 2 or words.shape[1] != k:
        raise ValueError(f"words must be (W, {k}), got {words.shape}")
    bits = np.asarray(bit_counts, dtype=np.int32)
    if bits.shape != (k,):
        raise ValueError(f"bit_counts must be ({k},), got {bits.shape}")

    def dev(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return TorchCompressed(
        words=dev(words),
        bit_counts=dev(bits),
        raw_size=int(raw_size),
        k=int(k),
        tables={key: dev(v) for key, v in tables.items()},
    )


def to_numpy(comp: TorchCompressed) -> dict:
    """The fields of ``comp`` as numpy arrays: ``words`` (W, K) uint32,
    ``bit_counts`` (K,) int32, ``raw_size``, ``k`` and ``tables``."""
    return {
        "words": comp.words.cpu().numpy().view(np.uint32),
        "bit_counts": comp.bit_counts.cpu().numpy(),
        "raw_size": comp.raw_size,
        "k": comp.k,
        "tables": {key: v.cpu().numpy() for key, v in comp.tables.items()},
    }


def batch_from_numpy(words, bit_counts, tables: dict, *, device) -> tuple:
    """``encode_batch``'s triple as tensors on ``device``: words (B, W, K)
    int32 bit patterns, bit_counts (B, K) int32 and the tables dict."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    if words.ndim != 3:
        raise ValueError(f"words must be (B, W, K), got {words.shape}")
    bits = np.asarray(bit_counts, dtype=np.int32)
    if bits.shape != (words.shape[0], words.shape[2]):
        raise ValueError(f"bit_counts must be (B, K), got {bits.shape}")

    def dev(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return dev(words), dev(bits), {key: dev(v) for key, v in tables.items()}


def batch_to_numpy(words, bit_counts, tables: dict) -> tuple:
    """Inverse of `batch_from_numpy`: words (B, W, K) uint32, bit_counts
    (B, K) int32 and the tables dict, as numpy arrays."""
    return (
        words.cpu().numpy().view(np.uint32),
        bit_counts.cpu().numpy(),
        {key: v.cpu().numpy() for key, v in tables.items()},
    )
