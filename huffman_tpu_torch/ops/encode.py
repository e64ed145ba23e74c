"""Lane encode: (s*k,) padded bytes -> (w32, k) u32 lane words + bit counts.

Counterpart: ``_encode_with_tables_body`` in
``huffman_tpu/models/tpu_codec.py`` (the Pallas kernel
``ops/encode_pallas.py`` or the XLA ``ops/encode.py``, then the u16 -> u32
pairing of ``ops/decode_words.py``).  Byte ``i`` of the block is row
``i // k`` of lane ``i % k``; each lane's codes are concatenated MSB-first
and stored as big-endian-bit u32 words, word ``w`` of lane ``k`` at
``[w, k]``, zero past the lane's end.  Words are int32 tensors holding the
u32 bit patterns (torch's uint32 lacks shifts).

The CUDA kernel is ``csrc/encode_lanes.cu``; `encode_lanes_plain` is its
plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda


def encode_lanes(
    padded: torch.Tensor, enc_table: torch.Tensor, s: int, k: int, w32: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (words (w32, k) int32, bit_counts (k,) int32).

    ``w32`` must exceed the longest lane's word count; the codec's
    ``(s*15 + 31)//32 + 1`` always does.
    """
    if padded.is_cuda:
        _cuda.check(padded, "padded", torch.uint8, (s * k,))
        _cuda.check(enc_table, "enc_table", torch.int32, (256,))
        _cuda.load()
        words = torch.empty((w32, k), dtype=torch.int32, device=padded.device)
        bits = torch.empty(k, dtype=torch.int32, device=padded.device)
        _cuda.launch(
            "encode_lanes", padded.data_ptr(), enc_table.data_ptr(), s, k, w32,
            words.data_ptr(), bits.data_ptr(), _cuda.stream(padded),
        )
        return words, bits
    if padded.device.type != "cpu":
        raise ValueError(f"unsupported device {padded.device}")
    return encode_lanes_plain(padded, enc_table, s, k, w32)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def encode_lanes_plain(
    padded: torch.Tensor, enc_table: torch.Tensor, s: int, k: int, w32: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the encode kernel: a loop over the s rows,
    vectorised over the k lanes, in int64."""
    if padded.dtype != torch.uint8 or tuple(padded.shape) != (s * k,):
        raise ValueError(f"expected a ({s * k},) uint8 tensor")
    dev = padded.device
    tab = enc_table.to(torch.int64)
    rows = padded.view(s, k).long()
    lane = torch.arange(k, device=dev)
    words = torch.zeros(w32 * k, dtype=torch.int64, device=dev)
    pos = torch.zeros(k, dtype=torch.int64, device=dev)
    for r in range(s):
        e = tab[rows[r]]
        ln = e & 15
        code = (e >> 4) >> (_L - ln)  # the code's ln bits
        w, end = pos >> 5, (pos & 31) + ln  # end <= 31 + 15
        # Bits of the code that land in word w, and those that spill into
        # w + 1 (code bits never overlap stored ones, so add == or).
        first = torch.where(
            end <= 32, code << (32 - end).clamp(min=0), code >> (end - 32).clamp(min=0)
        )
        spill = end > 32
        second = torch.where(
            spill, (code << torch.where(spill, 64 - end, 0)) & 0xFFFFFFFF, 0
        )
        words.index_add_(0, w * k + lane, first)
        words.index_add_(0, (w + 1) * k + lane, second)
        pos += ln
    return _to_int32_bits(words.view(w32, k)), pos.to(torch.int32)
