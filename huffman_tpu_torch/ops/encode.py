"""Lane encode: (s*k,) padded bytes -> (w32, k) u32 lane words + bit counts.

Counterpart: ``_encode_with_tables_body`` in
``huffman_tpu/models/tpu_codec.py`` (the Pallas kernel
``ops/encode_pallas.py`` or the XLA ``ops/encode.py``, then the u16 -> u32
pairing of ``ops/decode_words.py``).  Byte ``i`` of the block is row
``i // k`` of lane ``i % k``; each lane's codes are concatenated MSB-first
and stored as big-endian-bit u32 words, word ``w`` of lane ``k`` at
``[w, k]``, zero past the lane's end.  Words are int32 tensors holding the
u32 bit patterns (torch's uint32 lacks shifts).

A batch of B blocks (the vmapped encode of ``_encode_batch``) is one
launch of the same kernel, `encode_lanes_batch`; a single block is the
batch of one.  The CUDA kernel is ``csrc/encode_lanes.cu``;
`encode_lanes_batch_plain` is its plain PyTorch version.

``lane_rows`` ((k,) int32, the ``ref`` profile's slice sizes) gives each
lane its own row count: rows at or past it append nothing, as the rows
that ``valid`` masks out in ``huffman_tpu/ops/encode.py:encode_lanes``.
``None`` gives every lane all s rows.
"""

from __future__ import annotations

import torch

from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda


def encode_lanes(
    padded: torch.Tensor,
    enc_table: torch.Tensor,
    s: int,
    k: int,
    w32: int,
    lane_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (words (w32, k) int32, bit_counts (k,) int32).

    ``w32`` must exceed the longest lane's word count; the codec's
    ``(s*15 + 31)//32 + 1`` always does.  ``lane_rows``: see the module.
    """
    if tuple(padded.shape) != (s * k,) or tuple(enc_table.shape) != (256,):
        raise ValueError(f"expected ({s * k},) bytes and a (256,) table")
    if padded.is_cuda:
        return _encode_cuda(padded, enc_table, 1, s, k, w32, lane_rows)
    if padded.device.type != "cpu":
        raise ValueError(f"unsupported device {padded.device}")
    return encode_lanes_plain(padded, enc_table, s, k, w32, lane_rows)


def encode_lanes_batch(
    blocks: torch.Tensor, enc_tables: torch.Tensor, s: int, k: int, w32: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode each row of (B, s*k) uint8 ``blocks`` with its row of the
    (B, 256) int32 ``enc_tables``.  Returns (words (B, w32, k) int32,
    bit_counts (B, k) int32)."""
    if blocks.is_cuda:
        if blocks.dim() != 2 or blocks.shape[0] < 1:
            raise ValueError(f"expected a (B, {s * k}) batch, got {tuple(blocks.shape)}")
        return _encode_cuda(blocks, enc_tables, blocks.shape[0], s, k, w32)
    if blocks.device.type != "cpu":
        raise ValueError(f"unsupported device {blocks.device}")
    return encode_lanes_batch_plain(blocks, enc_tables, s, k, w32)


def _encode_cuda(blocks, enc_tables, bcount: int, s: int, k: int, w32: int, lane_rows=None):
    """One launch over ``bcount`` blocks; the outputs take the inputs'
    leading dimensions (none for a single block, (B,) for a batch)."""
    lead = tuple(blocks.shape[:-1])
    _cuda.check(blocks, "blocks", torch.uint8, lead + (s * k,))
    _cuda.check(enc_tables, "enc_tables", torch.int32, lead + (256,))
    if lane_rows is not None:
        _cuda.check(lane_rows, "lane_rows", torch.int32, (k,))
    words = torch.empty(lead + (w32, k), dtype=torch.int32, device=blocks.device)
    bits = torch.empty(lead + (k,), dtype=torch.int32, device=blocks.device)
    args = (blocks.data_ptr(), enc_tables.data_ptr(), bcount, s, k, w32)
    outs = (words.data_ptr(), bits.data_ptr(), _cuda.stream(blocks))
    if lane_rows is None:
        _cuda.launch("encode_lanes", *args, *outs)
    else:
        _cuda.launch("encode_lanes_rows", *args, lane_rows.data_ptr(), *outs)
    return words, bits


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def encode_lanes_plain(
    padded: torch.Tensor,
    enc_table: torch.Tensor,
    s: int,
    k: int,
    w32: int,
    lane_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `encode_lanes`: the batch of one."""
    words, bits = encode_lanes_batch_plain(
        padded.view(1, -1), enc_table.view(1, -1), s, k, w32, lane_rows
    )
    return words[0], bits[0]


def encode_lanes_batch_plain(
    blocks: torch.Tensor,
    enc_tables: torch.Tensor,
    s: int,
    k: int,
    w32: int,
    lane_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the encode kernel: a loop over the s rows,
    vectorised over the B*k lanes of the batch, in int64.  ``lane_rows``
    ((k,), shared by the B blocks): a row at or past it adds length 0."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != s * k:
        raise ValueError(f"expected a (B, {s * k}) uint8 tensor")
    bcount = blocks.shape[0]
    dev = blocks.device
    tab = enc_tables.to(torch.int64).view(bcount, 256)
    rows = blocks.view(bcount, s, k).long()
    # Flat index of word 0 of every lane of every block.
    lane = (torch.arange(bcount, device=dev).view(-1, 1) * (w32 * k)
            + torch.arange(k, device=dev)).view(-1)
    words = torch.zeros(bcount * w32 * k, dtype=torch.int64, device=dev)
    pos = torch.zeros(bcount * k, dtype=torch.int64, device=dev)
    taken = None if lane_rows is None else lane_rows.to(dev, torch.int64).repeat(bcount)
    for r in range(s):
        e = tab.gather(1, rows[:, r]).view(-1)
        ln = e & 15 if taken is None else torch.where(r < taken, e & 15, 0)
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
    return (
        _to_int32_bits(words.view(bcount, w32, k)),
        pos.view(bcount, k).to(torch.int32),
    )
