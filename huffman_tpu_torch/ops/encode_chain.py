"""A compress request whose table comes from its own bytes: histogram,
table, encode.

Counterpart: ``_encode_with_tables_body`` after ``_table_hist`` and
``build_coding_device`` in ``huffman_tpu/models/tpu_codec.py``, and
``_encode_batch`` for a batch.  `encode_block` is `TorchCodec.encode_device`'s
work on one padded block, `encode_pages` `TorchCodec.encode_batch`'s on B
pages.

On a CUDA tensor one C call (``csrc/encode_chain.cu``) queues the three
kernels that `lookup`, `table_build` and `encode` would queue one by one,
into one output allocation: the host crosses into C once a request, and
the checks, the stream lookup and the allocation happen once.  The
outputs are views of that allocation (`layout`), so a tables dict kept
alone keeps the words' memory too.  A CPU tensor takes the three plain
versions in turn.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda
from .encode import encode_lanes, encode_lanes_batch
from .lookup import _geometry, histogram256_batch, table_hist
from .table_build import _FIELDS, TABLE_LEN, build_coding_device, build_coding_device_batch

#: Each view of the allocation starts on a boundary of this many int32
#: words (256 bytes).
ALIGN = 64


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def layout(bcount: int, w32: int, k: int) -> tuple[int, int, int, int]:
    """Offsets, in int32 words, of the bit counts, the flat tables and the
    histograms in the allocation of ``bcount`` blocks, and its length.
    The words ((bcount, w32, k)) come first, at 0; then the bit counts
    ((bcount, k)), the field-major tables (bcount * TABLE_LEN) and the
    histograms ((bcount, 256)), each from the next 256-byte boundary."""
    bits = _up(bcount * w32 * k)
    table = _up(bits + bcount * k)
    hist = _up(table + bcount * TABLE_LEN)
    return bits, table, hist, hist + bcount * 256


@functools.lru_cache(maxsize=64)
def _views(bcount: int, w32: int, k: int, batch: bool) -> tuple:
    """(`layout`, and (key, shape, strides, offset) of each view): the
    words, the bit counts, then each key of `build_coding_device`'s dict,
    with a leading ``bcount`` where ``batch``, as `table_build._unpack`
    cuts them."""
    offsets = layout(bcount, w32, k)
    bits, table = offsets[:2]
    lead = (bcount,) if batch else ()
    views = [("words", lead + (w32, k), 0), ("bit_counts", lead + (k,), bits)]
    views += [(key, lead + ((size,) if size else ()), table + off * bcount)
              for key, off, size in _FIELDS]
    return offsets, tuple(
        (key, shape, torch.empty(shape, device="meta").stride(), off)
        for key, shape, off in views
    )


def _launch(entry: str, x: torch.Tensor, bcount: int, w32: int, k: int, batch: bool, args):
    """One call of the chain ``entry`` on ``x``, its arguments ``args``
    then the pointers into one new allocation; returns (words, bit
    counts, tables dict), views of it.  The views are cut after the call,
    while the card runs the kernels."""
    (bits, table, hist, total), views = _views(bcount, w32, k, batch)
    arena = torch.empty(total, dtype=torch.int32, device=x.device)
    base = arena.data_ptr()
    _cuda.launch(
        entry, *args, base + 4 * hist, base + 4 * table, base, base + 4 * bits,
        _cuda.stream(x),
    )
    out = {key: arena.as_strided(shape, strides, off) for key, shape, strides, off in views}
    return out.pop("words"), out.pop("bit_counts"), out


def encode_block(
    padded: torch.Tensor, hist_stride: int, s: int, k: int, w32: int
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(words (w32, k) int32, bit_counts (k,) int32, the
    `build_coding_device` dict) of the (s*k,) uint8 block, its table from
    `lookup.table_hist` at ``hist_stride``."""
    if not padded.is_cuda:
        if padded.device.type != "cpu":
            raise ValueError(f"unsupported device {padded.device}")
        tables = build_coding_device(table_hist(padded, hist_stride))
        return *encode_lanes(padded, tables["enc_table"], s, k, w32), tables
    _cuda.check(padded, "padded", torch.uint8, (s * k,))
    rows, row_len, pitch, last_len, bias = _geometry(s * k, hist_stride)
    return _launch(
        "encode_chain", padded, 1, w32, k, False,
        (padded.data_ptr(), rows, row_len, pitch, last_len, bias, s, k, w32),
    )


def encode_pages(
    blocks: torch.Tensor, s: int, k: int, w32: int
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(words (B, w32, k) int32, bit_counts (B, k) int32, the
    `build_coding_device_batch` dict) of the (B, s*k) uint8 blocks, each
    table from every byte of its block."""
    if not blocks.is_cuda:
        if blocks.device.type != "cpu":
            raise ValueError(f"unsupported device {blocks.device}")
        tables = build_coding_device_batch(histogram256_batch(blocks))
        return *encode_lanes_batch(blocks, tables["enc_table"], s, k, w32), tables
    bcount = blocks.shape[0]
    _cuda.check(blocks, "blocks", torch.uint8, (bcount, s * k))
    return _launch(
        "encode_chain_batch", blocks, bcount, w32, k, True,
        (blocks.data_ptr(), bcount, s, k, w32),
    )
