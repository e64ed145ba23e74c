"""A host coding packed into the flat tables that the kernels index, as
in ``huffman_tpu/ops/tables.py``.

* encode table: u32[256] ``code << 4 | len``, the code left-aligned in
  15 bits (``TPU_MAX_CODE_LEN``), the layout ``csrc/encode_lanes.cu``
  takes for either profile;
* two-symbol decode table: i32[4096] packed `coding.decode_tables_2x`
  entries: bits 0-7 the bits consumed, 8-9 the symbol count, 10-17 the
  first symbol, 18-25 the second.
"""

from __future__ import annotations

import numpy as np

from .. import coding
from ..constants import MAX_CODE_LEN, TPU_MAX_CODE_LEN


def pack_encode_table(cc: coding.CanonicalCoding) -> np.ndarray:
    """u32[256]: ``code << 4 | len``, codes moved from the coding's own
    ``max_len`` alignment (12 for the ref profile) up to 15 bits; the
    stream bits are the same."""
    shift = TPU_MAX_CODE_LEN - cc.max_len
    if shift < 0:
        raise ValueError(f"a coding of {cc.max_len}-bit codes does not fit the 15-bit table")
    code15 = cc.code_bits.astype(np.uint32) << shift
    return (code15 << 4) | cc.code_lens.astype(np.uint32)


def pack_decode_table(len_count: np.ndarray, sorted_syms: np.ndarray) -> np.ndarray:
    """i32[4096] packed two-symbol decode entries."""
    t_bits, t_s0, t_s1, t_n = coding.decode_tables_2x(len_count, sorted_syms)
    return (
        t_bits.astype(np.int32)
        | (t_n.astype(np.int32) << 8)
        | (t_s0.astype(np.int32) << 10)
        | (t_s1.astype(np.int32) << 18)
    )


def unpack_decode_entry(e):
    """(bits, count, sym0, sym1) of packed decode entries (numpy arrays,
    tensors or ints)."""
    return e & 0xFF, (e >> 8) & 0x3, (e >> 10) & 0xFF, (e >> 18) & 0xFF


if MAX_CODE_LEN > 15:
    raise AssertionError("the encode table packs a code's length in 4 bits")
