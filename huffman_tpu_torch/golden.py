"""The ``ref`` profile's oracle on the host (numpy), the same bytes as
``huffman_tpu/golden.py``: a direct K-stream codec that every faster
path is held to, on the CPU in the tests and on the card in
``chip_smoke.py``.

Not a fast path: the encode is numpy-vectorized, the decode a loop a
symbol over the 12-bit decode tables.
"""

from __future__ import annotations

import numpy as np

from . import coding, format as fmt
from .constants import MAX_CODE_LEN, STREAM_SLOP


def _encode_stream(data: np.ndarray, code_bits: np.ndarray, code_lens: np.ndarray) -> np.ndarray:
    """One slice's region: uint8[ceil(bits/8) + slop], the stream written
    backward into its top bytes, the slop at the front zero."""
    lens = code_lens[data].astype(np.int64)
    total_bits = int(lens.sum())
    region = np.zeros((total_bits + 7) // 8 + STREAM_SLOP, dtype=np.uint8)
    if total_bits == 0:
        return region
    # Every code's bits in stream order, MSB first.
    starts = np.cumsum(lens) - lens
    src = np.repeat(np.arange(len(data)), lens)
    within = np.arange(total_bits, dtype=np.int64) - np.repeat(starts, lens)
    codes = code_bits[data].astype(np.uint32)
    bitvals = (codes[src] >> (MAX_CODE_LEN - 1 - within)) & 1
    packed = np.packbits(bitvals.astype(np.uint8))
    region[len(region) - len(packed) :] = packed[::-1]
    return region


def _decode_stream(region: np.ndarray, n_out: int, t2, t1) -> np.ndarray:
    """``n_out`` symbols of one backward region: two at a time while two
    remain, then one (the one-symbol table ignores bits past the stream)."""
    t2_bits, t2_s0, t2_s1, t2_n = t2
    t1_len, t1_sym = t1
    out = np.zeros(n_out, dtype=np.uint8)
    if n_out == 0:
        return out
    # Stream order with zeros past the region's start, so a 12-bit window
    # never runs off the end.
    bits = np.unpackbits(np.concatenate([region[::-1], np.zeros(8, dtype=np.uint8)]))
    weights = 1 << np.arange(MAX_CODE_LEN - 1, -1, -1)
    pos = 0
    i = 0
    while i + 2 <= n_out:
        code = int(bits[pos : pos + MAX_CODE_LEN].dot(weights))
        out[i] = t2_s0[code]
        out[i + 1] = t2_s1[code]
        i += int(t2_n[code])
        pos += int(t2_bits[code])
    while i < n_out:
        code = int(bits[pos : pos + MAX_CODE_LEN].dot(weights))
        out[i] = t1_sym[code]
        i += 1
        pos += int(t1_len[code])
    return out


def compress(raw: bytes, k: int) -> bytes:
    """``raw`` as a K-stream ref-profile blob."""
    data = np.frombuffer(raw, dtype=np.uint8)
    bounds = np.concatenate([[0], np.cumsum(fmt.slice_sizes(len(data), k))])
    slices = [data[bounds[i] : bounds[i + 1]] for i in range(k)]
    part_hists = [coding.histogram(x) for x in slices]
    cc = coding.make_canonical_coding(np.sum(part_hists, axis=0, dtype=np.uint64))
    lens64 = cc.code_lens.astype(np.int64)
    bits = np.array([int((h.astype(np.int64) * lens64).sum()) for h in part_hists])
    end_offsets = np.cumsum(fmt.stream_region_sizes(bits))
    header = fmt.write_header(len(data), cc.len_count, cc.len_mask, cc.sorted_syms, end_offsets)
    return header + b"".join(
        _encode_stream(x, cc.code_bits, cc.code_lens).tobytes() for x in slices
    )


def decompress(compressed: bytes, k: int) -> bytes:
    """The raw bytes of a K-stream ref-profile blob."""
    h = fmt.parse_header(compressed, k)
    t2 = coding.decode_tables_2x(h.len_count, h.sorted_syms)
    t1 = coding.decode_tables_1x(h.len_count, h.sorted_syms)
    sizes = fmt.slice_sizes(h.raw_size, k)
    obounds = np.concatenate([[0], np.cumsum(sizes)])
    payload = np.frombuffer(h.payload, dtype=np.uint8)
    out = np.zeros(h.raw_size, dtype=np.uint8)
    start = 0
    for i in range(k):
        end = int(h.end_offsets[i])
        out[obounds[i] : obounds[i + 1]] = _decode_stream(payload[start:end], int(sizes[i]), t2, t1)
        start = end
    return out.tobytes()


class GoldenCodec:
    """The oracle as a bytes codec (compress / decompress, name)."""

    def __init__(self, k: int):
        self.k = k

    def compress(self, raw: bytes) -> bytes:
        return compress(raw, self.k)

    def decompress(self, blob: bytes) -> bytes:
        return decompress(blob, self.k)

    @property
    def name(self) -> str:
        return f"Golden<{self.k}>"
