"""The ``ref`` profile's wire format: header and stream framing, the same
bytes as ``huffman_tpu/format.py``.

    u32  raw_size                  (LE)
    u32  len_mask                  (LE; bit l set <=> some code has length l)
    u8   count[popcount(len_mask)] (ascending length; 0 with a single
                                    length means 256 codes of length 8)
    u8   syms[num_syms]            (by length asc, count desc)
    u32  end_offset[K-1]           (LE; cumulative end of each stream's
                                    region, from the payload's start)
    u8   payload[...]              (K regions back to back)

A region is ``ceil(stream_bits / 8) + STREAM_SLOP`` bytes, its stream
written backward: stream byte i (bits MSB-first) at ``region_end - 1 - i``.
The low ``STREAM_SLOP`` bytes of a region are never read.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .constants import MAX_CODE_LEN, STREAM_SLOP


def slice_sizes(length: int, k: int) -> np.ndarray:
    """``length`` split into ``k`` slices: the first ``length % k`` take
    one byte more than the rest.  int64[k]."""
    sizes = np.full(k, length // k, dtype=np.int64)
    sizes[: length % k] += 1
    return sizes


@dataclasses.dataclass
class ParsedHeader:
    raw_size: int
    len_count: np.ndarray  # uint16[MAX_CODE_LEN+1]
    sorted_syms: np.ndarray  # uint8[num_syms]
    num_syms: int
    end_offsets: np.ndarray  # int64[K], cumulative, from the payload's start
    payload: memoryview  # the K stream regions


def stream_region_sizes(per_stream_bits: np.ndarray) -> np.ndarray:
    """Each stream's region: ceil(bits / 8) + slop bytes.  int64."""
    bits = np.asarray(per_stream_bits, dtype=np.int64)
    return (bits + 7) // 8 + STREAM_SLOP


def write_header(
    raw_size: int,
    len_count: np.ndarray,
    len_mask: int,
    sorted_syms: np.ndarray,
    end_offsets: np.ndarray,
) -> bytes:
    """The header's bytes.  ``end_offsets`` is the cumulative array; its
    last entry is implied by the payload's size and not stored."""
    counts = bytes(int(c) & 0xFF for c in len_count[: MAX_CODE_LEN + 1] if c)  # 256 -> 0
    offsets = np.asarray(end_offsets[:-1], dtype=np.int64)
    if len(offsets) and (offsets.min() < 0 or offsets.max() >= 1 << 32):
        raise struct.error("end offset does not fit a u32")
    return (
        struct.pack("<II", raw_size, len_mask)
        + counts
        + np.asarray(sorted_syms, dtype=np.uint8).tobytes()
        + offsets.astype("<u4").tobytes()
    )


def parse_header(compressed: bytes | memoryview, k: int) -> ParsedHeader:
    """Parse a header written by `write_header`; every structural field is
    checked, and corrupt input raises ValueError."""
    buf = memoryview(compressed)
    if len(buf) < 8:
        raise ValueError("blob too short for header")
    raw_size, len_mask = struct.unpack_from("<II", buf, 0)
    if len_mask >> (MAX_CODE_LEN + 1):
        raise ValueError("len_mask has lengths beyond MAX_CODE_LEN")
    pos = 8
    len_count = np.zeros(MAX_CODE_LEN + 1, dtype=np.uint16)
    one_size = bin(len_mask).count("1") == 1
    num_syms = 0
    for ln in range(MAX_CODE_LEN + 1):
        if len_mask & (1 << ln):
            if pos >= len(buf):
                raise ValueError("truncated length counts")
            c = buf[pos]
            pos += 1
            if c == 0:
                if not (one_size and ln == 8):
                    raise ValueError("count overflow only legal for 256 8-bit codes")
                c = 256
            len_count[ln] = c
            num_syms += c
    if num_syms > 256:
        raise ValueError(f"{num_syms} symbols > 256")
    if num_syms == 0 and raw_size != 0:
        raise ValueError("no symbols but nonzero raw size")
    if num_syms >= 2:
        if len_count[0]:
            raise ValueError("zero-length codes are invalid")
        kraft = int(
            (len_count.astype(np.int64) << (MAX_CODE_LEN - np.arange(MAX_CODE_LEN + 1))).sum()
        )
        if kraft != 1 << MAX_CODE_LEN:
            raise ValueError("length counts violate Kraft equality")
    if pos + num_syms > len(buf):
        raise ValueError("truncated symbol table")
    sorted_syms = np.frombuffer(buf[pos : pos + num_syms], dtype=np.uint8).copy()
    pos += num_syms
    if pos + 4 * (k - 1) > len(buf):
        raise ValueError("truncated stream offsets")
    end_offsets = np.zeros(k, dtype=np.int64)
    end_offsets[: k - 1] = np.frombuffer(buf[pos : pos + 4 * (k - 1)], dtype="<u4")
    pos += 4 * (k - 1)
    payload = buf[pos:]
    end_offsets[k - 1] = len(payload)
    if (np.diff(end_offsets, prepend=0) < 0).any() or (end_offsets > len(payload)).any():
        raise ValueError("stream offsets not monotonically within payload")
    # Every symbol costs at least one payload bit: a corrupt raw_size may
    # not make a decoder allocate more than 8x the payload.
    if num_syms >= 2 and raw_size > 8 * len(payload):
        raise ValueError("raw_size exceeds payload bit capacity")
    return ParsedHeader(
        raw_size=raw_size,
        len_count=len_count,
        sorted_syms=sorted_syms,
        num_syms=num_syms,
        end_offsets=end_offsets,
        payload=payload,
    )
