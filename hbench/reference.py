"""Plain NumPy reference of what the benchmark's cells produce.

It works every output out again from the inputs alone: the table
histogram (every byte, or the strided row sample plus one a bin), the
length-limited canonical Huffman code, the lane encode (byte ``i`` to
lane ``i % k``, codes MSB-first in u32 words, zero past each lane's end),
and a reader of HTP3 blobs (compact payload, flat or entropy-coded bit
counts), of the 8-stream ref-profile blob those counts ride in, and of
the HTPC block container.  The writer (`write_htp3`, `write_container`)
serves the control only.  It imports neither ``jax`` nor anything of the
program under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

HTP3_MAGIC = 0x48545033
#: Header flags (top byte of the length-mask word): compact payload,
#: entropy-coded bit counts.
FLAG_COMPACT, FLAG_HUFF_COUNTS = 1 << 25, 1 << 26
HTPC_MAGIC = b"HTPC"
KIND_HUFF, KIND_STORED, KIND_CRC = 0x48, 0x53, 0x43
#: The ref-profile blob of entropy-coded bit counts: its stream count and
#: code-length cap.
COUNT_STREAMS, COUNT_MAX_LEN = 8, 12


class Refused(ValueError):
    """A blob the reference cannot read."""


# ---------- tables ----------


def table_histogram(block: np.ndarray, n_raw: int, sample: dict | None) -> np.ndarray:
    """(256,) int64 counts the table of the padded ``block`` comes from.

    ``sample`` (a configuration's ``table_sample``): from ``from_bytes``
    raw bytes up, rows 0, every_nth_row, 2 * every_nth_row, ... of
    ``row_bytes`` bytes, plus ``plus_one`` in every bin; ``None`` or a
    smaller block counts every byte."""
    n = len(block)
    if sample and n_raw >= sample["from_bytes"]:
        row, pitch = sample["row_bytes"], sample["row_bytes"] * sample["every_nth_row"]
        rows = n // pitch
        if rows:
            rows_sample = block[: rows * pitch].reshape(rows, pitch)[:, :row]
            return np.bincount(rows_sample.reshape(-1), minlength=256).astype(np.int64) + sample[
                "plus_one"
            ]
    return np.bincount(block, minlength=256).astype(np.int64)


def _huffman_depths(weights: list[int]) -> list[int]:
    """Leaf depths of the Huffman tree of ``weights`` (ascending), built
    with two queues: on equal weights a leaf is merged before a tree."""
    leaves = [(w, ("leaf", i)) for i, w in enumerate(weights)]
    trees: list = []
    li = ti = 0

    def take():
        nonlocal li, ti
        if ti < len(trees) and (li >= len(leaves) or trees[ti][0] < leaves[li][0]):
            ti += 1
            return trees[ti - 1]
        li += 1
        return leaves[li - 1]

    while (len(leaves) - li) + (len(trees) - ti) > 1:
        a, b = take(), take()
        trees.append((a[0] + b[0], ("node", a, b)))
    depths = [0] * len(weights)
    stack = [(trees[-1] if trees else leaves[0], 0)]
    while stack:
        (_, node), d = stack.pop()
        if node[0] == "leaf":
            depths[node[1]] = d
        else:
            stack.append((node[1], d + 1))
            stack.append((node[2], d + 1))
    return depths


def code_table(hist: np.ndarray, max_len: int = 15) -> dict:
    """The canonical code of a histogram, as the tpu profile defines it.

    Counts under total >> max_len (at least 1) are raised to it; symbols
    rank by count descending, symbol ascending; Huffman depths over 16 are
    cut to ``max_len`` and the Kraft excess repaid by lengthening the
    longest code shorter than ``max_len``; the lengths go to the ranks in
    ascending order and the codes are canonical in rank order.  Returns
    ``lens``, ``codes`` (left-aligned in ``max_len`` bits), ``enc``
    (``code << 4 | len``, the program's table layout), ``ranked`` and
    ``len_count``."""
    h = np.asarray(hist, dtype=np.int64)
    floor = max(int(h.sum()) >> max_len, 1)
    cnt = np.where(h > 0, np.maximum(h, floor), 0)
    ranked = sorted((s for s in range(256) if cnt[s] > 0), key=lambda s: (-cnt[s], s))
    n = len(ranked)
    len_count = np.zeros(max_len + 1, np.int64)
    if n == 1:
        len_count[0] = 1
    elif n > 1:
        depths = _huffman_depths([int(cnt[s]) for s in reversed(ranked)])
        lc = np.bincount(depths, minlength=max_len + 1).astype(np.int64)
        len_count[:] = lc[: max_len + 1]
        len_count[max_len] += lc[max_len + 1 :].sum()
        kraft = int((len_count << (max_len - np.arange(max_len + 1))).sum())
        while kraft > 1 << max_len:
            len_count[max_len] -= 1
            j = max(d for d in range(max_len) if len_count[d] > 0)
            len_count[j] -= 1
            len_count[j + 1] += 2
            kraft -= 1
    lens = np.zeros(256, np.int64)
    codes = np.zeros(256, np.int64)
    by_rank = [ln for ln in range(max_len + 1) for _ in range(int(len_count[ln]))]
    code = 0
    for s, ln in zip(ranked, by_rank):
        lens[s], codes[s] = ln, code
        code += 1 << (max_len - ln)
    return {
        "lens": lens,
        "codes": codes,
        "enc": (codes << 4) | lens,
        "ranked": np.array(ranked, np.int64),
        "len_count": len_count,
    }


def canonical_from_counts(len_count, ranked, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(lens, codes) per symbol of a stored table: ``len_count[l]`` codes
    of length l, to the symbols of ``ranked`` in order."""
    lens = np.zeros(256, np.int64)
    codes = np.zeros(256, np.int64)
    code, i = 0, 0
    for ln in range(max_len + 1):
        for _ in range(int(len_count[ln])):
            s = int(ranked[i])
            lens[s], codes[s] = ln, code
            code += 1 << (max_len - ln)
            i += 1
    if i > 1 and code != 1 << max_len:
        raise Refused("length counts violate Kraft equality")
    return lens, codes


# ---------- lanes ----------


def lane_shape(n: int, k: int, max_len: int = 15) -> tuple[int, int]:
    """(s, w32): symbols a lane and u32 words a lane of an n-byte block."""
    s = -(-n // k)
    return s, (s * max_len + 31) // 32 + 1


def pad_lanes(blocks: np.ndarray, k: int) -> np.ndarray:
    """(B, n) bytes zero-padded to whole rows of k lanes, (B, s * k)."""
    s = -(-blocks.shape[1] // k)
    if s * k == blocks.shape[1]:
        return blocks
    padded = np.zeros((blocks.shape[0], s * k), np.uint8)
    padded[:, : blocks.shape[1]] = blocks
    return padded


def encode_lanes(blocks: np.ndarray, lens: np.ndarray, codes: np.ndarray, k: int, max_len: int = 15):
    """Encode each row of (B, s * k) uint8 ``blocks`` (`pad_lanes`) with its
    row of (B, 256) ``lens`` / ``codes``.  Returns (words (B, w32, k)
    uint32, bits (B, k) int64)."""
    bcount, n = blocks.shape
    s, w32 = lane_shape(n, k, max_len)
    rows = blocks.reshape(bcount, s, k).astype(np.int64)
    words = np.zeros((bcount, w32, k), np.uint64)
    pos = np.zeros((bcount, k), np.int64)
    bi = np.arange(bcount)[:, None]
    ki = np.arange(k)[None, :]
    lens = np.asarray(lens, np.int64)
    codes = np.asarray(codes, np.int64)
    for r in range(s):
        sym = rows[:, r, :]
        ln = np.take_along_axis(lens, sym, 1)
        val = (np.take_along_axis(codes, sym, 1) >> (max_len - ln)).astype(np.uint64)
        v64 = val << (64 - (pos & 31) - ln).astype(np.uint64)
        w = pos >> 5
        words[bi, w, ki] |= v64 >> np.uint64(32)
        words[bi, w + 1, ki] |= v64 & np.uint64(0xFFFFFFFF)
        pos += ln
    return words.astype(np.uint32), pos


def decode_table(lens: np.ndarray, codes: np.ndarray, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, length) of every ``max_len``-bit window."""
    sym = np.zeros(1 << max_len, np.int64)
    length = np.zeros(1 << max_len, np.int64)
    for s in np.flatnonzero(lens):
        lo = int(codes[s])
        hi = lo + (1 << (max_len - int(lens[s])))
        sym[lo:hi], length[lo:hi] = s, lens[s]
    return sym, length


def decode_streams(stream: np.ndarray, starts: np.ndarray, steps: int, sym_of, len_of, max_len: int):
    """Decode ``steps`` symbols of every bit stream that starts at bit
    ``starts[j]`` of ``stream`` (MSB-first).  Returns (symbols (steps, L)
    uint8, end bit positions (L,))."""
    buf = np.concatenate([np.asarray(stream, np.uint8), np.zeros(8, np.uint8)]).astype(np.int64)
    pos = np.asarray(starts, np.int64).copy()
    out = np.zeros((steps, len(pos)), np.uint8)
    limit = 8 * (len(buf) - 8)
    mask = (1 << max_len) - 1
    for t in range(steps):
        b = np.minimum(pos >> 3, len(buf) - 3)
        win = (buf[b] << 16) | (buf[b + 1] << 8) | buf[b + 2]
        v = (win >> (24 - max_len - (pos & 7))) & mask
        out[t] = sym_of[v]
        pos += len_of[v]
    if (pos > limit).any():
        raise Refused("a lane reads past its stream")
    return out, pos


def lane_words_stream(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(W, K) u32 lane words as one byte stream, lane after lane, and
    each lane's first bit."""
    w, k = words.shape
    lanes = np.ascontiguousarray(words.astype(">u4").T).view(np.uint8).reshape(-1)
    return lanes, np.arange(k, dtype=np.int64) * 32 * w


# ---------- the ref-profile blob of the bit counts ----------


def read_count_blob(blob: bytes) -> np.ndarray:
    """The bytes of an 8-stream ref-profile blob: header (u32 raw size,
    u32 length mask, a count a set length, the symbols, 7 u32 stream end
    offsets), then 8 regions, each its stream written backward above 8
    zero bytes; stream j codes the j-th of 8 contiguous slices."""
    if len(blob) < 8:
        raise Refused("count blob too short")
    raw, mask = struct.unpack_from("<II", blob, 0)
    pos = 8
    len_count = np.zeros(COUNT_MAX_LEN + 1, np.int64)
    for ln in range(COUNT_MAX_LEN + 1):
        if mask >> ln & 1:
            len_count[ln] = blob[pos] or 256
            pos += 1
    if mask >> (COUNT_MAX_LEN + 1):
        raise Refused("count blob length mask")
    nsym = int(len_count.sum())
    ranked = np.frombuffer(blob, np.uint8, nsym, pos).astype(np.int64)
    pos += nsym
    ends = np.zeros(COUNT_STREAMS, np.int64)
    ends[:-1] = np.frombuffer(blob, "<u4", COUNT_STREAMS - 1, pos)
    pos += 4 * (COUNT_STREAMS - 1)
    payload = np.frombuffer(blob, np.uint8, len(blob) - pos, pos)
    ends[-1] = len(payload)
    sizes = np.full(COUNT_STREAMS, raw // COUNT_STREAMS, np.int64)
    sizes[: raw % COUNT_STREAMS] += 1
    if nsym == 1:
        return np.full(raw, ranked[0], np.uint8)
    lens, codes = canonical_from_counts(len_count, ranked, COUNT_MAX_LEN)
    starts = np.concatenate([[0], ends[:-1]])
    streams = [payload[a:b][::-1] for a, b in zip(starts, ends)]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in streams])])
    sym_of, len_of = decode_table(lens, codes, COUNT_MAX_LEN)
    syms, _ = decode_streams(
        np.concatenate(streams), offs[:-1] * 8, int(sizes.max()), sym_of, len_of, COUNT_MAX_LEN
    )
    return np.concatenate([syms[: sizes[j], j] for j in range(COUNT_STREAMS)])


# ---------- HTP3 ----------


def _unpack_fixed(buf: bytes, pos: int, count: int, width: int) -> tuple[np.ndarray, int]:
    nb = (count * width + 7) // 8
    if pos + nb > len(buf):
        raise Refused("truncated bit-count deltas")
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nb, pos), count=count * width)
    vals = (bits.reshape(count, width).astype(np.int64) << np.arange(width - 1, -1, -1)).sum(1)
    return vals, pos + nb


def read_htp3(blob: bytes, max_len: int = 15) -> dict:
    """An HTP3 blob read back: ``raw`` (the decoded bytes), ``k``,
    ``lens`` / ``codes`` of its table, ``bits`` (K,) of its lanes.  Raises
    `Refused` where the blob breaks the layout."""
    if len(blob) < 16:
        raise Refused("blob too short")
    magic, raw_size, k, word = struct.unpack_from("<IIII", blob, 0)
    if magic != HTP3_MAGIC:
        raise Refused("bad magic")
    mask = word & 0xFFFFFF
    if not word & FLAG_COMPACT:
        raise Refused("not a compact blob")
    pos = 16
    len_count = np.zeros(max_len + 1, np.int64)
    one_size = bin(mask).count("1") == 1
    for ln in range(max_len + 1):
        if mask >> ln & 1:
            c = blob[pos]
            pos += 1
            len_count[ln] = 256 if c == 0 and one_size else c
    nsym = int(len_count.sum())
    ranked = np.frombuffer(blob, np.uint8, nsym, pos).astype(np.int64)
    pos += nsym
    if nsym <= 1:
        sym = int(ranked[0]) if nsym else 0
        return {
            "raw": np.full(raw_size, sym, np.uint8), "k": k, "lens": np.zeros(256, np.int64),
            "codes": np.zeros(256, np.int64), "bits": np.zeros(k, np.int64), "ranked": ranked,
        }
    lens, codes = canonical_from_counts(len_count, ranked, max_len)
    if word & FLAG_HUFF_COUNTS:
        base, width, clen = struct.unpack_from("<IBI", blob, pos)
        pos += 9
        d8 = read_count_blob(blob[pos : pos + clen])
        pos += clen
        if len(d8) != k:
            raise Refused("count blob holds the wrong number of lanes")
        deltas = d8.astype(np.int64)
        n_esc = int((d8 == 255).sum())
        if n_esc:
            deltas[d8 == 255], pos = _unpack_fixed(blob, pos, n_esc, width)
    else:
        base, width = struct.unpack_from("<IB", blob, pos)
        pos += 5
        deltas = np.zeros(k, np.int64)
        if width:
            deltas, pos = _unpack_fixed(blob, pos, k, width)
    bits = base + deltas
    s = -(-raw_size // k)
    starts = np.concatenate([[0], np.cumsum(bits)[:-1]])
    payload = np.frombuffer(blob, np.uint8, len(blob) - pos, pos)
    if int(bits.sum()) > 8 * len(payload):
        raise Refused("payload shorter than its bit counts")
    sym_of, len_of = decode_table(lens, codes, max_len)
    syms, end = decode_streams(payload, starts, s, sym_of, len_of, max_len)
    if not np.array_equal(end - starts, bits):
        raise Refused("a lane's codes do not fill its bit count")
    return {
        "raw": syms.reshape(-1)[:raw_size], "k": k, "lens": lens, "codes": codes, "bits": bits,
        "ranked": ranked,
    }


def write_htp3(raw_size: int, k: int, table: dict, words: np.ndarray, bits: np.ndarray, max_len: int = 15) -> bytes:
    """A compact HTP3 blob with flat bit counts, from lane words (W, K)."""
    lc = table["len_count"]
    mask = sum(1 << ln for ln in range(max_len + 1) if lc[ln])
    out = bytearray(struct.pack("<IIII", HTP3_MAGIC, raw_size, k, mask | FLAG_COMPACT))
    out += bytes(int(c) & 0xFF for c in lc if c)
    out += table["ranked"].astype(np.uint8).tobytes()
    if len(table["ranked"]) <= 1:
        return bytes(out)
    bits = np.asarray(bits, np.int64)
    base = int(bits.min())
    deltas = bits - base
    width = int(deltas.max()).bit_length()
    out += struct.pack("<IB", base, width)
    if width:
        out += np.packbits(((deltas[:, None] >> np.arange(width - 1, -1, -1)) & 1).astype(np.uint8)).tobytes()
    lanes = np.unpackbits(np.ascontiguousarray(words.astype(">u4").T).view(np.uint8), axis=1)
    keep = np.arange(lanes.shape[1])[None, :] < bits[:, None]
    out += np.packbits(lanes[keep]).tobytes()
    return bytes(out)


# ---------- HTPC ----------


def read_container(blob: bytes, max_len: int = 15) -> tuple[bytes, list[dict]]:
    """(the raw bytes, each 'H' record's `read_htp3` with its block's
    offset and raw length) of an HTPC container; checks the total and the
    crc trailer."""
    if blob[:4] != HTPC_MAGIC:
        raise Refused("bad container magic")
    block_size, total = struct.unpack_from("<IQ", blob, 4)
    pos, parts, blocks, crc = 16, [], [], None
    at = 0
    while pos < len(blob):
        rec_len, raw_len, kind = struct.unpack_from("<IIB", blob, pos)
        pos += 12
        rec = blob[pos : pos + rec_len]
        pos += rec_len
        if kind == KIND_HUFF:
            got = read_htp3(rec, max_len)
            blocks.append(dict(got, offset=at, raw_len=raw_len))
            parts.append(got["raw"][:raw_len].tobytes())
        elif kind == KIND_STORED:
            parts.append(rec)
        elif kind == KIND_CRC:
            crc = struct.unpack("<I", rec)[0]
        else:
            raise Refused(f"record kind {kind:#x}")
        at += raw_len
    raw = b"".join(parts)
    if len(raw) != total:
        raise Refused("container total size")
    if crc is None or zlib.crc32(raw) & 0xFFFFFFFF != crc:
        raise Refused("container crc")
    return raw, blocks


def write_container(blobs: list[tuple[int, bytes]], raw: bytes, block_size: int) -> bytes:
    """An HTPC container of (raw_len, HTP3 blob) records and the crc."""
    out = bytearray(HTPC_MAGIC + struct.pack("<IQ", block_size, len(raw)))
    for raw_len, blob in blobs:
        out += struct.pack("<IIB3x", len(blob), raw_len, KIND_HUFF) + blob
    out += struct.pack("<IIB3x", 4, 0, KIND_CRC) + struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF)
    return bytes(out)
