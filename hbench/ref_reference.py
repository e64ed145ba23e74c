"""Plain NumPy reference of the ``ref`` profile's blob: the K-stream wire
format that the reference library (``ahartik/huffman-avx512``) defines,
worked out from the input alone, and a reader of it at any K.

The blob of n bytes at K streams, as the library describes it:

* the table: the exact 256-bin count of the block; symbols sorted by
  count descending, ties by symbol ascending; the unlimited Huffman
  lengths of the two-queue build (on equal weights a leaf is merged
  before a tree); then the "MiniZ" cap at 12 bits (``kMaxCodeLength``,
  ``huffman.cpp:38, 294-327``): every longer code goes into length 12,
  then, while the Kraft sum exceeds one, one code of length 12 is
  dropped and the deepest shorter code split into two one bit longer;
  canonical codes in that order, ``code += 1 << (12 - len)``
  (``huffman.cpp:260-284``);
* the slices: slice i is stream i; the first ``n % K`` slices take one
  byte more than the rest;
* each stream: its slice's codes MSB-first, written backward into a
  region of ``ceil(bits / 8) + 8`` bytes (stream byte i at
  ``region_end - 1 - i``), the low 8 bytes zero;
* the header: u32 raw size and u32 length mask (bit l set where some code
  has length l), little-endian; one u8 count a set length, ascending (0
  with one length alone means 256 codes of length 8); the symbols by
  length ascending, then count descending; K - 1 u32 cumulative end
  offsets of the regions from the payload's start; the payload.

Departures from the published description: the library asserts that the
unlimited lengths stay within ``kMaxOptimalCodeLength = 32``; here any
depth is capped alike.  A block of one symbol gets that symbol a code of
length 0 (mask bit 0, empty streams), and an empty block no symbol, as
the format's writers code them.

It imports neither ``jax`` nor anything of the program under test.  From
`reference` it takes the two-queue Huffman depths and the canonical
decode helpers.
"""

from __future__ import annotations

import struct

import numpy as np

from . import reference as R

#: The format's code-length limit and the zero bytes below each stream.
MAX_LEN, SLOP = 12, 8


def code_table(hist: np.ndarray, cap: int = MAX_LEN) -> dict:
    """The shared table of a 256-bin count, lengths capped at ``cap``:
    ``lens`` and ``codes`` by symbol (codes left-aligned in 12 bits),
    ``ranked`` (the header's symbol order) and ``len_count`` (13,)."""
    h = np.asarray(hist, np.int64)
    ranked = sorted((s for s in range(256) if h[s] > 0), key=lambda s: (-h[s], s))
    len_count = np.zeros(MAX_LEN + 1, np.int64)
    if len(ranked) == 1:
        len_count[0] = 1
    elif ranked:
        depths = np.bincount(R._huffman_depths([int(h[s]) for s in reversed(ranked)]))
        len_count[: min(len(depths), cap + 1)] = depths[: cap + 1]
        len_count[cap] += depths[cap + 1 :].sum()
        total = sum(int(len_count[ln]) << (cap - ln) for ln in range(1, cap + 1))
        while total > 1 << cap:
            len_count[cap] -= 1
            j = max(ln for ln in range(1, cap) if len_count[ln])
            len_count[j] -= 1
            len_count[j + 1] += 2
            total -= 1
    lens, codes = R.canonical_from_counts(len_count, ranked, MAX_LEN)
    return {"lens": lens, "codes": codes, "ranked": np.array(ranked, np.int64),
            "len_count": len_count}


def _flip_regions(buf: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Each region of ``buf`` (lane after lane, ``regions`` bytes each)
    reversed in place of itself: the stored regions from the forward ones,
    and back."""
    ends = np.cumsum(regions)
    turn = (ends - regions) + (ends - 1)  # a region's first byte plus its last
    return buf[turn[np.repeat(np.arange(len(regions)), regions)] - np.arange(len(buf))]


def compress(raw, k: int, cap: int = MAX_LEN) -> dict:
    """The blob of ``raw`` at k streams (``cap`` below 12 only for the
    control): ``blob``, and the ``lens``, ``codes`` and ``regions`` (k,)
    it was made from."""
    data = raw if isinstance(raw, np.ndarray) else np.frombuffer(raw, np.uint8)
    n = len(data)
    t = code_table(np.bincount(data, minlength=256), cap)
    # Column j holds slice j; symbol 256, of no bits, pads the short ones
    # and makes the rows even.
    b, r = divmod(n, k)
    s = -(-n // k)
    rows = np.full((s + s % 2, k), 256, np.uint16)
    if r:
        rows[:s, :r] = data[: r * (b + 1)].reshape(r, b + 1).T
    rows[:b, r:] = data[r * (b + 1) :].reshape(k - r, b).T
    # (code << 4 | length) by symbol, the code in its own length's bits.
    enc = np.zeros(257, np.int64)
    enc[:256] = (t["codes"] >> (MAX_LEN - t["lens"])) << 4 | t["lens"]
    # Each lane's codes MSB-first into u32 words, two rows at a time (at
    # most 24 bits, so at most two words); the codes' bit ranges are
    # disjoint, so the parts are added to the words they fall in.
    w32 = (s * MAX_LEN + 31) // 32 + 2
    words = np.zeros(w32 * k, np.uint32)  # (w32, k): a row's lanes write near each other
    pos = np.zeros(k, np.int64)
    lane = np.arange(k)
    for first, second in zip(rows[0::2], rows[1::2]):
        e0, e1 = enc[first], enc[second]
        ln = (e0 & 15) + (e1 & 15)
        val = (e0 >> 4 << (e1 & 15) | e1 >> 4).astype(np.uint64)
        v64 = val << (64 - (pos & 31) - ln).astype(np.uint64)
        at = (pos >> 5) * k + lane
        words[at] += (v64 >> np.uint64(32)).astype(np.uint32)
        words[at + k] += (v64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pos += ln
    regions = (pos + 7) // 8 + SLOP
    # Each lane's stream forward, zeros past it, cut to its region.
    lanes = np.ascontiguousarray(words.reshape(w32, k).T).astype(">u4").view(np.uint8)
    lanes = lanes.reshape(k, 4 * w32)
    fwd = lanes[np.arange(4 * w32)[None, :] < regions[:, None]]
    lc = t["len_count"]
    mask = sum(1 << length for length in range(MAX_LEN + 1) if lc[length])
    header = (struct.pack("<II", n, mask) + bytes(int(c) & 0xFF for c in lc if c)
              + t["ranked"].astype(np.uint8).tobytes()
              + np.cumsum(regions)[:-1].astype("<u4").tobytes())
    return {"blob": header + _flip_regions(fwd, regions).tobytes(), "lens": t["lens"],
            "codes": t["codes"], "regions": regions}


def parse(blob: bytes, k: int) -> dict:
    """The header of a blob at k streams: ``raw_size``, ``len_count``,
    ``ranked``, ``regions`` (k,) and ``payload``; raises `R.Refused`
    where it breaks the layout."""
    if len(blob) < 8:
        raise R.Refused("blob too short")
    raw_size, mask = struct.unpack_from("<II", blob, 0)
    if mask >> (MAX_LEN + 1):
        raise R.Refused("a length over 12")
    one_size = bin(mask).count("1") == 1
    pos = 8
    len_count = np.zeros(MAX_LEN + 1, np.int64)
    for ln in range(MAX_LEN + 1):
        if mask >> ln & 1:
            if pos >= len(blob):
                raise R.Refused("truncated length counts")
            c = blob[pos]
            pos += 1
            if c == 0 and not (one_size and ln == 8):
                raise R.Refused("a zero count")
            len_count[ln] = c or 256
    nsym = int(len_count.sum())
    if pos + nsym + 4 * (k - 1) > len(blob):
        raise R.Refused("truncated symbols or end offsets")
    ranked = np.frombuffer(blob, np.uint8, nsym, pos).astype(np.int64)
    pos += nsym
    ends = np.zeros(k, np.int64)
    ends[:-1] = np.frombuffer(blob, "<u4", k - 1, pos)
    pos += 4 * (k - 1)
    payload = np.frombuffer(blob, np.uint8, len(blob) - pos, pos)
    ends[-1] = len(payload)
    regions = np.diff(ends, prepend=0)
    if (regions < SLOP).any():
        raise R.Refused("a region shorter than its slop")
    return {"raw_size": raw_size, "len_count": len_count, "ranked": ranked, "regions": regions,
            "payload": payload}


def decode(h: dict, k: int) -> np.ndarray:
    """The raw bytes of a parsed blob; raises `R.Refused` where a stream
    does not hold its slice's codes."""
    n, nsym = h["raw_size"], len(h["ranked"])
    if n == 0:
        return np.zeros(0, np.uint8)
    if nsym == 0:
        raise R.Refused("no symbol for a non-empty block")
    if nsym == 1:
        return np.full(n, h["ranked"][0], np.uint8)
    if h["len_count"][0]:
        raise R.Refused("a code of length 0 beside others")
    if n > 8 * len(h["payload"]):
        raise R.Refused("more symbols than the payload has bits")
    lens, codes = R.canonical_from_counts(h["len_count"], h["ranked"], MAX_LEN)
    sym_of, len_of = R.decode_table(lens, codes, MAX_LEN)
    entry = sym_of | len_of << 8
    regions = h["regions"]
    # Every stream read forward from its region's first byte, through a
    # big-endian 32-bit window at each byte.
    buf = np.concatenate([_flip_regions(h["payload"], regions), np.zeros(4, np.uint8)])
    buf = buf.astype(np.int64)
    window = buf[:-3] << 24 | buf[1:-2] << 16 | buf[2:-1] << 8 | buf[3:]
    start = 8 * (np.cumsum(regions) - regions)
    pos = start.copy()
    out = np.zeros((-(-n // k), k), np.uint8)
    b, r = divmod(n, k)
    for step in range(out.shape[0]):
        live = slice(None) if step < b else slice(0, r)  # the last row: the long slices
        p = pos[live]
        word = window[np.minimum(p >> 3, len(window) - 1)]
        e = entry[(word << (p & 7)) >> (32 - MAX_LEN) & ((1 << MAX_LEN) - 1)]
        out[step, live] = e & 0xFF
        pos[live] = p + (e >> 8)
    if (pos - start > 8 * (regions - SLOP)).any():
        raise R.Refused("a stream reads past its region")
    return np.concatenate([out[:, :r].T.reshape(-1), out[:b, r:].T.reshape(-1)])


def read(blob: bytes, k: int) -> np.ndarray:
    """The raw bytes of a blob at k streams."""
    return decode(parse(blob, k), k)
