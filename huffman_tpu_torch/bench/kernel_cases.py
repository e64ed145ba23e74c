"""Inputs that hold the table, decode, encode and histogram kernels to
their plain versions where they are hardest to get right, and the fuzz
battery of ``tests/test_fuzz.py`` (random sizes, lane counts and byte
styles; mutated and truncated blobs).

``chip_smoke.py`` runs them through the CUDA kernels on the card; the
CPU tests run them through the plain versions and the JAX package.
Every generator is numpy only and made from a seed.
"""

from __future__ import annotations

import struct

import numpy as np

from .workloads import biased_u8

N_SYMBOLS = 256
WINDOW_BITS = 15  # TPU_MAX_CODE_LEN: a decode window


def _fib(n: int) -> list[int]:
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return f[:n]


def fibonacci_hist() -> np.ndarray:
    """20 Fibonacci counts: a tree 19 deep, folded and repaired to 15 bits."""
    return np.array(_fib(20)[::-1] + [0] * (N_SYMBOLS - 20), np.int64)


def fixed_hists() -> dict[str, np.ndarray]:
    """Named tables at the edges of the coding: empty, one symbol,
    256 equal counts (8-bit codes), Fibonacci, and two symbols (1 bit)."""
    two = np.zeros(N_SYMBOLS, np.int64)
    two[[7, 200]] = [5, 3]
    return {
        "empty": np.zeros(N_SYMBOLS, np.int64),
        "single": np.eye(1, N_SYMBOLS, 65, dtype=np.int64).ravel() * 1000,
        "equal": np.full(N_SYMBOLS, 17, np.int64),
        "fibonacci": fibonacci_hist(),
        "one_bit": two,
    }


def table_hists(count: int = 2000, seed: int = 0) -> np.ndarray:
    """(count, 256) int32 histograms: `fixed_hists` first, then random
    rows that cycle through six kinds, each with its own number of
    present symbols (1 to 256 over the batch):

    - counts 1..99;
    - counts 1..3, so most weights tie;
    - shuffled Fibonacci counts of 16 to 24 symbols, whose trees pass 15
      bits and need the fold and the repair;
    - a total just below 2^30, one large count beside small ones;
    - geometric counts (p = 0.01);
    - one count shared by every present symbol.
    """
    rng = np.random.default_rng(seed)
    rows = list(fixed_hists().values())
    fib = _fib(24)
    for i in range(count - len(rows)):
        kind = i % 6
        m = 1 + (i * 37) % N_SYMBOLS
        if kind == 2:
            m = 16 + i % 9
        present = rng.choice(N_SYMBOLS, size=m, replace=False)
        if kind == 0:
            vals = rng.integers(1, 100, m)
        elif kind == 1:
            vals = rng.integers(1, 4, m)
        elif kind == 2:
            vals = rng.permutation(np.array(fib[:m]))
        elif kind == 3:
            vals = rng.integers(1, 1 << 12, m)
            vals[0] = (1 << 30) - 1 - int(vals[1:].sum()) - int(rng.integers(0, 1 << 10))
        elif kind == 4:
            vals = rng.geometric(0.01, m)
        else:
            vals = np.full(m, int(rng.integers(1, 1 << 20)))
        h = np.zeros(N_SYMBOLS, np.int64)
        h[present] = vals
        rows.append(h)
    out = np.stack(rows)
    assert (out.sum(axis=1) < 1 << 30).all()
    return out.astype(np.int32)


def decode_hists(sampled: np.ndarray) -> dict[str, np.ndarray]:
    """The tables whose decode is checked over every window: the 16 MiB
    block's sampled table (given), Fibonacci (15-bit codes), two symbols
    (1 bit), 256 equal counts (8 bits) and one symbol (length 0)."""
    fixed = fixed_hists()
    return {
        "sampled": np.asarray(sampled, np.int64),
        "fibonacci": fixed["fibonacci"],
        "one_bit": fixed["one_bit"],
        "equal": fixed["equal"],
        "single": fixed["single"],
    }


def window_words(k: int = 1 << WINDOW_BITS, rows: int = 3, seed: int = 0) -> np.ndarray:
    """(rows, k) int32 lane words (u32 bit patterns): lane i's first word
    starts with the 15-bit window i mod 2^15, so k = 2^15 lanes start
    with every window once; its other bits and later words are random."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(rows, k), dtype=np.uint64).astype(np.uint32)
    lanes = np.arange(k, dtype=np.uint32) % (1 << WINDOW_BITS)
    w[0] = (lanes << (32 - WINDOW_BITS)) | (w[0] & ((1 << (32 - WINDOW_BITS)) - 1))
    return w.view(np.int32)


def escape_block(n: int, seed: int = 0) -> np.ndarray:
    """(n,) uint8: the 20 symbols of `fibonacci_hist` fed uniformly: 9 of
    them have codes longer than 11 bits (the decode's escapes), which
    carry most of the bits."""
    return np.random.default_rng(seed).integers(0, 20, n).astype(np.uint8)


def lane_skewed_block(s: int, k: int, seed: int = 0) -> np.ndarray:
    """(s*k,) uint8 for the `fibonacci_hist` table, byte i in lane i % k:
    odd lanes take one of its 15-bit codes (symbols 12-19) with a chance
    from 0 to 1 that steps with the lane, even lanes only its 1-bit code
    (symbol 0), so the lanes of one warp reach a word row far apart."""
    rng = np.random.default_rng(seed)
    lane = np.arange(k)
    p_long = (lane % 2) * ((lane // 2) % 16) / 15
    long_code = rng.random((s, k)) < p_long
    return np.where(long_code, rng.integers(12, 20, (s, k)), 0).astype(np.uint8).reshape(-1)


def encode_cases(small: bool = False, seed: int = 0) -> dict[str, dict]:
    """The encode's hard inputs: name -> {"data": (offset + s*k,) uint8,
    "offset": bytes before the block (the block is ``data[offset:]``, an
    unaligned view where offset > 0), "s", "k", "hist": (256,) counts
    whose table encodes it}.  ``small`` gives the CPU tests' sizes; the
    other sizes reach each path of the CUDA kernel: the lane-skewed and
    escape-heavy blocks at the 16 MiB block's shape (tiles of 16-byte
    copies and stores), the same shape offset by 3 bytes (every row
    staged from unaligned chunks), K = 8 with S = 4096 (lanes too long
    for a tile), K = 24 with an odd S (one partial tile, rows of shifting
    alignment, a last stage of odd rows), and an offset view at K = 1001
    (4-byte stores)."""
    fib = fibonacci_hist()
    shapes = {  # name -> (s, k, offset), card / small
        "lane-skewed": ((128, 131072, 0), (40, 64, 0)),
        "escape-heavy": ((128, 131072, 0), (32, 64, 0)),
        "K=8, long S": ((4096, 8, 0), (1200, 8, 0)),
        "K=24": ((201, 24, 0), (51, 24, 0)),
        "offset view, K=1001": ((100, 1001, 1), (9, 101, 1)),
        "offset view, 16 MiB": ((128, 131072, 3), (16, 64, 3)),
    }
    out = {}
    for i, (name, sizes) in enumerate(shapes.items()):
        s, k, offset = sizes[small]
        if name == "lane-skewed":
            block, hist = lane_skewed_block(s, k, seed + i), fib
        elif name == "escape-heavy":
            block, hist = escape_block(s * k, seed + i), fib
        else:
            block = biased_u8(s * k, seed + i)
            hist = np.bincount(block, minlength=N_SYMBOLS) + 1
        data = np.concatenate([np.zeros(offset, np.uint8), block])
        out[name] = {"data": data, "offset": offset, "s": s, "k": k,
                     "hist": np.asarray(hist, np.int64)}
    return out


def hist_blocks(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Blocks for the histogram beside the encode's: every byte one value
    (one bin takes all n) and uniform bytes."""
    return {
        "constant": np.full(n, 0xA5, np.uint8),
        "uniform": np.random.default_rng(seed).integers(0, N_SYMBOLS, n, dtype=np.uint8),
    }


# ---------- the fuzz battery (tests/test_fuzz.py) ----------

FUZZ_STYLES = ("uniform", "biased", "runs", "few")


def fuzz_bytes(rng: np.random.Generator, style: str, n: int) -> np.ndarray:
    """Up to n uint8 of one byte style, drawn from ``rng``: uniform, the
    biased distribution, runs of 1-49 bytes over 8 values (may fall
    short of n), or three values."""
    if style == "uniform":
        return rng.integers(0, 256, size=n, dtype=np.uint8)
    if style == "biased":
        p = 0.8 ** np.arange(256) * 0.2
        p /= p.sum()
        return rng.choice(256, size=n, p=p).astype(np.uint8)
    if style == "runs":
        reps = rng.integers(1, 50, size=max(n // 10, 1))
        vals = rng.integers(0, 8, size=reps.size)
        return np.repeat(vals, reps).astype(np.uint8)[:n]
    if style == "few":
        return rng.choice([7, 200, 201], size=n).astype(np.uint8)
    raise ValueError(style)


def _battery(seed, count, n_range, lanes, strides=None) -> list[dict]:
    """tests/test_fuzz.py's loop: {"n", "k", "style", "raw"} cases (and
    "stride" with ``strides``), the styles in turn; ``raw`` may be
    shorter than n (runs)."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(count):
        n = int(rng.integers(*n_range))
        style = FUZZ_STYLES[i % 4]
        raw = fuzz_bytes(rng, style, n).tobytes()[:n]
        case = {"n": n, "k": int(rng.choice(lanes)), "style": style, "raw": raw}
        if strides:
            case["stride"] = int(rng.choice(strides))
        cases.append(case)
    return cases


def tpu_battery() -> list[dict]:
    """The tpu-profile battery: 36 cases, n in [0, 50,000), k in
    {8, 16, 64, 128, 256}."""
    return _battery(123, 36, (0, 50_000), [8, 16, 64, 128, 256])


def ref_battery() -> list[dict]:
    """The ref-profile battery: 20 cases, n in [1, 20,000), k in
    {1, 2, 4, 8, 32}."""
    return _battery(321, 20, (1, 20_000), [1, 2, 4, 8, 32])


def hist_stride_battery() -> list[dict]:
    """Sampled-histogram tables: 12 cases, n in [1, 40,000), k in
    {8, 64, 256}, stride in {2, 3, 8, 17}."""
    return _battery(99, 12, (1, 40_000), [8, 64, 256], [2, 3, 8, 17])


#: The mutated blobs' block: 50,000 biased bytes at the default K = 256.
MUTATION_BYTES = 50_000


def mutation_block(seed: int = 14) -> bytes:
    return biased_u8(MUTATION_BYTES, seed).tobytes()


def byte_flips(blob: bytes, count: int, seed: int = 0) -> list[tuple[int, bytes]]:
    """``count`` (offset, blob) pairs, each with one byte XORed by 1-255:
    a quarter at offsets below 64 (the header), the rest anywhere."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        at = int(rng.integers(0, min(64, len(blob)) if i % 4 == 0 else len(blob)))
        bad = bytearray(blob)
        bad[at] ^= int(rng.integers(1, 256))
        out.append((at, bytes(bad)))
    return out


def with_raw_size(blob: bytes, raw_size: int) -> bytes:
    """An HTP3 blob with its raw-size field (bytes 4-7) replaced."""
    return blob[:4] + struct.pack("<I", raw_size) + blob[8:]


def inflated_raw_sizes(blob: bytes) -> dict[str, bytes]:
    """The blob with its raw size times 4, times 64, and with 0x40 set in
    its high byte: sizes whose lanes would need more symbols than their
    bits hold."""
    n = struct.unpack_from("<I", blob, 4)[0]
    return {
        "x4": with_raw_size(blob, 4 * n),
        "x64": with_raw_size(blob, 64 * n),
        "high byte 0x40": with_raw_size(blob, n | 0x40 << 24),
    }
