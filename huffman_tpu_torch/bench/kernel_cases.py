"""Inputs that hold the table and decode kernels to their plain versions
where they are hardest to get right.

``chip_smoke.py`` runs them through the CUDA kernels on the card; the
CPU tests run them through the plain versions and the JAX package.
Every generator is numpy only and made from a seed.
"""

from __future__ import annotations

import numpy as np

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
