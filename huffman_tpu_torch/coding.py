"""Canonical Huffman codes on the host, the same tables as
``huffman_tpu/coding.py``.

The ``ref`` profile builds its one shared table here, from the block's
256-bin count: a two-queue Huffman build over symbols sorted by count
(descending, ties by symbol ascending), the "MiniZ" repair that limits
lengths to 12 bits, then canonical codes in that order.  The build is
O(256 log 256) a block, so it stays scalar on the host as in the JAX
package; no kernel corresponds to it.  The ``tpu`` profile's table is
built on the device (``ops/table_build.py``); `assign_canonical_codes`
also serves its ``TorchCompressed.coding``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import MAX_CODE_LEN, MAX_OPTIMAL_CODE_LEN, NUM_SYMBOLS


def histogram(data: bytes | np.ndarray) -> np.ndarray:
    """Counts of each byte value: uint32[256]."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    return np.bincount(arr.ravel(), minlength=NUM_SYMBOLS).astype(np.uint32)


@dataclasses.dataclass
class CanonicalCoding:
    """A canonical code table.

    Attributes:
      code_bits: uint16[256]; each code left-aligned in ``max_len`` bits
        (its first bit at bit ``max_len - 1``), 0 for absent symbols.
      code_lens: uint8[256]; 0 for absent symbols, and for the one symbol
        of a single-symbol alphabet.
      sorted_syms: uint8[num_syms]; symbols by (length asc, count desc,
        symbol asc): the order codes are enumerated in and the header's.
      len_count: uint16[max_len + 1]; codes of each length.
      len_mask: bit l set when some code has length l.
      num_syms: distinct symbols.
      max_len: the length limit, and so the alignment of ``code_bits``
        (12 for the ref profile, 15 for the tpu profile).
    """

    code_bits: np.ndarray
    code_lens: np.ndarray
    sorted_syms: np.ndarray
    len_count: np.ndarray
    len_mask: int
    num_syms: int
    max_len: int = MAX_CODE_LEN


def _huffman_code_lengths(counts_desc: np.ndarray) -> np.ndarray:
    """Unlimited code length of each symbol, given counts sorted
    descending: uint32, in the same order (nondecreasing).

    Two queues: leaves from the small end, and internal nodes, which are
    made in nondecreasing weight order; on a tie the leaf is taken first.
    """
    n = len(counts_desc)
    if n <= 1:
        # No symbol, or one: a single leaf is the root, depth 0.
        return np.zeros(n, dtype=np.uint32)

    counts = counts_desc.astype(np.int64)
    next_sym = n - 1  # leaves are taken from the small end
    tree_count = np.zeros(n, dtype=np.int64)
    children = np.full((n, 2), -1, dtype=np.int64)
    next_tree = 0
    tree_size = 0

    def pop_min():
        nonlocal next_sym, next_tree
        take_leaf = next_sym >= 0 and (
            next_tree == tree_size or counts[next_sym] <= tree_count[next_tree]
        )
        if take_leaf:
            w = counts[next_sym]
            next_sym -= 1
            return w, -1
        node = next_tree
        next_tree += 1
        return tree_count[node], node

    while (tree_size - next_tree) + (next_sym + 1) > 1:
        wa, na = pop_min()
        wb, nb = pop_min()
        children[tree_size] = (na, nb)
        tree_count[tree_size] = wa + wb
        tree_size += 1
    _, root = pop_min()

    # Leaves at each depth.  Over counts sorted descending, a less
    # frequent symbol never gets a shorter code, so the lengths are these
    # depths in ascending order.
    len_count = np.zeros(MAX_OPTIMAL_CODE_LEN + 1, dtype=np.int64)
    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        if node < 0:
            len_count[depth] += 1
        else:
            stack.append((children[node, 0], depth + 1))
            stack.append((children[node, 1], depth + 1))
    lens = np.repeat(np.arange(MAX_OPTIMAL_CODE_LEN + 1, dtype=np.uint32), len_count)
    if len(lens) != n:
        raise AssertionError("the tree lost a leaf")
    return lens


def limit_code_lengths(len_count: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Cap code lengths at ``max_len`` and repair the Kraft sum ("MiniZ"):
    fold every longer code into length ``max_len``, then, while the sum
    exceeds 1, drop one code of length ``max_len`` and split the deepest
    shorter code into two one bit longer.  Returns uint16[max_len + 1]."""
    lc = len_count.astype(np.int64).copy()
    lc[max_len] += lc[max_len + 1 :].sum()
    lc[max_len + 1 :] = 0
    one = 1 << max_len
    kraft = int((lc[: max_len + 1] << (max_len - np.arange(max_len + 1))).sum())
    while kraft > one:
        lc[max_len] -= 1
        for j in range(max_len - 1, -1, -1):
            if lc[j] > 0:
                lc[j] -= 1
                lc[j + 1] += 2
                break
        kraft -= 1
    if kraft != one and lc.sum() != 0:
        raise AssertionError("the repaired lengths break Kraft equality")
    return lc[: max_len + 1].astype(np.uint16)


def clamp_hist(hist: np.ndarray, max_len: int) -> np.ndarray:
    """Raise every nonzero count to at least ``total >> max_len`` (at
    least 1), the total taken before the clamp: a symbol rarer than
    2^-max_len sits at depth max_len in any limited code anyway, and the
    clamped tree needs (almost) no repair."""
    h = np.asarray(hist, dtype=np.int64)
    floor = max(1, int(h.sum()) >> max_len)
    return np.where(h > 0, np.maximum(h, floor), 0)


def assign_canonical_codes(
    len_count: np.ndarray, sorted_syms: np.ndarray, max_len: int = MAX_CODE_LEN
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes in ``sorted_syms`` order, grouped by ascending
    length: ``code += 1 << (max_len - len)`` after each symbol, each code
    left-aligned in ``max_len`` bits.  Returns (code_bits uint16[256],
    code_lens uint8[256])."""
    code_bits = np.zeros(NUM_SYMBOLS, dtype=np.uint16)
    code_lens = np.zeros(NUM_SYMBOLS, dtype=np.uint8)
    current = 0
    i = 0
    for ln in range(max_len + 1):
        inc = 1 << (max_len - ln)
        for _ in range(int(len_count[ln])):
            s = int(sorted_syms[i])
            code_bits[s] = current
            code_lens[s] = ln
            current += inc
            i += 1
    if i and current != 1 << max_len:
        raise AssertionError(f"length counts {list(len_count)} break Kraft equality")
    return code_bits, code_lens


def make_canonical_coding(
    hist: np.ndarray, max_len: int = MAX_CODE_LEN, clamp: bool = False
) -> CanonicalCoding:
    """Histogram -> canonical coding.  The defaults are the ref profile's
    build (12 bits, no clamp); ``clamp`` applies `clamp_hist` first."""
    hist = np.asarray(hist, dtype=np.uint64)
    if clamp:
        hist = clamp_hist(hist, max_len).astype(np.uint64)
    present = np.nonzero(hist)[0]
    num_syms = len(present)
    if num_syms == 0:
        return CanonicalCoding(
            code_bits=np.zeros(NUM_SYMBOLS, dtype=np.uint16),
            code_lens=np.zeros(NUM_SYMBOLS, dtype=np.uint8),
            sorted_syms=np.zeros(0, dtype=np.uint8),
            len_count=np.zeros(max_len + 1, dtype=np.uint16),
            len_mask=0,
            num_syms=0,
            max_len=max_len,
        )
    # Count descending, symbol ascending on ties.
    order = np.lexsort((present, -hist[present].astype(np.int64)))
    sorted_syms = present[order].astype(np.uint8)
    lens = _huffman_code_lengths(hist[present][order])
    len_count = limit_code_lengths(
        np.bincount(lens, minlength=MAX_OPTIMAL_CODE_LEN + 1), max_len
    )
    # The limit keeps lengths nondecreasing in that order, so the symbols
    # keep their places: grouped by length they are still sorted_syms.
    code_bits, code_lens = assign_canonical_codes(len_count, sorted_syms, max_len)
    len_mask = sum(1 << ln for ln in range(max_len + 1) if len_count[ln])
    return CanonicalCoding(
        code_bits=code_bits,
        code_lens=code_lens,
        sorted_syms=sorted_syms,
        len_count=len_count,
        len_mask=len_mask,
        num_syms=num_syms,
        max_len=max_len,
    )


def _codes(len_count: np.ndarray, sorted_syms: np.ndarray):
    """(symbol, 12-bit left-aligned code, length) in canonical order."""
    current = 0
    i = 0
    for ln in range(MAX_CODE_LEN + 1):
        inc = 1 << (MAX_CODE_LEN - ln)
        for _ in range(int(len_count[ln])):
            yield int(sorted_syms[i]), current, ln
            current += inc
            i += 1


def decode_tables_1x(len_count: np.ndarray, sorted_syms: np.ndarray):
    """One-symbol decode table over every 12-bit window: (lens uint8[4096],
    syms uint8[4096])."""
    size = 1 << MAX_CODE_LEN
    t_len = np.zeros(size, dtype=np.uint8)
    t_sym = np.zeros(size, dtype=np.uint8)
    for sym, bits, ln in _codes(len_count, sorted_syms):
        inc = 1 << (MAX_CODE_LEN - ln)
        t_len[bits : bits + inc] = ln
        t_sym[bits : bits + inc] = sym
    return t_len, t_sym


def decode_tables_2x(len_count: np.ndarray, sorted_syms: np.ndarray):
    """Two-symbol decode table over every 12-bit window: two symbols where
    both codes fit in the window, else one.  Returns (nbits, sym0, sym1,
    nsyms), each uint8[4096]."""
    size = 1 << MAX_CODE_LEN
    t_bits = np.zeros(size, dtype=np.uint8)
    t_s0 = np.zeros(size, dtype=np.uint8)
    t_s1 = np.zeros(size, dtype=np.uint8)
    t_n = np.zeros(size, dtype=np.uint8)
    codes = list(_codes(len_count, sorted_syms))
    for sym1, bits1, len1 in codes:
        last = bits1
        for sym2, bits2, len2 in codes:
            if len1 + len2 > MAX_CODE_LEN:
                break  # codes come in ascending length
            c = bits1 | (bits2 >> len1)
            inc = 1 << (MAX_CODE_LEN - len1 - len2)
            t_bits[c : c + inc] = len1 + len2
            t_s0[c : c + inc] = sym1
            t_s1[c : c + inc] = sym2
            t_n[c : c + inc] = 2
            last = c + inc
        end1 = bits1 + (1 << (MAX_CODE_LEN - len1))
        if last < end1:
            t_bits[last:end1] = len1
            t_s0[last:end1] = sym1
            t_s1[last:end1] = 0
            t_n[last:end1] = 1
    return t_bits, t_s0, t_s1, t_n
