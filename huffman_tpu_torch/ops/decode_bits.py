"""Lane decode: (W, k) u32 lane words -> (s, k) bytes, s symbols per lane.

Counterparts: ``huffman_tpu/ops/decode_bits.py`` (the host tables, ported
as `decode_tables_bitserial`) and ``_decode_full`` in
``huffman_tpu/models/tpu_codec.py`` (the Pallas kernel
``ops/decode_pallas.py`` or the XLA bit-serial scan).

Canonical-boundary decode: at a lane's bit position take the 15-bit
window ``win``; its code length is ``1 + #{l in 1..14 : win >= E[l]}``,
its rank ``clip((win >> (15-len)) + g_rank[len], 0, 255)`` and its byte
``syms[rank]``.  Words past a lane's W read as zero.

A batch of B blocks (the vmapped decode of ``_decode_batch``) is one
launch of the same kernel, `decode_lanes_batch`; a single block is the
batch of one.  The CUDA kernel is ``csrc/decode_lanes.cu``;
`decode_lanes_batch_plain` is its plain PyTorch version.

A single block on a card has one route to that kernel, `decode_block`
(``TorchCodec.decode_device``'s, and `decode_lanes`'s): it checks the
four tensors in one pass against what it expects of a block of that
shape, allocates the flat output once and launches through
`_cuda.launch`, as the batch does.

The kernel looks a window up in two tables that each of its thread
blocks builds: `decode_luts_plain` is their plain model, and
`lut_entries_plain` the lookup through them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda

_I32 = torch.int32
#: The shapes of a block's decode tables: e_bound, g_rank and syms.
_TABLE_SHAPES = ((_L + 2,), (_L + 1,), (256,))
#: The decode kernel's lookup (``csrc/decode_lanes.cu``): the window bits
#: its first-level table resolves (kLut), its second-level entries (kL2)
#: and the first-level entry of a longer code (kEsc).
LUT_BITS = 11
LEVEL2_SIZE = 2048
ESCAPE = 1 << 31


def _canonical_bsearch(win: np.ndarray, e_bound, g_rank, syms) -> np.ndarray:
    """(byte | len << 8) of each window as the kernel computes it: len by
    its binary search over e_bound[1..14] and two bounds past every
    window, then the clipped rank."""
    bound = np.concatenate([np.asarray(e_bound, np.int64)[1:_L], [2**31 - 1] * 2])
    win = np.asarray(win, np.int64)
    c = np.zeros_like(win)
    for step in (8, 4, 2, 1):
        c += np.where(win >= bound[c + step - 1], step, 0)
    ln = c + 1
    rank = np.clip((win >> (_L - ln)) + np.asarray(g_rank, np.int64)[ln], 0, 255)
    return np.asarray(syms, np.int64)[rank] | ln << 8


def decode_luts_plain(e_bound, g_rank, syms, lut_bits: int = LUT_BITS,
                      level2_size: int = LEVEL2_SIZE) -> tuple[np.ndarray, np.ndarray, int]:
    """Plain model of the two tables a thread block of the decode kernel
    builds from a block's decode tables (numpy or CPU tensors).

    Returns ``(first, second, ek)``: ``first`` (2^lut_bits,) int64, for
    each lut_bits-bit prefix of the 15-bit window (byte | len << 8) where
    its code is at most lut_bits long, else `ESCAPE` | lut_bits << 8; ``ek``, the first
    window whose code is longer (e_bound[lut_bits] clipped to [0, 2^15]);
    ``second`` (min(2^15 - ek, level2_size),) int64, the entry of window
    ek + j at j."""
    eb = np.asarray(e_bound, np.int64)
    m = _L - lut_bits
    ek = int(min(max(eb[lut_bits], 0), 1 << _L))
    lo = np.arange(1 << lut_bits, dtype=np.int64) << m
    first = np.where(lo + (1 << m) <= ek, _canonical_bsearch(lo, eb, g_rank, syms),
                     ESCAPE | lut_bits << 8)
    n2 = min((1 << _L) - ek, level2_size)
    second = _canonical_bsearch(ek + np.arange(n2, dtype=np.int64), eb, g_rank, syms)
    return first, second, ek


def lut_entries_plain(win, e_bound, g_rank, syms, lut_bits: int = LUT_BITS,
                      level2_size: int = LEVEL2_SIZE) -> np.ndarray:
    """(byte | len << 8) of each 15-bit window as the decode kernel looks
    it up: its first-level entry, or for a longer code its second-level
    entry, or past the second level the canonical search."""
    first, second, ek = decode_luts_plain(e_bound, g_rank, syms, lut_bits, level2_size)
    win = np.asarray(win, np.int64)
    e = first[win >> (_L - lut_bits)]
    # A longer code's window is at least ek; past the second level, the search.
    long_code = (e & ESCAPE) != 0
    j = np.clip(win - ek, 0, len(second))
    e = np.where(long_code, np.append(second, 0)[j], e)
    past = long_code & (j == len(second))
    return np.where(past, _canonical_bsearch(win, e_bound, g_rank, syms), e)


def decode_tables_bitserial(len_count, sorted_syms) -> dict:
    """Host: the decode constants of a coding, as numpy arrays.

    Returns ``e_bound`` (17,) int32 with E[l] = sum_{j<=l} len_count[j] <<
    (15-j); ``g_rank`` (16,) int32; ``syms`` (256,) int32 rank -> symbol;
    ``l_min`` int, the shortest code length (1 when there is none).
    Accepts len_count shorter than 16 (12-limited codings).
    """
    lc = np.zeros(_L + 1, dtype=np.int64)
    lc_in = np.asarray(len_count, dtype=np.int64)
    lc[: len(lc_in)] = lc_in
    e = np.zeros(_L + 2, dtype=np.int64)
    base = np.zeros(_L + 1, dtype=np.int64)  # codes shorter than l
    acc = nshorter = 0
    for ln in range(_L + 1):
        base[ln] = nshorter
        acc += int(lc[ln]) << (_L - ln)
        e[ln] = acc
        nshorter += int(lc[ln])
    e[_L + 1] = acc
    g = np.zeros(_L + 1, dtype=np.int64)
    for ln in range(1, _L + 1):
        g[ln] = base[ln] - (e[ln - 1] >> (_L - ln))
    syms = np.zeros(256, dtype=np.int32)
    syms[: len(sorted_syms)] = np.asarray(sorted_syms, dtype=np.int32)
    nonzero = np.nonzero(lc[1:])[0]
    return {
        "e_bound": e.astype(np.int32),
        "g_rank": g.astype(np.int32),
        "syms": syms,
        "l_min": int(nonzero[0]) + 1 if len(nonzero) else 1,
    }


def decode_lanes(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    s: int,
) -> torch.Tensor:
    """Decode the first ``s`` symbols of each lane: (s, k) uint8.

    ``words`` is (W, k) int32 holding u32 bit patterns; ``e_bound`` (17,),
    ``g_rank`` (16,) and ``syms`` (256,) are int32.
    """
    if len(words.shape) != 2:
        raise ValueError(f"expected (W, k) words, got {tuple(words.shape)}")
    if words.is_cuda:
        k = words.shape[1]
        return decode_block(words, e_bound, g_rank, syms, k, s, s * k).view(s, k)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return decode_lanes_plain(words, e_bound, g_rank, syms, s)


def decode_lanes_batch(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    s: int,
    w: int,
) -> torch.Tensor:
    """Decode the first ``s`` symbols of each lane of each of B blocks:
    (B, s, k) uint8.

    ``words`` is (B, W, k) int32 holding u32 bit patterns, of which only
    the first ``w`` rows of each block are read (later rows read as zero);
    ``e_bound`` (B, 17), ``g_rank`` (B, 16) and ``syms`` (B, 256) are int32.
    """
    if words.is_cuda:
        if len(words.shape) != 3 or words.shape[0] < 1:
            raise ValueError(f"expected (B, W, k) words, got {tuple(words.shape)}")
        bcount, n_words, k = words.shape
        _cuda.check(words, "words", _I32, (bcount, n_words, k))
        for t, name, shape in zip((e_bound, g_rank, syms), ("e_bound", "g_rank", "syms"),
                                  _TABLE_SHAPES):
            _cuda.check(t, name, _I32, (bcount,) + shape)
        out = torch.empty((bcount, s, k), dtype=torch.uint8, device=words.device)
        _cuda.launch(
            "decode_lanes", words.data_ptr(), bcount, n_words, max(min(w, n_words), 0), k,
            e_bound.data_ptr(), g_rank.data_ptr(), syms.data_ptr(), s, out.data_ptr(),
            _cuda.stream(words),
        )
        return out
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return decode_lanes_batch_plain(words, e_bound, g_rank, syms, s, w)


def _refuse(words, e_bound, g_rank, syms, k: int) -> None:
    """Raise the ValueError that names the first fault `decode_block`
    found in a block's tensors."""
    _cuda.check(words, "words", _I32, (words.shape[0], k))
    dev = words.get_device()
    for t, name, shape in zip((e_bound, g_rank, syms), ("e_bound", "g_rank", "syms"),
                              _TABLE_SHAPES):
        _cuda.check(t, name, _I32, shape)
        if t.get_device() != dev:
            raise ValueError(f"{name} must be on {words.device}, got {t.device}")
    raise AssertionError("decode_block refused a well-formed block")


def decode_block(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    k: int,
    s: int,
    n: int,
) -> torch.Tensor:
    """The first ``n`` bytes of a block on a card, (n,) uint8: ``s``
    symbols decoded from each of the k lanes of ``words``, lane-interleaved
    (byte ``i`` from lane ``i % k``), ``n <= s*k``.

    ``words`` is (W, k) int32, ``e_bound`` (17,), ``g_rank`` (16,) and
    ``syms`` (256,) int32, all contiguous on the words' card; any other
    raises ValueError before the C call.  One `_cuda.launch`; the output
    is its allocation of s*k bytes, or a view of its first n."""
    if len(words.shape) != 2 or words.shape[1] != k:
        raise ValueError(f"words must have shape (W, {k}), got {tuple(words.shape)}")
    dev = words.get_device()
    # On the words' card (the tables' device index equal to the words'),
    # int32, the tables' shapes, contiguous.
    if not (
        words.is_cuda and e_bound.get_device() == dev and g_rank.get_device() == dev
        and syms.get_device() == dev
        and words.dtype is _I32 and e_bound.dtype is _I32 and g_rank.dtype is _I32
        and syms.dtype is _I32
        and e_bound.shape == _TABLE_SHAPES[0] and g_rank.shape == _TABLE_SHAPES[1]
        and syms.shape == _TABLE_SHAPES[2]
        and words.is_contiguous() and e_bound.is_contiguous() and g_rank.is_contiguous()
        and syms.is_contiguous()
    ):
        _refuse(words, e_bound, g_rank, syms, k)
    size, n_words = s * k, words.shape[0]
    out = words.new_empty(size, dtype=torch.uint8)
    _cuda.launch(
        "decode_lanes", words.data_ptr(), 1, n_words, n_words, k, e_bound.data_ptr(),
        g_rank.data_ptr(), syms.data_ptr(), s, out.data_ptr(), _cuda.stream(words),
    )
    return out if n == size else out[:n]


def decode_lanes_plain(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    s: int,
) -> torch.Tensor:
    """Plain version of `decode_lanes`: the batch of one."""
    n_words, k = words.shape
    return decode_lanes_batch_plain(
        words.view(1, n_words, k), e_bound.view(1, -1), g_rank.view(1, -1),
        syms.view(1, -1), s, n_words,
    )[0]


def decode_lanes_batch_plain(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    s: int,
    w: int,
) -> torch.Tensor:
    """Plain version of the decode kernel: a loop over the s symbols,
    vectorised over the B*k lanes of the batch, in int64."""
    bcount, _, k = words.shape
    w = max(min(w, words.shape[1]), 0)
    dev = words.device
    # The first w rows of each block and two zero rows past them: windows
    # that reach beyond w read zeros.
    flat = torch.cat(
        [
            words[:, :w].long() & 0xFFFFFFFF,
            torch.zeros((bcount, 2, k), dtype=torch.int64, device=dev),
        ],
        dim=1,
    ).reshape(-1)
    eb = e_bound[:, 1:_L].to(torch.int64).contiguous()
    gr = g_rank.to(torch.int64)
    sy = syms.to(torch.uint8)
    lane = (torch.arange(bcount, device=dev).view(-1, 1) * ((w + 2) * k)
            + torch.arange(k, device=dev))
    pos = torch.zeros((bcount, k), dtype=torch.int64, device=dev)
    out = torch.empty((bcount, s, k), dtype=torch.uint8, device=dev)
    for r in range(s):
        i = pos >> 5
        hi = flat[i.clamp(max=w) * k + lane]
        lo = flat[(i + 1).clamp(max=w + 1) * k + lane]
        # The 15 bits at offset pos & 31 of the 64-bit pair (hi, lo); an
        # arithmetic shift is harmless since the mask drops the sign bits.
        win = (((hi << 32) | lo) >> (49 - (pos & 31))) & 0x7FFF
        ln = 1 + torch.searchsorted(eb, win, right=True)
        rank = ((win >> (_L - ln)) + gr.gather(1, ln)).clamp(0, 255)
        out[:, r] = sy.gather(1, rank)
        pos += ln
    return out
