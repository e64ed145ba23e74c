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

`decode_block` is ``TorchCodec.decode_device``'s launch of that kernel on
one block on a card: it knows the block's layout, so it checks the four
tensors in one pass against what it expects of a block of that shape
(kept per (W, k, s)), allocates the flat output once and crosses into C
once, where `decode_lanes` checks each tensor through `_cuda.check` and
launches through `_cuda.launch`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tracing
from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda

_I32 = torch.int32
#: The shapes of a block's decode tables: e_bound, g_rank and syms.
_TABLE_SHAPES = ((_L + 2,), (_L + 1,), (256,))


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
        return _decode_cuda(words, e_bound, g_rank, syms, 1, s, words.shape[0])
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
        return _decode_cuda(words, e_bound, g_rank, syms, words.shape[0], s, w)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return decode_lanes_batch_plain(words, e_bound, g_rank, syms, s, w)


def _decode_cuda(words, e_bound, g_rank, syms, bcount: int, s: int, w: int):
    """One launch over ``bcount`` blocks; the output takes the inputs'
    leading dimensions (none for a single block, (B,) for a batch)."""
    lead = tuple(words.shape[:-2])
    n_words, k = words.shape[-2:]
    _cuda.check(words, "words", torch.int32, lead + (n_words, k))
    _cuda.check(e_bound, "e_bound", torch.int32, lead + (_L + 2,))
    _cuda.check(g_rank, "g_rank", torch.int32, lead + (_L + 1,))
    _cuda.check(syms, "syms", torch.int32, lead + (256,))
    _cuda.load()
    out = torch.empty(lead + (s, k), dtype=torch.uint8, device=words.device)
    _cuda.launch(
        "decode_lanes", words.data_ptr(), bcount, n_words, max(min(w, n_words), 0), k,
        e_bound.data_ptr(), g_rank.data_ptr(), syms.data_ptr(), s, out.data_ptr(),
        _cuda.stream(words),
    )
    return out


@functools.lru_cache(maxsize=64)
def _block(shape: torch.Size, k: int, s: int) -> tuple[int, tuple]:
    """(the output's length s*k, the C entry's arguments between the words
    and the tables) of a block whose words have this shape; raises
    ValueError unless the shape is (W, k)."""
    if len(shape) != 2 or shape[1] != k:
        raise ValueError(f"words must have shape (W, {k}), got {tuple(shape)}")
    return s * k, (1, shape[0], shape[0], k)


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
    symbols decoded from each of the k lanes of ``words`` and flattened
    as ``decode_lanes(...).reshape(-1)[:n]`` does, ``n <= s*k``.

    ``words`` is (W, k) int32, ``e_bound`` (17,), ``g_rank`` (16,) and
    ``syms`` (256,) int32, all contiguous on the words' card; any other
    raises ValueError before the C call.  One C call, counted as
    `_cuda.launch` counts it, the span ``launch.decode_lanes`` while the
    recorder is on."""
    size, dims = _block(words.shape, k, s)
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
    fn = _cuda.load()["decode_lanes"]
    out = words.new_empty(size, dtype=torch.uint8)
    args = (words.data_ptr(), *dims, e_bound.data_ptr(), g_rank.data_ptr(), syms.data_ptr(), s,
            out.data_ptr(), _cuda.stream(words))
    if tracing.ON:
        with tracing.span("launch.decode_lanes"):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel decode_lanes failed to launch: error {rc}")
    _cuda.CALLS["decode_lanes"] += 1
    _cuda.LAUNCHES["decode_lanes"] += 1
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
