"""Lane decode: (W, k) u32 lane words -> (s, k) bytes, s symbols per lane.

Counterparts: ``huffman_tpu/ops/decode_bits.py`` (the host tables, ported
as `decode_tables_bitserial`) and ``_decode_full`` in
``huffman_tpu/models/tpu_codec.py`` (the Pallas kernel
``ops/decode_pallas.py`` or the XLA bit-serial scan).

Canonical-boundary decode: at a lane's bit position take the 15-bit
window ``win``; its code length is ``1 + #{l in 1..14 : win >= E[l]}``,
its rank ``clip((win >> (15-len)) + g_rank[len], 0, 255)`` and its byte
``syms[rank]``.  Words past a lane's W read as zero.

The CUDA kernel is ``csrc/decode_lanes.cu``; `decode_lanes_plain` is its
plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda


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
    if words.is_cuda:
        n_words, k = words.shape
        _cuda.check(words, "words", torch.int32, (n_words, k))
        _cuda.check(e_bound, "e_bound", torch.int32, (_L + 2,))
        _cuda.check(g_rank, "g_rank", torch.int32, (_L + 1,))
        _cuda.check(syms, "syms", torch.int32, (256,))
        _cuda.load()
        out = torch.empty((s, k), dtype=torch.uint8, device=words.device)
        _cuda.launch(
            "decode_lanes", words.data_ptr(), n_words, k, e_bound.data_ptr(),
            g_rank.data_ptr(), syms.data_ptr(), s, out.data_ptr(),
            _cuda.stream(words),
        )
        return out
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return decode_lanes_plain(words, e_bound, g_rank, syms, s)


def decode_lanes_plain(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    s: int,
) -> torch.Tensor:
    """Plain version of the decode kernel: a loop over the s symbols,
    vectorised over the k lanes, in int64."""
    n_words, k = words.shape
    dev = words.device
    # Two zero rows past the end: windows that reach beyond W read zeros.
    flat = torch.cat(
        [(words.long() & 0xFFFFFFFF).reshape(-1), torch.zeros(2 * k, dtype=torch.int64, device=dev)]
    )
    eb = e_bound[1:_L].to(torch.int64).contiguous()
    gr = g_rank.to(torch.int64)
    sy = syms.to(torch.uint8)
    lane = torch.arange(k, device=dev)
    pos = torch.zeros(k, dtype=torch.int64, device=dev)
    out = torch.empty((s, k), dtype=torch.uint8, device=dev)
    for r in range(s):
        w = pos >> 5
        hi = flat[w.clamp(max=n_words) * k + lane]
        lo = flat[(w + 1).clamp(max=n_words + 1) * k + lane]
        # The 15 bits at offset pos & 31 of the 64-bit pair (hi, lo); an
        # arithmetic shift is harmless since the mask drops the sign bits.
        win = (((hi << 32) | lo) >> (49 - (pos & 31))) & 0x7FFF
        ln = 1 + torch.searchsorted(eb, win, right=True)
        rank = ((win >> (_L - ln)) + gr[ln]).clamp(0, 255)
        out[r] = sy[rank]
        pos += ln
    return out
