"""Histogram -> canonical coding of the tpu profile, in one launch.

Counterpart: ``huffman_tpu/ops/table_build.py:build_coding_device``.  The
CUDA kernel (``csrc/table_build.cu``) ports the scalar Pallas kernels
``_tree_kernel`` and ``_full_table_kernel`` and the XLA steps around them
(clamp, stable sort, canonical derivation); `build_coding_plain` is the
same algorithm as a Python loop.  Both write one flat int32 buffer, which
`_unpack` splits into the seven keys of the JAX version.
"""

from __future__ import annotations

import torch

from ..constants import NUM_SYMBOLS as _N
from ..constants import TPU_MAX_CODE_LEN as _L
from . import _cuda

# Layout of the flat table buffer (csrc/table_build.cu, kOff*).
_FIELDS = (
    ("enc_table", 0, _N),
    ("len_count", 256, _L + 1),
    ("sorted_syms", 272, _N),
    ("num_syms", 528, None),
    ("e_bound", 529, _L + 2),
    ("g_rank", 546, _L + 1),
    ("l_min", 562, None),
)
TABLE_LEN = 563
_DEPTH = 64
_BIG = 1 << 30


def _unpack(buf: torch.Tensor) -> dict:
    return {
        key: buf[off] if size is None else buf[off : off + size]
        for key, off, size in _FIELDS
    }


def build_coding_device(hist: torch.Tensor) -> dict:
    """(256,) integer counts (total < 2^30) -> coding dict on hist's device.

    Keys, all int32: ``enc_table`` (256,) ``code<<4 | len`` by symbol
    (code left-aligned in 15 bits, 0 for absent symbols); ``len_count``
    (16,); ``sorted_syms`` (256,) symbols by rank; ``num_syms`` ();
    ``e_bound`` (17,) and ``g_rank`` (16,), the decode constants; ``l_min``
    (), the shortest code length (1 when there is none).
    """
    return _unpack(build_coding_flat(hist))


def build_coding_flat(hist: torch.Tensor) -> torch.Tensor:
    """The (TABLE_LEN,) int32 buffer behind `build_coding_device`."""
    if hist.is_cuda:
        _cuda.check(hist, "hist", torch.int32, (_N,))
        _cuda.load()
        out = torch.empty(TABLE_LEN, dtype=torch.int32, device=hist.device)
        _cuda.launch(
            "table_build", hist.data_ptr(), out.data_ptr(), _cuda.stream(hist)
        )
        return out
    if hist.device.type != "cpu":
        raise ValueError(f"unsupported device {hist.device}")
    return build_coding_plain(hist)


def build_coding_plain(hist: torch.Tensor) -> torch.Tensor:
    """Plain version of the table kernel: the same steps as a Python loop
    (on the host), returned as a flat buffer on ``hist``'s device."""
    if tuple(hist.shape) != (_N,):
        raise ValueError(f"expected a (256,) histogram, got {tuple(hist.shape)}")
    h = [int(v) for v in hist.cpu().tolist()]
    floor = max(sum(h) >> _L, 1)
    cnt = [max(v, floor) if v > 0 else 0 for v in h]
    # Frequency descending, symbol ascending; absent symbols after, by symbol.
    syms = sorted(range(_N), key=lambda s: (cnt[s] == 0, -cnt[s], s))
    cd = [cnt[s] for s in syms]
    n = sum(1 for v in cnt if v > 0)

    # Moffat-Katajainen in place (see csrc/table_build.cu for the steps).
    n_int = max(n - 1, 0)
    a = [cd[max(n - 1 - i, 0)] if i < n else _BIG for i in range(_N)]
    leaf = root = 0
    for i in range(n_int):
        w = 0
        for _ in range(2):
            leaf_w = a[min(leaf, _N - 1)] if leaf < n else _BIG
            root_w = a[min(root, _N - 1)]
            if root < i and root_w < leaf_w:
                w += root_w
                a[root] = i
                root += 1
            else:
                w += leaf_w
                leaf += 1
        a[i] = w
    if n_int >= 1:
        a[n_int - 1] = 0
    for nxt in range(n_int - 2, -1, -1):
        a[nxt] = a[min(a[nxt], _N - 1)] + 1
    inodes = [0] * _DEPTH
    for i in range(n_int):
        inodes[min(max(a[i], 0), _DEPTH - 1)] += 1
    lc = [0] + [max(2 * inodes[d - 1] - inodes[d], 0) for d in range(1, _DEPTH)]
    if n == 1:
        lc = [1] + [0] * (_DEPTH - 1)
    lc[_L] += sum(lc[_L + 1 :])
    lc = lc[: _L + 1]
    kraft = sum(c << (_L - d) for d, c in enumerate(lc))
    while kraft > 1 << _L:
        lc[_L] -= 1
        j = max((d for d in range(_L) if lc[d] > 0), default=0)
        lc[j] -= 1
        lc[j + 1] += 2
        kraft -= 1

    e_bound, g_rank = [], [0]
    acc = nshort = 0
    for ln in range(_L + 1):
        if ln >= 1:
            g_rank.append(nshort - (acc >> (_L - ln)))
        acc += lc[ln] << (_L - ln)
        e_bound.append(acc)
        nshort += lc[ln]
    e_bound.append(acc)
    l_min = next((ln for ln in range(1, _L + 1) if lc[ln] > 0), 1)
    lens = [ln for ln in range(_L + 1) for _ in range(lc[ln])][:_N]
    enc = [0] * _N
    code = 0
    for i in range(n):
        enc[syms[i]] = (code << 4) | lens[i]
        code += 1 << (_L - lens[i])
    flat = enc + lc + syms + [n] + e_bound + g_rank + [l_min]
    return torch.tensor(flat, dtype=torch.int32).to(hist.device)
