"""The chip's peaks and the least bytes a request must move.

The bound arithmetic of ``chip_smoke.py`` phase 5 (``PERF.md`` §6): a
kernel's least time is the bytes it must move over the HBM rate, count
each input byte read once and each output byte written once, and count
what these inputs need, not the most they could.  Every request of the
benchmark is bound by bytes, never by operations.
"""

from __future__ import annotations

import subprocess

import numpy as np

#: NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
#: Bytes of one coding table a kernel must write: (code << 4 | len) by symbol.
TABLE_BYTES = 256 * 4


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi prints them,
    or "not read" where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def lane_bytes(bits: np.ndarray) -> int:
    """Bytes of lane words that (..., K) bit counts fill: whole u32 words."""
    return int(((np.asarray(bits, np.int64) + 31) // 32).sum()) * 4


def compress_bytes(n_in: int, bits: np.ndarray) -> int:
    """Least bytes of a compress request: its input read, its words, bit
    counts and one table a block written."""
    bits = np.asarray(bits)
    blocks = bits.size // bits.shape[-1]
    return n_in + lane_bytes(bits) + bits.size * 4 + blocks * TABLE_BYTES


def decompress_bytes(n_out: int, bits: np.ndarray) -> int:
    """Least bytes of a decompress request: the words that hold its codes
    read, its output written."""
    return lane_bytes(bits) + n_out
