"""ctypes binding of the shared host runtime (``native/*.cpp``).

The HTP3 layer needs four things from it: the ref-profile codec that
entropy-codes the lane bit counts of a huff-counts blob
(``hh_compress`` / ``hh_decompress``), the same codec for kind-R
container records, and the single-pass packers of the compact payload
(``hp_pack_lane_bits`` / ``hp_unpack_lane_bits``).  `NativeCodec` offers
the ref-profile codec as a bytes codec to the benchmark suite.

The library is compiled with g++ into ``build/torch/`` at first use, for
the host it runs on (no ``-march=native``: the file may be carried to
another machine).  There is no fallback: if it cannot be built, every
call raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ._build import BUILD_DIR, REPO, build_library

_SOURCES = [
    os.path.join(REPO, "native", "huffman_host.cpp"),
    os.path.join(REPO, "native", "pipeline.cpp"),
]
_FLAGS = ["-O3", "-funroll-loops", "-std=c++20", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build_library(
            "huffman_host", "g++", _FLAGS, _SOURCES, os.path.join(BUILD_DIR, "torch")
        )
        lib = ctypes.CDLL(path)
        vp, sz, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
        lib.hh_compress_bound.restype = sz
        lib.hh_compress_bound.argtypes = [sz, ctypes.c_int]
        lib.hh_compress.restype = sz
        lib.hh_compress.argtypes = [ctypes.c_char_p, sz, ctypes.c_int, vp, sz]
        lib.hh_decompress.restype = sz
        lib.hh_decompress.argtypes = [ctypes.c_char_p, sz, ctypes.c_int, vp, sz]
        lib.hh_raw_size.restype = sz
        lib.hh_raw_size.argtypes = [ctypes.c_char_p, sz]
        lib.hp_pack_lane_bits.restype = i64
        lib.hp_pack_lane_bits.argtypes = [vp, vp, i64, i64, vp]
        lib.hp_unpack_lane_bits.restype = i64
        lib.hp_unpack_lane_bits.argtypes = [vp, i64, vp, i64, i64, vp]
        _lib = lib
        return _lib


def compress(raw: bytes, k: int) -> bytes:
    """Ref-profile blob of ``raw`` with ``k`` streams."""
    lib = load()
    bound = lib.hh_compress_bound(len(raw), k)
    out = np.empty(bound, dtype=np.uint8)
    size = lib.hh_compress(raw, len(raw), k, out.ctypes.data, bound)
    if size == 0:
        raise RuntimeError("native compress failed")
    return out[:size].tobytes()


def decompress(blob: bytes, k: int, max_size: int) -> bytes:
    """Inverse of `compress`.  ``max_size`` bounds the raw size the header
    may claim, so a corrupt header cannot demand a huge buffer."""
    lib = load()
    n = lib.hh_raw_size(blob, len(blob))
    if n > max_size:
        raise ValueError(f"ref-profile blob claims {n} bytes, at most {max_size}")
    out = np.empty(max(n, 1), dtype=np.uint8)
    size = lib.hh_decompress(blob, len(blob), k, out.ctypes.data, n)
    if size == ctypes.c_size_t(-1).value:
        raise ValueError("corrupt ref-profile blob")
    return out[:n].tobytes()


class NativeCodec:
    """The ref-profile codec of the host library as a bytes codec
    (compress / decompress), for the benchmark suite's host rows."""

    #: The largest raw size a blob may claim in `decompress`.
    max_size = 1 << 31

    def __init__(self, k: int):
        self.k = k

    @property
    def name(self) -> str:
        return f"Native<{self.k}>"

    def compress(self, raw: bytes) -> bytes:
        return compress(raw, self.k)

    def decompress(self, blob: bytes) -> bytes:
        return decompress(blob, self.k, self.max_size)


def pack_lane_bits(lane_bytes: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate lane i's first ``bits[i]`` bits of ``lane_bytes[i]``
    (MSB-first) into one stream; same bytes as the NumPy
    ``torch_codec._pack_lane_bits``."""
    lib = load()
    lane_bytes = np.ascontiguousarray(lane_bytes, dtype=np.uint8)
    bits64 = np.ascontiguousarray(bits, dtype=np.int64)
    k, nb = lane_bytes.shape
    if bits64.shape != (k,) or int(bits64.max(initial=0)) > 8 * nb or (
        bits64.min(initial=0) < 0
    ):
        raise ValueError("bit counts do not fit the lane bytes")
    out = np.empty((int(bits64.sum()) + 7) // 8, dtype=np.uint8)
    n = lib.hp_pack_lane_bits(
        lane_bytes.ctypes.data, bits64.ctypes.data, k, nb, out.ctypes.data
    )
    return out[:n].tobytes()


def unpack_lane_bits(stream: np.ndarray, bits: np.ndarray, nb_out: int) -> np.ndarray:
    """Inverse of `pack_lane_bits`: (k, nb_out) uint8, tails zeroed."""
    lib = load()
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    bits64 = np.ascontiguousarray(bits, dtype=np.int64)
    k = bits64.shape[0]
    if int(bits64.max(initial=0)) > 8 * nb_out or bits64.min(initial=0) < 0:
        raise ValueError("bit counts do not fit the lane bytes")
    out = np.zeros((k, nb_out), dtype=np.uint8)
    rc = lib.hp_unpack_lane_bits(
        stream.ctypes.data, stream.shape[0], bits64.ctypes.data, k, nb_out,
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError("payload shorter than bit counts imply")
    return out
