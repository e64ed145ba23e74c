"""ctypes binding of the shared host runtime (``native/*.cpp``).

The HTP3 layer needs four things from it: the ref-profile codec that
entropy-codes the lane bit counts of a huff-counts blob
(``hh_compress`` / ``hh_decompress``), the same codec for kind-R
container records, and the single-pass packers of the compact payload
(``hp_pack_lane_bits`` / ``hp_unpack_lane_bits``).  `NativeCodec` offers
the ref-profile codec as a bytes codec to the benchmark suite and to
`TorchRefCodec`'s host path; `compress_file` / `decompress_file` are the
threaded file pipeline (``hp_compress_file`` / ``hp_decompress_file``)
of the CLI's ``native`` profile.

The library is compiled with g++ into ``build/torch/`` at first use, for
the host it runs on (no ``-march=native``: the file may be carried to
another machine).  Where it cannot be built or loaded, `compress` and
`decompress` take the numpy oracle (``golden``) and the lane-bit packers
their numpy forms (``models.torch_codec``), with the same bytes, as
``huffman_tpu/native.py`` does; the file pipeline raises RuntimeError, and
the CLI then writes and reads a bare ref blob as ``huffman_tpu.cli`` does.
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
        cp, lng, c_int = ctypes.c_char_p, ctypes.c_long, ctypes.c_int
        lib.hp_compress_file.restype = lng
        lib.hp_compress_file.argtypes = [cp, cp, lng, c_int, c_int]
        lib.hp_decompress_file.restype = lng
        lib.hp_decompress_file.argtypes = [cp, cp, c_int]
        _lib = lib
        return _lib


def _lib_or_none():
    """The host library, or None where it cannot be built or loaded."""
    try:
        return load()
    except (RuntimeError, OSError):
        return None


def compress(raw: bytes, k: int) -> bytes:
    """Ref-profile blob of ``raw`` with ``k`` streams."""
    lib = _lib_or_none()
    if lib is None:
        from . import golden

        return golden.compress(raw, k)
    bound = lib.hh_compress_bound(len(raw), k)
    out = np.empty(bound, dtype=np.uint8)
    size = lib.hh_compress(raw, len(raw), k, out.ctypes.data, bound)
    if size == 0:
        raise RuntimeError("native compress failed")
    return out[:size].tobytes()


def decompress(blob: bytes, k: int, max_size: int) -> bytes:
    """Inverse of `compress`.  ``max_size`` bounds the raw size the header
    may claim, so a corrupt header cannot demand a huge buffer."""
    lib = _lib_or_none()
    if lib is None:
        from . import format as fmt, golden

        n = fmt.parse_header(blob, k).raw_size
        if n > max_size:
            raise ValueError(f"ref-profile blob claims {n} bytes, at most {max_size}")
        return golden.decompress(blob, k)
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


def compress_file(
    in_path: str, out_path: str, k: int = 32, block: int = 1 << 20, threads: int = 0
) -> int:
    """Compress a file through the threaded pipeline: an HTPC container
    of ref-profile records (``k`` streams, blocks of ``block`` bytes),
    each block stored raw where that is smaller.  Returns the bytes
    written; ``threads`` 0 means one per CPU."""
    lib = load()
    threads = threads if threads > 0 else os.cpu_count() or 1
    r = lib.hp_compress_file(in_path.encode(), out_path.encode(), block, k, threads)
    if r < 0:
        raise RuntimeError(f"native pipeline compress failed for {in_path!r}")
    return int(r)


def decompress_file(in_path: str, out_path: str, threads: int = 0) -> int:
    """Inverse of `compress_file`.  Returns the bytes written; raises
    ValueError for a container the pipeline cannot decode (corrupt, or
    holding HTP3 records, which need the device decoder)."""
    lib = load()
    threads = threads if threads > 0 else os.cpu_count() or 1
    r = lib.hp_decompress_file(in_path.encode(), out_path.encode(), threads)
    if r < 0:
        raise ValueError(f"native pipeline could not decode {in_path!r}")
    return int(r)


def pack_lane_bits(lane_bytes: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate lane i's first ``bits[i]`` bits of ``lane_bytes[i]``
    (MSB-first) into one stream; same bytes as the NumPy
    ``torch_codec._pack_lane_bits``, which serves where the library does
    not load."""
    lane_bytes = np.ascontiguousarray(lane_bytes, dtype=np.uint8)
    bits64 = np.ascontiguousarray(bits, dtype=np.int64)
    k, nb = lane_bytes.shape
    if bits64.shape != (k,) or int(bits64.max(initial=0)) > 8 * nb or (
        bits64.min(initial=0) < 0
    ):
        raise ValueError("bit counts do not fit the lane bytes")
    lib = _lib_or_none()
    if lib is None:
        from .models.torch_codec import _pack_lane_bits

        return _pack_lane_bits(lane_bytes, bits64)
    out = np.empty((int(bits64.sum()) + 7) // 8, dtype=np.uint8)
    n = lib.hp_pack_lane_bits(
        lane_bytes.ctypes.data, bits64.ctypes.data, k, nb, out.ctypes.data
    )
    return out[:n].tobytes()


def unpack_lane_bits(stream: np.ndarray, bits: np.ndarray, nb_out: int) -> np.ndarray:
    """Inverse of `pack_lane_bits`: (k, nb_out) uint8, tails zeroed (the
    numpy form where the library does not load)."""
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    bits64 = np.ascontiguousarray(bits, dtype=np.int64)
    k = bits64.shape[0]
    if int(bits64.max(initial=0)) > 8 * nb_out or bits64.min(initial=0) < 0:
        raise ValueError("bit counts do not fit the lane bytes")
    lib = _lib_or_none()
    if lib is None:
        from .models.torch_codec import _unpack_lane_bits

        if int(bits64.sum()) > 8 * stream.shape[0]:
            raise ValueError("payload shorter than bit counts imply")
        return _unpack_lane_bits(stream, bits64, nb_out)
    out = np.zeros((k, nb_out), dtype=np.uint8)
    rc = lib.hp_unpack_lane_bits(
        stream.ctypes.data, stream.shape[0], bits64.ctypes.data, k, nb_out,
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError("payload shorter than bit counts imply")
    return out
