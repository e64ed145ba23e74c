"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources compile with nvcc for ``sm_90a`` into shared libraries with a
plain C interface under ``build/torch_kernels/`` at first use, all the
libraries at once (one nvcc process each), and are called through
ctypes: every pointer and the stream are ``c_void_p``, the stream is
PyTorch's current one, and each C entry returns ``cudaGetLastError()``
after its launches.  The codec's kernels have a source each, named for
it; the measurement harness's two (``carry`` and ``fold``) share
``csrc/bench_ops.cu``.  The compress path's four sources are linked into
one library with ``csrc/encode_chain.cu``, whose two entries each queue a
whole compress request; the other sources are a library each.

`ENTRIES` holds one record for each C entry: its library, the kernels one
call launches and its argument types.  `launch` is the one caller of a C
entry in the package: every op wrapper crosses into C through it.

``LAUNCHES`` counts the launches of each kernel, so a caller can show
that a path really went through the kernels, ``CALLS`` the calls of
each C entry, so that it can show how often the host crossed into C,
and ``DECODE_PATHS`` the calls of ``TorchCodec.decode_device`` on a card
by the path they took.  They and the library handles are the module's
only state.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from .. import tracing
from .._build import BUILD_DIR, build_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
#: The libraries: name -> its sources, ``csrc/<source>.cu``.
LIBRARIES = {
    "encode_chain": ("encode_chain", "hist256", "hist256_batch", "table_build", "encode_lanes"),
    "decode_lanes": ("decode_lanes",),
    "hist256_onehot": ("hist256_onehot",),
    "bench_ops": ("bench_ops",),
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Where nvcc is looked for after $CUDA_HOME, before $PATH.
_CUDA_ROOT = "/usr/local/cuda"


class Entry(NamedTuple):
    """A C entry ``<entry>_launch``: the library that holds it, the
    kernels one call launches (in order) and its ctypes argument types;
    ``name``, its kernel's or, where it launches several, its library's,
    names its span ``launch.<name>`` and its launch errors."""

    library: str
    kernels: tuple
    argtypes: list
    name: str
    span: str


def _entry(library: str, kernels: tuple, *argtypes) -> Entry:
    name = kernels[0] if len(kernels) == 1 else library
    return Entry(library, kernels, list(argtypes), name, "launch." + name)


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: Every C entry, by entry name.
ENTRIES = {
    "hist256": _entry("encode_chain", ("hist256",), _VP, _I64, _I32, _I64, _I32, _I32, _VP, _VP),
    "hist256_batch": _entry("encode_chain", ("hist256_batch",), _VP, _I32, _I64, _VP, _VP),
    "table_build": _entry("encode_chain", ("table_build",), _VP, _I32, _VP, _VP),
    "encode_lanes": _entry(
        "encode_chain", ("encode_lanes",), _VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP),
    "decode_lanes": _entry(
        "decode_lanes", ("decode_lanes",),
        _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _I32, _VP, _VP),
    "hist256_onehot": _entry("hist256_onehot", ("hist256_onehot",), _VP, _I64, _I32, _VP, _VP),
    "carry": _entry("bench_ops", ("carry",), _VP, _I64, _I32, _VP, _VP, _VP),
    "fold": _entry(
        "bench_ops", ("fold",),
        ctypes.POINTER(_VP), ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I32, _VP, _VP, _VP),
    # encode_lanes with each lane's row count; ``encode_lanes_launch``
    # keeps its argument list for the A/B tool's builds of older sources.
    "encode_lanes_rows": _entry(
        "encode_chain", ("encode_lanes",), _VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP),
    # A whole compress request: a block's, and a batch of pages'.
    "encode_chain": _entry(
        "encode_chain", ("hist256", "table_build", "encode_lanes"),
        _VP, _I64, _I32, _I64, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP),
    "encode_chain_batch": _entry(
        "encode_chain", ("hist256_batch", "table_build", "encode_lanes"),
        _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP),
}

#: Launches of each kernel since the last `reset_launches`.
LAUNCHES = {kernel: 0 for e in ENTRIES.values() for kernel in e.kernels}
#: Calls of each C entry since the last `reset_launches`.
CALLS = {entry: 0 for entry in ENTRIES}
#: Calls of ``TorchCodec.decode_device`` on a card since the last
#: `reset_launches`, by path: "prepared", a block's one checked C call
#: (`ops.decode_bits.decode_block`); "checked", every other (an empty or
#: one-symbol block, which launches nothing).
DECODE_PATHS = {"prepared": 0, "checked": 0}

_lock = threading.Lock()
_lib = None  # entry name -> its C entry point, once built
_build_log = ""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), _CUDA_ROOT):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load() -> dict:
    """Each C entry ``<entry>_launch`` by its name in `ENTRIES`, the
    libraries compiled first if needed (all at once).  Raises when nvcc is
    missing or a build fails."""
    global _lib, _build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        out_dir = os.path.join(BUILD_DIR, "torch_kernels")

        def build(lib):
            sources = [os.path.join(_CSRC, f"{src}.cu") for src in LIBRARIES[lib]]
            return build_library(lib, nvcc, _FLAGS, sources, out_dir)

        with ThreadPoolExecutor(len(LIBRARIES)) as pool:
            built = list(pool.map(build, LIBRARIES))
        dlls = {lib: ctypes.CDLL(path) for lib, (path, _) in zip(LIBRARIES, built)}
        libs = {}
        for entry, e in ENTRIES.items():
            fn = getattr(dlls[e.library], f"{entry}_launch")
            fn.argtypes = e.argtypes
            fn.restype = _I32
            libs[entry] = fn
        _build_log = "".join(log for _, log in built)
        _lib = libs
        return _lib


def build_log() -> str:
    """nvcc's output (register and shared-memory use per kernel) from the
    build this process made; empty when the libraries were already built."""
    return _build_log


def reset_launches() -> None:
    """Zero `LAUNCHES`, `CALLS` and `DECODE_PATHS`."""
    for kernel in LAUNCHES:
        LAUNCHES[kernel] = 0
    for entry in CALLS:
        CALLS[entry] = 0
    for path in DECODE_PATHS:
        DECODE_PATHS[path] = 0


def launch(entry: str, *args) -> None:
    """Call ``<entry>_launch(*args)``, the libraries built first if
    needed, and count the call and a launch of each of its kernels; raises
    on a CUDA error, counting nothing.  The C call is the entry's span
    (`Entry`) while the recorder (`tracing`) is on."""
    e = ENTRIES[entry]
    fn = load()[entry]
    if tracing.ON:
        with tracing.span(e.span):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {e.name} failed to launch: error {rc}")
    CALLS[entry] += 1
    for kernel in e.kernels:
        LAUNCHES[kernel] += 1


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on the card of the CUDA
    tensor ``t``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
