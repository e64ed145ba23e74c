"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources compile with nvcc for ``sm_90a`` into shared libraries with a
plain C interface under ``build/torch_kernels/`` at first use, all the
libraries at once (one nvcc process each), and are called through
ctypes: every pointer and the stream are ``c_void_p``, the stream is
PyTorch's current one, and each C entry returns ``cudaGetLastError()``
after its launches.  The codec's kernels have a source each, named for
it; the measurement harness's two (``carry`` and ``fold``) share
``csrc/bench_ops.cu``.  The compress path's four sources are linked into
one library with ``csrc/encode_chain.cu``, whose entries queue a whole
compress request (`CHAINS`); the other sources are a library each.

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

from .. import tracing
from .._build import BUILD_DIR, build_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNELS = (
    "hist256", "hist256_batch", "table_build", "encode_lanes", "decode_lanes",
    "hist256_onehot", "carry", "fold",
)
#: The libraries: name -> its sources, ``csrc/<source>.cu``.  The compress
#: path's four sources are linked with the chain's; the others are a
#: library each.
LIBRARIES = {
    "encode_chain": ("encode_chain", "hist256", "hist256_batch", "table_build", "encode_lanes"),
    "decode_lanes": ("decode_lanes",),
    "hist256_onehot": ("hist256_onehot",),
    "bench_ops": ("bench_ops",),
}
#: The library that holds each kernel's C entry.
_LIBRARY_OF = {
    "hist256": "encode_chain", "hist256_batch": "encode_chain", "table_build": "encode_chain",
    "encode_lanes": "encode_chain", "decode_lanes": "decode_lanes",
    "hist256_onehot": "hist256_onehot", "carry": "bench_ops", "fold": "bench_ops",
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Launches of each kernel since the last `reset_launches`.
LAUNCHES = {name: 0 for name in KERNELS}

#: Where nvcc is looked for after $CUDA_HOME, before $PATH.
_CUDA_ROOT = "/usr/local/cuda"

#: ctypes argument types of each ``<name>_launch``.
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PTRS = ctypes.POINTER(_VP)
_ARGTYPES = {
    "hist256": [_VP, _I64, _I32, _I64, _I32, _I32, _VP, _VP],
    "hist256_batch": [_VP, _I32, _I64, _VP, _VP],
    "table_build": [_VP, _I32, _VP, _VP],
    "encode_lanes": [_VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP],
    "decode_lanes": [_VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _I32, _VP, _VP],
    "hist256_onehot": [_VP, _I64, _I32, _VP, _VP],
    "carry": [_VP, _I64, _I32, _VP, _VP, _VP],
    "fold": [_PTRS, ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I32, _VP, _VP, _VP],
}
#: Further C entries ``<entry>_launch`` of a kernel's library: entry ->
#: ((kernel,), ctypes argument types).  A launch through one counts as a
#: launch of its kernel.
_MORE_ENTRIES = {
    "encode_lanes_rows": (
        ("encode_lanes",), [_VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP]
    ),
}
#: C entries ``<entry>_launch`` of ``csrc/encode_chain.cu`` that queue
#: several kernels: entry -> (the kernels in order, ctypes argument
#: types).  A call counts one launch of each; while the recorder is on it
#: is the span ``launch.encode_chain``.
CHAINS = {
    "encode_chain": (
        ("hist256", "table_build", "encode_lanes"),
        [_VP, _I64, _I32, _I64, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP],
    ),
    "encode_chain_batch": (
        ("hist256_batch", "table_build", "encode_lanes"),
        [_VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP],
    ),
}
#: Every C entry: entry -> (the kernels a call launches, ctypes argument
#: types).  An entry lives in the library of its first kernel.
_ENTRIES = {name: ((name,), _ARGTYPES[name]) for name in KERNELS} | _MORE_ENTRIES | CHAINS
#: Calls of each C entry since the last `reset_launches`.
CALLS = {entry: 0 for entry in _ENTRIES}
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
    """Each C entry ``<entry>_launch`` by entry name (a kernel's name, or
    one of `_MORE_ENTRIES` or `CHAINS`), the libraries compiled first if
    needed (all at once).  Raises when nvcc is missing or a build fails."""
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
        for entry, (kernels, argtypes) in _ENTRIES.items():
            fn = getattr(dlls[_LIBRARY_OF[kernels[0]]], f"{entry}_launch")
            fn.argtypes = argtypes
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
    for name in KERNELS:
        LAUNCHES[name] = 0
    for entry in CALLS:
        CALLS[entry] = 0
    for path in DECODE_PATHS:
        DECODE_PATHS[path] = 0


def launch(entry: str, *args) -> None:
    """Call ``<entry>_launch(*args)`` and count the call and a launch of
    each of its kernels; raises on a CUDA error.  The C call is the span
    ``launch.<kernel>`` (``launch.encode_chain`` for a chain) while the
    recorder (`tracing`) is on."""
    kernels = _ENTRIES[entry][0]
    name = "encode_chain" if entry in CHAINS else kernels[0]
    fn = load()[entry]
    if tracing.ON:
        with tracing.span("launch." + name):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    CALLS[entry] += 1
    for kernel in kernels:
        LAUNCHES[kernel] += 1


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device: read
    directly where this build of torch has the call (its CUDA builds do),
    else through a ``torch.cuda.Stream`` object, which costs the host
    more."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


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
