"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc for ``sm_90a`` into its own shared
library with a plain C interface under ``build/torch_kernels/`` at first
use, all of them at once (one nvcc process per source), and is called
through ctypes: every pointer and the stream are ``c_void_p``, the
stream is PyTorch's current one, and each C entry returns
``cudaGetLastError()`` after its launch.  The codec's kernels have a
source each, named for it; the measurement harness's two (``carry`` and
``fold``) share ``csrc/bench_ops.cu``.

``LAUNCHES`` counts the launches of each kernel, so a caller can show
that a path really went through the kernels.  It and the library handles
are the module's only state.
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
#: The source of each kernel that is not named for its own.
_SOURCE_OF = {"carry": "bench_ops", "fold": "bench_ops"}
#: The sources, ``csrc/<source>.cu``, one library each.
SOURCES = tuple(dict.fromkeys(_SOURCE_OF.get(name, name) for name in KERNELS))
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
#: (kernel, ctypes argument types).  A launch through one counts as a
#: launch of its kernel.
_MORE_ENTRIES = {
    "encode_lanes_rows": ("encode_lanes", [_VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP]),
}

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
    one of `_MORE_ENTRIES`), the libraries compiled first if needed (all
    at once).  Raises when nvcc is missing or a build fails."""
    global _lib, _build_log
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        out_dir = os.path.join(BUILD_DIR, "torch_kernels")

        def build(name):
            return build_library(
                name, nvcc, _FLAGS, [os.path.join(_CSRC, f"{name}.cu")], out_dir
            )

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            built = list(pool.map(build, SOURCES))
        dlls = {src: ctypes.CDLL(path) for src, (path, _) in zip(SOURCES, built)}
        entries = {name: (name, _ARGTYPES[name]) for name in KERNELS} | _MORE_ENTRIES
        libs = {}
        for entry, (name, argtypes) in entries.items():
            fn = getattr(dlls[_SOURCE_OF.get(name, name)], f"{entry}_launch")
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
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch(entry: str, *args) -> None:
    """Call ``<entry>_launch(*args)`` and count a launch of its kernel;
    raises on a CUDA error.  The C call is the span ``launch.<kernel>``
    while the recorder (`tracing`) is on."""
    name = _MORE_ENTRIES[entry][0] if entry in _MORE_ENTRIES else entry
    fn = load()[entry]
    if tracing.ON:
        with tracing.span("launch." + name):
            rc = fn(*args)
    else:
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

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
