"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The four sources compile with nvcc for ``sm_90a`` into one shared
library with a plain C interface under ``build/torch_kernels/`` at first
use, and are called through ctypes: every pointer and the stream are
``c_void_p``, the stream is PyTorch's current one, and each C entry
returns ``cudaGetLastError()`` after its launch.

``LAUNCHES`` counts the launches of each kernel, so a caller can show
that a path really went through the kernels.  It and the library handle
are the module's only state.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from .._build import BUILD_DIR, build_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNELS = ("hist256", "table_build", "encode_lanes", "decode_lanes")
_SOURCES = [os.path.join(_CSRC, f"{name}.cu") for name in KERNELS]
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Launches of each kernel since the last `reset_launches`.
LAUNCHES = {name: 0 for name in KERNELS}

#: Where nvcc is looked for after $CUDA_HOME, before $PATH.
_CUDA_ROOT = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None
_build_log = ""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), _CUDA_ROOT):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load() -> ctypes.CDLL:
    """The kernel library, compiled first if needed.  Raises when nvcc is
    missing or the build fails."""
    global _lib, _build_log
    with _lock:
        if _lib is not None:
            return _lib
        path, _build_log = build_library(
            "huffman_tpu_torch_kernels", _nvcc(), _FLAGS, _SOURCES,
            os.path.join(BUILD_DIR, "torch_kernels"),
        )
        lib = ctypes.CDLL(path)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hist256_launch.argtypes = [vp, i64, i32, i64, i32, i32, vp, vp]
        lib.table_build_launch.argtypes = [vp, vp, vp]
        lib.encode_lanes_launch.argtypes = [vp, vp, i32, i32, i32, vp, vp, vp]
        lib.decode_lanes_launch.argtypes = [vp, i32, i32, vp, vp, vp, i32, vp, vp]
        for name in KERNELS:
            getattr(lib, f"{name}_launch").restype = i32
        _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (register and shared-memory use per kernel) from the
    build this process made; empty when the library was already built."""
    return _build_log


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)`` and count it; raises on a CUDA error."""
    rc = getattr(load(), f"{name}_launch")(*args)
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
