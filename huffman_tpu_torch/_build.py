"""Build a shared library from sources at first use, once per content.

The library's file name carries a hash of its sources, the compiler
command and the compiler's version, so an edited source or another
toolchain builds anew and a stale library is never loaded.  Builds are
serialised by a file lock and written under a temporary name that is
renamed into place, so processes that start together (test workers)
never load a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO, "build")


def build_library(
    name: str, compiler: str, flags: list[str], sources: list[str], out_dir: str
) -> tuple[str, str]:
    """Compile ``sources`` into ``out_dir/lib<name>-<hash>.so``.

    Returns (path, compiler output); the output is empty when the library
    was already built.  Raises RuntimeError when the compiler is missing
    or fails.
    """
    try:
        version = subprocess.run(
            [compiler, "--version"], capture_output=True, text=True, check=True
        ).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"compiler {compiler!r} is not usable: {e}") from e
    h = hashlib.sha256()
    h.update(version.encode())
    h.update("\0".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, ""
        tmp = f"{path}.tmp{os.getpid()}"
        r = subprocess.run(
            [compiler, *flags, "-o", tmp, *sources],
            capture_output=True,
            text=True,
            timeout=900,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (rc {r.returncode}):\n{r.stderr[-4000:]}"
            )
        os.replace(tmp, path)
    return path, r.stdout + r.stderr
