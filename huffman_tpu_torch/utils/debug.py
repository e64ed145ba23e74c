"""Debug helpers, the counterparts of ``huffman_tpu/utils/debug.py``.

* ``dlog(level, ...)``: leveled logging on the host to stderr, gated on
  ``HUFFMAN_TPU_VLOG`` (read once, at import), for framing and
  top-level code; no hot path calls it.
* ``dprint(level, fmt, **tensors)``: prints tensor values; below the
  level it returns at once and copies nothing to the host.  No hot path
  calls it either.
* ``assert_vec_eq``: an elementwise comparison with the JAX version's
  message, for tests.
* ``profile_trace(logdir)``: a ``torch.profiler`` window over the
  enclosed block (CPU and CUDA activities), exported as a Chrome trace.

The JAX module's ``interpret_kernels`` (Pallas interpret mode) has no
counterpart: a switch that ran the kernels' plain versions on the card
would hide which one ran.  The kernels are checked by their plain
versions on CPU tensors and by ``chip_smoke.py``'s exact comparisons on
the card.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

VLOG = int(os.environ.get("HUFFMAN_TPU_VLOG", "0"))


def dlog(level: int, *args) -> None:
    """Leveled log on the host, printed when ``VLOG >= level``."""
    if VLOG >= level:
        print(f"[huffman_tpu_torch:{level}]", *args, file=sys.stderr, flush=True)


def dprint(level: int, fmt: str, **tensors) -> None:
    """``print(fmt.format(**values))`` with each tensor copied to the host
    as a numpy array, when ``VLOG >= level``; otherwise nothing runs."""
    if VLOG >= level:
        values = {
            name: _host(v) if isinstance(v, torch.Tensor) else v for name, v in tensors.items()
        }
        print(fmt.format(**values), flush=True)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_vec_eq(a, b, msg: str = "") -> None:
    """Raise AssertionError naming the first differing positions (or the
    shapes) unless ``a`` and ``b`` (arrays or tensors) are equal."""
    a, b = _host(a), _host(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        neq = np.nonzero(a != b) if a.shape == b.shape else None
        detail = (
            f"first diffs at {[tuple(int(x[i]) for x in neq) for i in range(min(8, len(neq[0])))]}"
            if neq and len(neq[0])
            else f"shapes {a.shape} vs {b.shape}"
        )
        raise AssertionError(f"vectors differ{': ' + msg if msg else ''} ({detail})")


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when ``device`` is a card) and export it as the Chrome
    trace ``<logdir>/trace.json``; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize(device)  # the block's kernels end inside the window
    prof.export_chrome_trace(path)
