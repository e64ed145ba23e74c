"""Process-group initialization and the mesh over every rank of the job.

Counterpart: ``huffman_tpu/parallel/distributed.py``, with
``torch.distributed`` in place of ``jax.distributed``.  One process
drives one GPU (or, with the ``gloo`` backend, a share of one card or
the CPU); ranks are host-major, as ``torchrun`` numbers them.

Usage on each rank of a ``torchrun`` job:

    from huffman_tpu_torch.parallel import distributed
    distributed.initialize()                  # env:// from torchrun's variables
    mesh = distributed.pod_mesh(stream_per_host=True)

or with explicit settings (``backend`` "nccl" when each rank has its own
card, "gloo" on the CPU and for ranks that share a card):

    distributed.initialize(backend="gloo", init_method="file:///tmp/store",
                           world_size=2, rank=r)

The ``data`` axis carries no communication, so it may span hosts; the
``stream`` axis all-reduces one 1 KiB histogram a block and belongs
inside a host, which `pod_mesh` ``stream_per_host`` gives.
"""

from __future__ import annotations

import os

import torch.distributed as dist

#: The variables ``torchrun`` sets; any one of them means a launched job.
_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")

#: Resolution state for this process: None (nothing decided yet),
#: "initialized" (a process group is up), or "noop" (no kwargs and no
#: launcher found: one process; a LATER call with explicit kwargs still
#: proceeds).
_state: str | None = None


def initialize(**kwargs) -> None:
    """Initialize the default process group once per process.

    * Explicit ``kwargs`` (``backend``, ``init_method``, ``world_size``,
      ``rank``, ...) go to ``torch.distributed.init_process_group``; a
      failure propagates, so a misconfigured job is never demoted to one
      process.
    * No kwargs: with ``torchrun``'s variables in the environment the
      group starts from ``env://`` (a failure propagates); without them
      the call is a no-op, a one-process run.
    * A process group that is already up counts as initialized, and
      further calls are no-ops.  A no-kwargs no-op does NOT latch against
      a later explicit call.
    """
    global _state
    if _state == "initialized" or (_state == "noop" and not kwargs):
        return
    if dist.is_initialized():
        _state = "initialized"
        return
    if not kwargs:
        if not any(v in os.environ for v in _LAUNCH_VARS):
            _state = "noop"
            return
        kwargs = {"init_method": "env://"}
    dist.init_process_group(**kwargs)
    _state = "initialized"


def pod_mesh(stream: int | None = None, stream_per_host: bool = False):
    """The ('data', 'stream') mesh over every rank (`sharded.make_mesh`).

    Args:
      stream: explicit stream-axis size (must divide the world size).
      stream_per_host: if True, the stream axis is the ranks of one host
        (``LOCAL_WORLD_SIZE``, which ``torchrun`` sets), so the histogram
        all-reduce stays inside a host.
    """
    if stream is None:
        stream = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if stream_per_host else 1
    from .sharded import make_mesh

    return make_mesh(stream=stream)
