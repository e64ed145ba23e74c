"""Copies between the host and a codec's device that wait on nothing
queued after them.

PyTorch's blocking copies wait for the whole stream: ``t.cpu()`` waits
for every kernel queued before it on ``t``'s stream, and
``torch.from_numpy(a).to("cuda")`` synchronises the stream after its
copy.  The block pipeline (``container.PIPELINE_DEPTH``) queues block
i+1's kernels before it reads block i back, so a blocking copy would make
the host wait for block i+1 as well.  Here every copy between the host
and a card is queued with ``non_blocking=True`` on the current stream
through pinned host memory, and a CUDA event recorded right after it
marks it done; the host waits on that event alone.  Copies stay on the
stream of the kernels that produce or consume the data (no side stream):
the device work a block runs is a few hundredths of a millisecond against
tens of milliseconds of host work (``PERF.md`` §5), so letting a copy run
beside the next block's kernels would gain nothing, and one stream keeps
the caching allocator's reuse of device memory safe without
``record_stream``.

On the CPU the same code runs on plain tensors: a tensor already on the
host is its own host copy, copies into it are synchronous, and there is
no event.

The host's time blocked on a copy's event, in `HostCopy.wait` and in
`PinnedRing.upload`'s wait for its buffer, is the span ``staging.wait``
(`tracing`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing


def _event_after(device: torch.device) -> torch.cuda.Event:
    """A CUDA event recorded on ``device``'s current stream."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class HostCopy:
    """Device tensors queued for a copy into pinned host tensors, and the
    event after the copies; `wait` returns them as numpy arrays."""

    def __init__(self, *tensors: torch.Tensor):
        device = tensors[0].device
        if device.type == "cuda":
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = _event_after(device)
        else:
            self._host, self._event = list(tensors), None

    def wait(self) -> list[np.ndarray]:
        """The host arrays, once this copy (and only what was queued
        before it) is done."""
        if self._event is not None:
            with tracing.span("staging.wait"):
                self._event.synchronize()
            self._event = None
        return [h.numpy() for h in self._host]


class PinnedRing:
    """Host buffers for copies to ``device``, used in turn: one for each
    block in flight.  A buffer is written again only after the event
    recorded after the copy out of it has passed."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._bufs: list[torch.Tensor | None] = [None] * slots
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._turn = 0

    def upload(self, nbytes: int, fill) -> torch.Tensor:
        """A (nbytes,) uint8 tensor on the device holding what
        ``fill(buf)`` writes into ``buf``, a (nbytes,) uint8 numpy view
        of the next host buffer (pinned on a card).  On a card the copy is
        queued and the call returns without waiting for it."""
        i = self._turn
        self._turn = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            with tracing.span("staging.wait"):
                self._events[i].synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(
                max(nbytes, 1), dtype=torch.uint8, pin_memory=self._cuda
            )
        host = buf[:nbytes]
        fill(host.numpy())
        out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        out.copy_(host, non_blocking=self._cuda)
        if self._cuda:
            self._events[i] = _event_after(self.device)
        return out
