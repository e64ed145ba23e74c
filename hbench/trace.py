"""The profiler's view of a traced slice of one half of the window.

In a ``--trace 1`` run each half keeps ``torch.profiler`` (CPU and CUDA
activity) on for a slice of its requests, marked by the benchmark's own
spans: ``hbench.<half>.slice`` around the slice, ``hbench.<half>.call``
around each API call and ``hbench.<half>.wait`` around each synchronize.
`Slice.read` sums the device operations inside the slice (kernels,
memsets, copies; the profiler's device entries only, as
``huffman_tpu_torch/bench/harness.py:device_ops`` does), merges them into
busy time, and names each idle gap by the span the host was in.
"""

from __future__ import annotations

import bisect

import torch


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))


def warm_up(cuda: bool) -> None:
    """Start and stop the profiler once: its first start (CUPTI's) takes
    long enough to eat a slice."""
    prof = _profiler(cuda)
    prof.start()
    prof.stop()


class Slice:
    def __init__(self, half: str, cuda: bool):
        self.half, self.cuda = half, cuda
        self.requests = 0
        self._prof = None
        self._mark = None

    def start(self) -> None:
        self._prof = _profiler(self.cuda)
        self._prof.start()
        self._mark = torch.profiler.record_function(f"hbench.{self.half}.slice")
        self._mark.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def span(self, what: str):
        """The host span of a request's ``call`` or ``wait`` in the slice."""
        return torch.profiler.record_function(f"hbench.{self.half}.{what}")

    def read(self) -> dict | None:
        """``busy_s``, ``window_s``, ``device_s`` (the sum of the device
        operations), ``requests``, ``ops`` {name: seconds} and ``gaps``
        {what the host was doing: idle seconds}; None where the slice saw
        no device operation."""
        from torch.autograd import DeviceType

        events = self._prof.events()
        host = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("hbench.")
        )
        bounds = [h for h in host if h[2].endswith(".slice")]
        spans = [h for h in host if not h[2].endswith(".slice")]
        # The device side of the benchmark's own spans is not an operation.
        dev = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in events
            if e.device_type == DeviceType.CUDA and not e.name.startswith("hbench.")
        )
        if not bounds or not dev:
            return None
        lo, hi = bounds[0][0], bounds[0][1]
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
        ops: dict[str, float] = {}
        for a, b, n in dev:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        busy, gaps, edge = 0.0, {}, lo
        starts = [s[0] for s in spans]
        for a, b, _ in dev + [(hi, hi, None)]:
            if a > edge:
                label = self._doing(spans, starts, (edge + a) / 2)
                gaps[label] = gaps.get(label, 0.0) + (a - edge) / 1e6
            if b > edge:
                busy += (b - max(a, edge)) / 1e6
                edge = b
        return {
            "busy_s": busy,
            "window_s": (hi - lo) / 1e6,
            "device_s": sum(ops.values()),
            "requests": self.requests,
            "ops": ops,
            "gaps": gaps,
        }

    def _doing(self, spans, starts, t) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            what = "the API call" if spans[i][2].endswith(".call") else "synchronize"
            return f"{self.half}: host in {what}"
        return f"{self.half}: host between requests"
