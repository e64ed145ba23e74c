"""One run of one cell: set-up, the measured window, the check, the line.

Closed loop, one request in flight.  A request is one call of the cell's
entry point on one request input, complete when its outputs are ready:
``torch.cuda.synchronize()`` after the call.  The window's first
half runs compress requests, its second half decompress requests of the
encodings that set-up made through the same path; each half cycles
through its inputs in order.  A half's rate is the bytes of all the
requests that completed in it over its wall time, from its start to the
end of its last request.  No request is timed alone: a device request
lasts a tenth of a millisecond, below what the host's clock resolves in
one reading, and CUDA events around each would add a third to it.

Set-up is everything from the process's start to the window: importing
torch and the program, CUDA's start, loading (or the first time building)
the kernels, the pool from the seed, one compress of every request input
and one decompress of every encoding.  After the window the peak device
memory is read, the encodings are serialized for the ratio, and the
sampled outputs are held to the reference (the profile's ``Tally``).

The cell's parts are found by name (`spec`).  Its entry point is the class
``Api`` of ``hbench/entries/<api>.py``: ``Api(codec, pool, traffic)`` with

* ``inputs``, the request inputs, and ``raw(i)``, input ``i`` as (B, n)
  host bytes;
* ``compress(x)`` and ``decompress(encoding)``, one request each;
* ``returns_blobs``: True where a compress request returns the blob itself
  (then the ratio is over the window's blobs); else ``encoded(out)``, a
  compress request's output on the host (words, bits, enc, k), and
  ``bits(out)``, its (B, K) bit counts;
* ``decoded(out)``, a decompress request's output as host bytes, and
  ``blobs(encoding)``, the blobs of one encoding.

Only ``compress`` and ``decompress`` run on every rank of a run of several
(`ranks`); the rest runs on rank 0 alone, after the window.  There every
half is a number of requests fixed by rank 0 before the window, not a
time: see `run_half`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import resource
import statistics
import sys
import time

import numpy as np
import torch

from . import peaks, ranks, spec
from . import traffic as gen
from .trace import Slice, warm_up

#: Top-level modules that no run may load: JAX, and the JAX package the
#: port was made from (``huffman_tpu_torch`` is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "huffman_tpu")
#: A traced slice runs from 40 % to 60 % of its half, or for this many
#: requests, whichever ends first.
SLICE_FROM, SLICE_TO, SLICE_REQUESTS = 0.4, 0.6, 4000


@dataclasses.dataclass
class Half:
    name: str
    requests: int = 0
    failed: int = 0
    bytes: int = 0
    out_bytes: int = 0
    wall_s: float = 0.0
    call_s: list = dataclasses.field(default_factory=list)
    launches: int = 0
    work_bytes: float = 0.0  # least bytes a request moves (`peaks`)
    trace: dict | None = None


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: spec.Cell
    setup_s: float
    halves: dict
    ratio: float
    spans: dict


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from the seed."""

    def __init__(self, size: int, seed: str):
        self.size, self.items, self.seen = size, [], 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def _synchronize(device: torch.device):
    """What ends a request: a synchronize on a card, nothing on the CPU."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _launches() -> int:
    from huffman_tpu_torch.ops import _cuda

    return sum(_cuda.LAUNCHES.values())


def run_half(half: Half, call, inputs, sizes, seconds, device, sample, traced, out_size=None,
             count=None):
    """Requests of ``call`` on ``inputs`` in turn for ``seconds``; where
    ``count`` is given (a run of several ranks, whose requests must pair
    up), exactly ``count`` requests, traced from the 40 % to the 60 % one."""
    sync = _synchronize(device)
    sl = Slice(half.name, device.type == "cuda") if traced else None
    launches0 = _launches()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    sl_from, sl_to = t_start + SLICE_FROM * seconds, t_start + SLICE_TO * seconds
    state, end = "before", t_start
    i = 0
    while True:
        now = time.perf_counter()
        if (now >= deadline) if count is None else (i >= count):
            break
        if sl is not None:
            if count is None:
                start_due, stop_due = now >= sl_from, now >= sl_to
            else:
                start_due, stop_due = i >= SLICE_FROM * count, i >= SLICE_TO * count
            if state == "before" and start_due:
                sl.start()
                state = "in"
                sl_to = time.perf_counter() + (SLICE_TO - SLICE_FROM) * seconds
            elif state == "in" and (stop_due or sl.requests >= SLICE_REQUESTS):
                sl.stop()
                state = "after"
        j = i % len(inputs)
        i += 1
        in_slice = state == "in"
        try:
            with sl.span("call") if in_slice else contextlib.nullcontext():
                t_req = time.perf_counter()
                out = call(inputs[j])
                t_call = time.perf_counter() - t_req
            with sl.span("wait") if in_slice else contextlib.nullcontext():
                sync()
        except Exception as e:  # a failed request counts as failed, and the run goes on
            half.failed += 1
            print(f"{half.name} request {i - 1} raised {type(e).__name__}: {e}", file=sys.stderr)
            continue
        end = time.perf_counter()
        half.requests += 1
        half.bytes += sizes[j]
        if out_size is not None:
            half.out_bytes += out_size(out)
        if in_slice:
            sl.requests += 1
        else:
            half.call_s.append(t_call)
        if sample is not None:
            sample.offer((j, out))
    if state == "in":
        sl.stop()
    half.wall_s = end - t_start
    half.launches = _launches() - launches0
    if sl is not None and state != "before":
        half.trace = sl.read()


@contextlib.contextmanager
def _method_spans(cls, names, store):
    """Time each call of the methods ``names`` of ``cls`` into ``store``."""
    saved = {n: cls.__dict__[n] for n in names if n in cls.__dict__}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                store[name].append(time.perf_counter() - t)

        return wrapper

    for n, fn in saved.items():
        setattr(cls, n, timed(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _setup_call(call, x, paces: list | None, sync):
    """``call(x)`` in set-up; where ``paces`` is a list (a run of several
    ranks), ended by ``sync`` and its seconds appended."""
    if paces is None:
        return call(x)
    t = time.perf_counter()
    out = call(x)
    sync()
    paces.append(time.perf_counter() - t)
    return out


def _request_count(paces: list[float], seconds: float) -> int:
    """Requests that fill ``seconds`` at the median pace of set-up's calls,
    the first left out where there are others: it loads the kernels."""
    pace = statistics.median(paces[1:] or paces) if paces else seconds
    return max(1, round(seconds / pace))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             codec=None, t0: float | None = None,
             group: ranks.Group = ranks.ONE) -> tuple[dict | None, list[str]]:
    """One run.  Returns (the result line, the check lines for stderr);
    on a rank other than 0 of a run of several, (None, []) once the
    window's last collective is made."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    lead, several = group.rank == 0, group.world > 1
    trace = trace and lead
    if dev.type == "cuda":
        torch.cuda.init()
    t_init = time.perf_counter()
    codec = cell.profile.make_codec(cfg, dev) if codec is None else codec
    pool = gen.make_pool(cfg, tr, seed, dev, cell.root)
    api = cell.entry.Api(codec, pool, tr)
    sizes = [api.raw(j).size for j in range(len(api.inputs))]
    t_pool = time.perf_counter()
    sync = _synchronize(dev)
    paces = {h: [] if several else None for h in ("compress", "decompress")}
    encodings = [_setup_call(api.compress, x, paces["compress"], sync) for x in api.inputs]
    setup_failed = 0
    for e in encodings:
        try:
            _setup_call(api.decompress, e, paces["decompress"], sync)
        except Exception as err:  # counted with the window's failed requests
            setup_failed += 1
            print(f"set-up decompress raised {type(err).__name__}: {err}", file=sys.stderr)
    if trace:
        warm_up(dev.type == "cuda")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = dict.fromkeys(paces)
    if several:
        counts = dict(zip(paces, group.broadcast(
            [_request_count(paces[h], seconds / 2) for h in paces])))
    t_setup = time.perf_counter()
    setup_s = t_setup - t0
    who = f"rank {group.rank}: " if several else ""
    print(f"{who}set-up {setup_s:.3f} s: imports and CUDA's start {t_init - t0:.3f}, pool "
          f"{t_pool - t_init:.3f}, encodings and decodes (kernel build or load first) "
          f"{t_setup - t_pool:.3f}", file=sys.stderr)

    halves = {"compress": Half("compress"), "decompress": Half("decompress")}
    samples = {h: Reservoir(tr["check_requests"], f"{seed}:{h}") if lead else None
               for h in halves}
    spans = {"serialize": [], "deserialize": []}
    out_size = len if api.returns_blobs else None
    with _method_spans(type(codec), spans, spans) if trace else contextlib.nullcontext():
        run_half(halves["compress"], api.compress, api.inputs, sizes, seconds / 2, dev,
                 samples["compress"], trace, out_size, counts["compress"])
        run_half(halves["decompress"], api.decompress, encodings, sizes, seconds / 2, dev,
                 samples["decompress"], trace, count=counts["decompress"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:  # a rehearsal on the host: the process's peak resident bytes
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    peak = group.largest(peak)
    t_window = time.perf_counter()
    if not lead:
        return None, []

    # After the window: the ratio and the least bytes a request moves;
    # then the sampled outputs go to the host, the program's state is
    # freed, and the reference judges them.
    pick = random.Random(seed).sample(range(len(encodings)), min(tr["check_blobs"], len(encodings)))
    raws = [api.raw(j) for j in range(len(api.inputs))]
    if api.returns_blobs:
        c = halves["compress"]
        ratio = c.bytes / c.out_bytes if c.out_bytes else 0.0
        blobs = [(j, api.blobs(encodings[j])) for j in pick]
        blobs += [(j, api.blobs(out)) for j, out in samples["compress"].items]
        encoded = []
    else:
        all_blobs = [api.blobs(e) for e in encodings]
        ratio = sum(sizes) / sum(len(b) for bs in all_blobs for b in bs)
        blobs = [(j, all_blobs[j]) for j in pick]
        bits = [api.bits(e) for e in encodings]
        halves["compress"].work_bytes = float(np.mean(
            [cell.profile.compress_bytes(s, b) for s, b in zip(sizes, bits)]))
        halves["decompress"].work_bytes = float(np.mean(
            [cell.profile.decompress_bytes(s, b) for s, b in zip(sizes, bits)]))
        encoded = [(j, api.encoded(out)) for j, out in samples["compress"].items]
    decoded = [(j, api.decoded(out)) for j, out in samples["decompress"].items]
    del pool, api, encodings, samples
    t_check = time.perf_counter()
    tally = cell.profile.Tally(cfg)
    for j, got in encoded:
        tally.encoded(raws[j], got)
    for j, got in decoded:
        tally.decoded(raws[j], got)
    for j, bs in blobs:
        for raw, blob in zip(raws[j], bs):
            tally.blob(raw, blob)
    tally.n["failed"] = setup_failed + sum(h.failed for h in halves.values())
    print(f"window {seconds} s (halves "
          + ", ".join(f"{h.name} {h.requests} requests in {h.wall_s:.3f} s" for h in halves.values())
          + f"), after the window "
          f"{t_check - t_window:.3f} s, reference {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    run = Run(cell, setup_s, halves, ratio, spans)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(h.requests + h.failed for h in halves.values())
    line = {
        "correct": tally.correct() and all(h.requests for h in halves.values()),
        "attempted": attempted,
        "failed": tally.n["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": group.world,
            "memory_peak_bytes": peak,
            "card": peaks.card_line() if dev.type == "cuda" else dev.type,
        },
    }
    traces = [h.trace for h in halves.values() if h.trace]
    if trace:
        line["device"]["busy_s"] = sum(t["busy_s"] for t in traces)
        line["device"]["window_s"] = sum(t["window_s"] for t in traces)
        line["breakdown"] = _breakdown(traces)
    line["checks"] = tally.numbers()
    lines = [f"check {n} {v['value']} limit {v['limit']}" for n, v in line["checks"].items()]
    return line, lines


def _breakdown(traces: list[dict]) -> dict:
    ops, gaps = {}, {}
    for t in traces:
        for n, s in t["ops"].items():
            ops[n] = ops.get(n, 0.0) + s
        for n, s in t["gaps"].items():
            gaps[n] = gaps.get(n, 0.0) + s
    top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:10]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def emit(line: dict, lines: list[str]) -> int:
    """Print the check lines last on stderr and the result last on
    stdout; 3 and no result where a forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for s in lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
