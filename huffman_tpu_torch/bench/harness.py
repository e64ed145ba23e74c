"""Benchmark timing harness.

Counterpart: ``huffman_tpu/bench/harness.py``.  Two timing modes:

* **sustained** (device codecs): repeat the body R times with a carried
  data dependency; cost = (t(R) - t(1)) / (R - 1).  On a CUDA device one
  step is captured in a CUDA graph and replayed, timed by CUDA events; on
  the CPU the body runs eagerly under the host clock.
* **wall** (host codecs): classic repeated wall-clock timing.

Results are plain dicts, JSON-serializable, rendered by
:mod:`huffman_tpu_torch.bench.table`.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def sustained_seconds(
    body, reps: int = 32, tries: int = 2, max_reps: int = 512, *, device="cuda"
) -> float:
    """Seconds per run of ``body(pert)``, which returns a float32 scalar
    tensor on ``device``; ``pert`` is a 0-d uint8 tensor that is always 0
    but depends on the previous run's result, so runs cannot be folded
    together.

    On a CUDA device the body runs once to warm up, then one step
    ``acc += body(isnan(acc))`` is captured in a CUDA graph, and R
    replays are timed between CUDA events, best of ``tries``.  The body
    must not read anything back to the host; a failed capture raises.  On
    the CPU the steps run eagerly under the host clock.  The rep count
    escalates x4 while t(R) - t(1) stays within 15 ms, up to ``max_reps``,
    as in the JAX harness.
    """
    dev = torch.device(device)
    acc = torch.zeros((), dtype=torch.float32, device=dev)

    def step():
        acc.add_(body(torch.isnan(acc).to(torch.uint8)))

    if dev.type == "cuda":
        measure = _graph_timer(step, dev, tries)
    elif dev.type == "cpu":
        def measure(r):
            step()
            best = float("inf")
            for _ in range(tries):
                t0 = time.perf_counter()
                for _ in range(r):
                    step()
                best = min(best, time.perf_counter() - t0)
            return best
    else:
        raise ValueError(f"unsupported device {dev}")

    t1 = measure(1)
    tr = measure(reps)
    while tr - t1 <= 0.015 and reps < max_reps:
        reps *= 4
        tr = measure(reps)
    return max((tr - t1) / (reps - 1), 1e-9)


def sustained_method(device) -> str:
    """How `sustained_seconds` times a body on ``device``, for a row to
    name."""
    return "cuda graph replays" if torch.device(device).type == "cuda" else "host clock"


def _graph_timer(step, dev, tries: int):
    """``measure(r)``: best seconds of r replays of ``step`` captured in
    one CUDA graph, by CUDA events."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()  # warm-up: builds the kernels and caches before capture
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

    def measure(r):
        with torch.cuda.device(dev):
            graph.replay()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(tries):
                start.record()
                for _ in range(r):
                    graph.replay()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            return best

    return measure


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them;
    raises where there is no nvidia-smi."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_ops(fn, reps: int = 20) -> list[tuple[str, float, float]]:
    """(name, count a call, device ms a call) of every device operation
    (kernel, memset, copy) in the profiler's trace of ``reps`` calls of
    ``fn()``.  Host operations are left out: an aten op that launched a
    kernel carries that kernel's time as its own as well.  Once the
    profiler has run, CUDA launches of the process cost the host more, so
    take event and graph timings first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count / reps, e.self_device_time_total / reps / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_busy_ms(fn, reps: int = 20) -> float:
    """Mean device-busy milliseconds (kernels, memsets, copies) per call
    of ``fn()``: the sum of `device_ops`."""
    return sum(ms for _, _, ms in device_ops(fn, reps))


def wall_seconds(fn, min_time: float = 0.3) -> float:
    fn()  # warm
    reps, total = 0, 0.0
    best = float("inf")
    while total < min_time:
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        total += dt
        reps += 1
        if reps > 1000:
            break
    return best


def encode_body(codec, data):
    """``bench.py``'s compress body on a (n,) uint8 block on the codec's
    device: ``encode_device`` of the block plus the carried 0, its bit
    counts and coding table summed.  Nothing is copied to the host."""

    def enc_once(pert):
        c = codec.encode_device(data + pert)
        return (c.bit_counts.sum() + c.tables["enc_table"].sum()).to(torch.float32)

    return enc_once


def decode_body(comp):
    """``bench.py``'s decompress body (``_decode_full``) on a compressed
    block: the lane decode of the first w rows of its words
    (`decode_statics`), the carried 0 added to those rows alone, and the
    block's n bytes summed in int32.  The block's metadata is fetched
    here (once, cached), so the body copies nothing to the host."""
    from ..models.torch_codec import decode_statics
    from ..ops.decode_bits import decode_lanes

    n = comp.raw_size
    s = -(-n // comp.k)
    # The leading rows of the row-major (W, K) words: a contiguous view.
    words = comp.words[: max(decode_statics(comp.meta(), s), 1)]
    eb, gr, sy = comp.tables["e_bound"], comp.tables["g_rank"], comp.tables["sorted_syms"]

    def dec_once(pert):
        o = decode_lanes(words + pert.to(torch.int32), eb, gr, sy, s)
        return o.reshape(-1)[:n].sum(dtype=torch.int32).to(torch.float32)

    return dec_once


def bench_torch_codec(codec, raw: bytes, reps: int = 32) -> dict:
    """Sustained compress/decompress rates for a TorchCodec on its device,
    of `encode_body` and `decode_body`, neither copying to the host."""
    n = len(raw)
    data = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy()).to(codec.device)
    comp = codec.encode_device(data)
    ok = codec.decode_device(comp).cpu().numpy().tobytes() == raw
    t_c = sustained_seconds(encode_body(codec, data), reps=reps, device=codec.device)
    t_d = sustained_seconds(decode_body(comp), reps=reps, device=codec.device)
    blob = codec.serialize(comp)
    return {
        "method": codec.name,
        "streams": comp.k,
        "compress_bps": n / t_c,
        "decompress_bps": n / t_d,
        "ratio": len(blob) / n,
        "roundtrip_ok": bool(ok),
    }


def bench_bytes_codec(codec, raw: bytes, name: str, streams) -> dict:
    """Wall-clock rates for any {compress, decompress} bytes codec."""
    blob = codec.compress(raw)
    ok = codec.decompress(blob) == raw
    t_c = wall_seconds(lambda: codec.compress(raw))
    t_d = wall_seconds(lambda: codec.decompress(blob))
    return {
        "method": name,
        "streams": streams,
        "compress_bps": len(raw) / t_c,
        "decompress_bps": len(raw) / t_d,
        "ratio": len(blob) / len(raw),
        "roundtrip_ok": bool(ok),
    }


def run_suite(workload_names, codecs, n, file_path=None, reps=32) -> dict:
    """codecs: list of ("torch", TorchCodec) / ("bytes", name, streams, codec)."""
    from .workloads import make_workload

    results = {}
    for wname in workload_names:
        raw = make_workload(wname, n, file_path)
        rows = []
        for spec in codecs:
            if spec[0] == "torch":
                rows.append(bench_torch_codec(spec[1], raw, reps=reps))
            else:
                _, name, streams, codec = spec
                rows.append(bench_bytes_codec(codec, raw, name, streams))
        results[wname] = {"bytes": len(raw), "rows": rows}
    return results
