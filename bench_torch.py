"""Benchmark: the port's codec round trip on one NVIDIA GPU.

The counterpart of ``bench.py``, which times the JAX package on a TPU:
this times the same program through ``huffman_tpu_torch`` on the card.
It prints ONE JSON line on stdout, ALWAYS:

  {"metric": ..., "value": N, "unit": "GiB/s", "vs_baseline": N, "detail": {...}}

On failure or timeout the line has ``"value": null`` with ``error``,
``stage``, ``partial`` and ``last_known_good``, and the process exits
non-zero.  There is no fallback: without a CUDA device, or with a kernel
that does not build or launch, the line is a failure line.

Workload: ``biased_u8(16 MiB, 0)``, the reference's headline biased
distribution, at the default 131072 lanes.  Baseline: the reference's
combined biased rate on a Ryzen 9950X, 1.830 GiB/s (BASELINE.md).
``value`` is the combined rate n / (t_c + t_d); ``vs_baseline`` is
value / 1.830.  ``ratio`` is n over the serialized blob's bytes,
``ratio_payload`` n over the payload's (the bit counts' sum / 8).

Bodies, as ``bench.py``'s (``bench.harness.encode_body`` and
``decode_body``): compress is ``encode_device`` (sampled hist256 ->
table_build -> encode_lanes) of the block plus a carried 0; decompress is
``decode_lanes`` of the first w rows of the words, w from
``decode_statics`` as ``_decode_full`` takes them, with the carried 0
added to those rows alone.  ``bench.harness.sustained_seconds`` times
each: one step captured in a CUDA graph, R replays between CUDA events,
cost (t(R) - t(1)) / (R - 1), reps 64, best of 4.

Watchdog: CUDA init, the kernels' build and the first fetch must end
within BENCH_PROBE_DEADLINE_S (default 150 s), the whole run within
BENCH_DEADLINE_S (default 540 s).  ``--prewarm`` builds the kernels and
runs once under 300 s / 1800 s.

Supervisor (the default entry): prints a provisional null line on
stderr, runs the measurement in a ``--once`` child and passes its line
and exit code through, with ``last_known_good`` in a failure line.  A
hang in the ``cuda probe`` stage is retried in a fresh child once a
``--probe`` child (CUDA init and one fetch under
BENCH_TINYPROBE_DEADLINE_S, default 45 s) answers, while
BENCH_SUPERVISOR_BUDGET_S (default 1500 s) leaves room for a whole run.

Every successful run writes its line, with the card and a UTC time, to
``build/torch/bench_last_good.json``; ``benchmarks/last_good.json``
belongs to ``bench.py`` and is never touched.

    python3 bench_torch.py [--once | --prewarm]
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

METRIC = "biased 16MiB compress+decompress sustained, 1 chip"
REF_COMBINED_GIB_S = 1.830
N = 16 << 20
GIB = 1 << 30
LAST_GOOD_PATH = pathlib.Path(__file__).resolve().parent / "build" / "torch" / "bench_last_good.json"


def _null_line(error: str, **extra) -> dict:
    return {"metric": METRIC, "value": None, "unit": "GiB/s", "vs_baseline": None,
            "error": error, **extra}


def _read_last_good():
    """The last successful line of this entry on this checkout, or None."""
    try:
        return json.loads(LAST_GOOD_PATH.read_text())
    except (OSError, ValueError):
        return None


def _write_last_good(record: dict) -> None:
    try:
        LAST_GOOD_PATH.parent.mkdir(parents=True, exist_ok=True)
        LAST_GOOD_PATH.write_text(json.dumps(record, indent=1) + "\n")
    except OSError:
        pass  # the line is printed all the same; the record is best-effort


class Watch:
    """The stage, partial readings and deadline of one measurement
    process, and a watchdog thread that prints the failure line and ends
    the process once the deadline passes.  The process prints one line,
    by `emit`, whoever prints it first."""

    def __init__(self, deadline: float):
        self.stage = "startup"
        self.partial: dict = {}
        self.deadline = deadline
        self.done = False
        self._lock = threading.Lock()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.done:
            if time.monotonic() > self.deadline:
                if self.emit(self.failure(f"watchdog timeout at stage '{self.stage}'")):
                    os._exit(1)
                return
            time.sleep(0.5)

    def failure(self, error: str) -> dict:
        return _null_line(error, stage=self.stage, partial=dict(self.partial),
                          last_known_good=_read_last_good())

    def emit(self, line: dict) -> bool:
        """Print the process's line; False if one was printed already."""
        with self._lock:
            if self.done:
                return False
            self.done = True
            print(json.dumps(line), flush=True)
            return True


def run(prewarm: bool = False, *, device: str = "cuda", n: int = N, reps: int = 64,
        tries: int = 4, max_reps: int = 512) -> dict:
    """One measurement in this process: prints the line (a failure line
    if it raises) and returns it.  ``device``, ``n``, ``reps``, ``tries``
    and ``max_reps`` are for the CPU tests; the command line always times
    ``cuda`` at 16 MiB, reps 64, tries 4."""
    t_start = time.monotonic()
    probe_s = float(os.environ.get("BENCH_PROBE_DEADLINE_S", "150"))
    total_s = float(os.environ.get("BENCH_DEADLINE_S", "540"))
    if prewarm:
        probe_s, total_s = 300.0, 1800.0
    watch = Watch(t_start + probe_s)
    try:
        return _measure(watch, t_start + total_s, device, n, reps, tries, max_reps, t_start)
    except Exception as e:
        watch.emit(watch.failure(f"{type(e).__name__}: {e}"))
        raise
    finally:
        watch.done = True  # stops the watchdog


def _measure(watch, total_deadline, device, n, reps, tries, max_reps, t_start) -> dict:
    import torch

    from huffman_tpu_torch import TorchCodec
    from huffman_tpu_torch.bench.harness import (
        card_line,
        decode_body,
        encode_body,
        sustained_method,
        sustained_seconds,
    )
    from huffman_tpu_torch.bench.workloads import biased_u8
    from huffman_tpu_torch.ops import _cuda

    # CUDA init, the kernels' build, and one trivial fetch; a second fetch
    # measures the host's round trip to the device.
    watch.stage = "cuda probe"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
        torch.cuda.init()
        t0 = time.perf_counter()
        _cuda.load()
        watch.partial["build_s"] = round(time.perf_counter() - t0, 3)
        card = card_line()
    else:
        card = str(dev)

    def fetch():
        return float(torch.ones(8, device=dev).sum())

    fetch()
    t0 = time.perf_counter()
    fetch()
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    watch.partial["dispatch_ms"] = round(dispatch_ms, 4)
    watch.deadline = total_deadline

    watch.stage = "roundtrip check"
    data = torch.from_numpy(biased_u8(n, 0)).to(dev)
    codec = TorchCodec(device=dev)
    _cuda.reset_launches()
    comp = codec.encode_device(data)
    if not torch.equal(codec.decode_device(comp), data):
        raise RuntimeError("round-trip mismatch")
    # The whole blob, header and counts included, as bench.py counts it.
    ratio = n / len(codec.serialize(comp))
    ratio_payload = n / (int(comp.bit_counts.sum()) / 8)

    timing = dict(reps=reps, tries=tries, max_reps=max_reps, device=dev)
    watch.stage = "compress timing"
    t_c = sustained_seconds(encode_body(codec, data), **timing)
    watch.partial["compress_GiB_s"] = round(n / t_c / GIB, 4)

    watch.stage = "decompress timing"
    t_d = sustained_seconds(decode_body(comp), **timing)
    watch.partial["decompress_GiB_s"] = round(n / t_d / GIB, 4)

    combined = n / (t_c + t_d) / GIB
    result = {
        "metric": METRIC,
        "value": round(combined, 4),
        "unit": "GiB/s",
        "vs_baseline": round(combined / REF_COMBINED_GIB_S, 4),
        "detail": {
            "compress_GiB_s": round(n / t_c / GIB, 4),
            "decompress_GiB_s": round(n / t_d / GIB, 4),
            "ratio": round(ratio, 4),
            "ratio_payload": round(ratio_payload, 4),
            "k_lanes": comp.k,
            "dispatch_ms": round(dispatch_ms, 4),
            "roundtrip_ok": True,
            "wall_s": round(time.monotonic() - t_start, 1),
            "card": card,
            "method": sustained_method(dev),
            "build_s": watch.partial.get("build_s"),
            # Wrapper launches since the round trip began: the timed
            # bodies count once each, at their capture, not per replay.
            "launches": dict(_cuda.LAUNCHES),
        },
    }
    if watch.emit(result):
        _write_last_good(dict(result, measured_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())))
    return result


def _probe() -> int:
    """CUDA init and one fetch under BENCH_TINYPROBE_DEADLINE_S: 0 if
    the card answered."""
    watch = Watch(time.monotonic() + float(os.environ.get("BENCH_TINYPROBE_DEADLINE_S", "45")))
    watch.stage = "probe-only"
    try:
        import torch

        float(torch.ones(8, device="cuda").sum())
    except Exception as e:
        watch.emit(watch.failure(f"{type(e).__name__}: {e}"))
        return 1
    watch.done = True
    return 0


def _child(flag: str, timeout: float) -> tuple[int, dict]:
    """Run this script with ``flag`` in a fresh process: (exit code, its
    last JSON line).  A child past ``timeout`` is killed."""
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return 1, _null_line(f"bench child {flag} still running after {timeout:.0f} s; killed")
    lines = [line for line in r.stdout.splitlines() if line.startswith("{")]
    try:
        return r.returncode, json.loads(lines[-1])
    except (IndexError, ValueError):
        return r.returncode, _null_line(f"bench child {flag} printed no JSON line (rc={r.returncode})")


def _supervise() -> int:
    """The measurement in a ``--once`` child, its line passed through;
    a hang at the probe stage retried while the budget allows."""
    budget = float(os.environ.get("BENCH_SUPERVISOR_BUDGET_S", "1500"))
    # Room for one whole run, and the child's own watchdog past it.
    run_s = float(os.environ.get("BENCH_DEADLINE_S", "540"))
    probe_s = float(os.environ.get("BENCH_TINYPROBE_DEADLINE_S", "45"))
    t0 = time.monotonic()

    def remaining() -> float:
        return budget - (time.monotonic() - t0)

    provisional = _null_line(
        "provisional record printed at start; superseded by the final line unless the "
        "process was killed externally", provisional=True, last_known_good=_read_last_good())
    print(json.dumps(provisional), file=sys.stderr, flush=True)
    while True:
        rc, line = _child("--once", run_s + 60)
        hang = (rc != 0 and line.get("stage") == "cuda probe"
                and "watchdog" in str(line.get("error")))
        if not hang or remaining() <= run_s:
            break
        # A card that did not answer: wait for a cheap probe to get an
        # answer before spending another whole attempt.
        while remaining() > run_s and _child("--probe", probe_s + 30)[0] != 0:
            time.sleep(min(30.0, max(0.0, remaining() - run_s)))
    if line.get("value") is None:
        line.setdefault("last_known_good", _read_last_good())
    print(json.dumps(line), flush=True)
    return 0 if rc == 0 and line.get("value") is not None else max(rc, 1)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--probe" in argv:
        return _probe()
    if "--once" in argv or "--prewarm" in argv:
        try:
            run(prewarm="--prewarm" in argv)
        except Exception:
            return 1
        return 0
    return _supervise()


if __name__ == "__main__":
    sys.exit(main())
