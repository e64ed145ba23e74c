"""Histogram variants raced on one GPU.

Counterpart: ``tools/hist_experiments.py``.  Each entry counts the same
uniform random block (``rng.integers(0, 256, n)``, seed 0) and is checked
against `histogram256`:

  hist256   the production kernel (shared-memory atomics), the card's
            counterpart of the TPU's ``base``
  base, bf16cmp, f32cmp, i8dot, wide
            the TPU variant names, each run as the MMA type it maps to
            (``ops.hist_variants.VARIANTS``): one-hot products on the
            tensor cores
  bincount  ``torch.bincount``, the library yardstick (timed only; the
            port never calls it)

Each row gives the sustained ms and GiB/s of the TPU tool's body, the
int32 sum of ``fn(data + pert)`` folded into the accumulator
(`bench.fused.carry` and `bench.fused.fold`), from `sustained_seconds`
(CUDA-graph replays; ``bincount`` reads its maximum back to the host, so
it cannot be captured and is timed by CUDA events around back-to-back
calls), the device-busy ms of one ``fn(data)`` from the profiler (the
sustained body also carries its 0 onto every byte, a full pass over the
block), and the kernel launches of one call.

Usage: python3 -m huffman_tpu_torch.tools.hist_experiments [n_mib]
(default 16; n_mib * 2^20 must be a multiple of 2^19).
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..bench import fused
from ..bench.harness import card_line, device_busy_ms, sustained_seconds
from ..ops import _cuda
from ..ops.hist_variants import hist_variant, mma_type
from ..ops.lookup import histogram256

TPU_VARIANTS = ("base", "bf16cmp", "f32cmp", "i8dot", "wide")


def _bincount(x: torch.Tensor) -> torch.Tensor:
    return torch.bincount(x, minlength=256)


def _events_seconds(fn, reps: int, tries: int) -> float:
    """Best seconds per call of ``reps`` back-to-back calls of ``fn()``
    on the current CUDA device, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(tries):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    return best


def race_block(n: int) -> np.ndarray:
    """The race's uniform block of ``n`` bytes, as the TPU tool makes it."""
    return np.random.default_rng(0).integers(0, 256, n).astype(np.uint8)


def race(n: int = 16 << 20, reps: int = 64, tries: int = 3) -> list[dict]:
    """The race on the card over ``race_block(n)``: see `race_on`."""
    return race_on(torch.from_numpy(race_block(n)).to("cuda"), reps, tries)


def race_on(data: torch.Tensor, reps: int = 64, tries: int = 3) -> list[dict]:
    """One row per entry (see the module docstring) over ``data``, on its
    device: ``name``, ``kind`` (atomics, the MMA type, or library),
    ``ok``, ``ms``, ``gib_s``, ``timing`` (graph, events or host),
    ``device_ms`` (None off a card) and ``launches``."""
    dev, n = data.device, data.numel()
    ref = histogram256(data)
    entries = [("hist256", "atomics", histogram256)]
    entries += [
        (v, mma_type(v), functools.partial(hist_variant, variant=v)) for v in TPU_VARIANTS
    ]
    entries.append(("bincount", "library", _bincount))

    rows = []
    for name, kind, fn in entries:
        before = dict(_cuda.LAUNCHES)
        got = fn(data)
        launches = sum(_cuda.LAUNCHES[k] - before[k] for k in before)
        ok = torch.equal(got.to(torch.int64), ref.to(torch.int64))
        if kind == "library" and dev.type == "cuda":
            with torch.cuda.device(dev):
                sec = _events_seconds(lambda fn=fn: fn(data), reps, tries)
            timing = "events"
        else:
            def body(acc, fn=fn):
                counts = fn(fused.carry(data, acc)).to(torch.int32)  # bincount's int64 on the CPU
                fused.fold(acc, counts)

            sec = sustained_seconds(body, reps=reps, tries=tries, device=dev)
            timing = "graph" if dev.type == "cuda" else "host"
        rows.append({
            "name": name, "kind": kind, "ok": ok, "ms": sec * 1e3,
            "gib_s": n / sec / 2**30, "timing": timing, "device_ms": None,
            "launches": launches,
        })
    if dev.type == "cuda":  # the profiler last: it slows later launches
        for row, (_, _, fn) in zip(rows, entries):
            row["device_ms"] = device_busy_ms(lambda fn=fn: fn(data))
    return rows


def format_row(r: dict) -> str:
    dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.6f} ms"
    return (
        f"{r['name']:10s} {r['kind']:8s} {'OK ' if r['ok'] else 'BAD'} "
        f"{r['ms']:8.3f} ms {r['gib_s']:8.2f} GiB/s ({r['timing']}); "
        f"device {dev}, {r['launches']} launch(es)"
    )


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    n = int(float(args[0]) * (1 << 20)) if args else 16 << 20
    print(f"card: {card_line()}")
    for row in race(n):
        print(format_row(row))


if __name__ == "__main__":
    main()
