"""Run the benchmark suite on the port and render the results tables.

Counterpart: ``tools/run_benchmarks.py``.  Rows: `TorchCodec` at auto
lanes, K = 8192 and K = 32768 on the device (sustained, CUDA graphs), the
host library's ref-profile codec (``NativeHost``) at 32 and 4 streams,
and zlib level 1 (wall clock).

Usage:
  python3 -m huffman_tpu_torch.tools.run_benchmarks [--size BYTES]
      [--file PATH] [--workloads biased,sorted,uniform,lorem,file]
      [--out bench_out/torch_results.json] [--fast]
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

from ..bench import render_markdown, run_suite
from ..bench.harness import card_line
from ..models.torch_codec import TorchCodec
from ..native import NativeCodec


class ZlibCodec:
    """zlib as a bytes codec: a same-box anchor from the standard library
    (an LZ77 window and a Huffman back end, so its ratios are better and
    its speeds lower than a Huffman-only codec's)."""

    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, raw: bytes) -> bytes:
        return zlib.compress(raw, self.level)

    def decompress(self, blob: bytes) -> bytes:
        return zlib.decompress(blob)


def suite_codecs(device="cuda") -> list:
    """The suite's rows, in `run_suite`'s codec-spec form."""
    return [
        ("torch", TorchCodec(device=device)),  # auto lanes
        ("torch", TorchCodec(k=8192, device=device)),
        ("torch", TorchCodec(k=32768, device=device)),
        ("bytes", "NativeHost", 32, NativeCodec(32)),
        ("bytes", "NativeHost", 4, NativeCodec(4)),
        ("bytes", "zlib-1", 1, ZlibCodec(1)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4 << 20)
    ap.add_argument("--file", type=str, default=None)
    ap.add_argument("--workloads", type=str, default="biased,sorted,uniform,lorem,file")
    ap.add_argument("--out", type=str, default="bench_out/torch_results.json")
    ap.add_argument("--fast", action="store_true", help="fewer reps")
    args = ap.parse_args(argv)

    print(f"card: {card_line()}")
    results = run_suite(
        args.workloads.split(","), suite_codecs(), args.size,
        file_path=args.file, reps=8 if args.fast else 32,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(render_markdown(results))
    print(f"results: {args.out}")


if __name__ == "__main__":
    main()
