"""Single-block rates of small inputs, across sizes and lane counts.

Counterpart: ``tools/bench_small.py``.  For each size (biased bytes) and
each lane count (``auto`` = `default_lanes`), the sustained compress and
decompress GiB/s of `bench.harness.bench_torch_codec` (CUDA-graph
replays on a card), the ratio and the round trip.  A lane count above
the size is skipped, and so is an explicit one equal to the auto choice.
A row that fails raises: there are no error rows.

    python3 -m huffman_tpu_torch.tools.bench_small [--sizes 102400,262144,1048576,4194304] [--reps 64]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..bench.harness import bench_torch_codec, sustained_method
from ..bench.workloads import biased_u8
from ..models.torch_codec import TorchCodec, default_lanes

GIB = 1 << 30


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="102400,262144,1048576,4194304",
                    help="comma-separated block sizes in bytes")
    ap.add_argument("--ks", default="auto,1024,2048,4096")
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--out", default="bench_out/results_small.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    results = {}
    for n in (int(x) for x in args.sizes.split(",")):
        raw = biased_u8(n).tobytes()
        rows = []
        for kspec in args.ks.split(","):
            k = default_lanes(n) if kspec == "auto" else int(kspec)
            if k > n or (kspec != "auto" and k == default_lanes(n)):
                continue
            r = bench_torch_codec(TorchCodec(k=k, device=device), raw, reps=args.reps)
            rows.append({
                "k": f"k={k}" + (" (auto)" if kspec == "auto" else ""),
                "compress_GiB_s": r["compress_bps"] / GIB,
                "decompress_GiB_s": r["decompress_bps"] / GIB,
                "ratio": r["ratio"],
                "roundtrip_ok": r["roundtrip_ok"],
                "timing": sustained_method(device),
            })
            print(n, json.dumps(rows[-1]), flush=True)
        results[str(n)] = rows

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"written": args.out}))
    return results


if __name__ == "__main__":
    main()
