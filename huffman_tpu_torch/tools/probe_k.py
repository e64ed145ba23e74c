"""Lane-count sweep of the 16 MiB biased block.

Counterpart: ``tools/probe_k.py``.  `default_lanes` gives 16 MiB
K = 131072 (S = 128 bytes a lane); this probe times the same encode and
decode bodies as `bench.harness.bench_torch_codec` at K = 65536, 131072
and 262144 (S = 256, 128, 64) in one process, so the rows compare.  It
measures only: `default_lanes` fixes K and so the blob's bytes.

    python3 -m huffman_tpu_torch.tools.probe_k [--ks 65536,131072,262144] [--size 16777216]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..bench.harness import bench_torch_codec, sustained_method
from ..bench.workloads import biased_u8
from ..constants import TPU_MAX_CODE_LEN
from ..models.torch_codec import TorchCodec

GIB = 1 << 30


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="65536,131072,262144")
    ap.add_argument("--size", type=int, default=16 << 20)
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--out", default="bench_out/probe_k.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    n = args.size
    raw = biased_u8(n).tobytes()

    rows = []
    for k in (int(x) for x in args.ks.split(",")):
        r = bench_torch_codec(TorchCodec(k=k, device=device), raw, reps=args.reps)
        s = -(-n // k)
        c, d = r["compress_bps"] / GIB, r["decompress_bps"] / GIB
        rows.append({
            "k": k, "s": s, "w32": (s * TPU_MAX_CODE_LEN + 31) // 32 + 1,
            "compress_GiB_s": c, "decompress_GiB_s": d, "combined_GiB_s": 1 / (1 / c + 1 / d),
            "ratio": r["ratio"], "roundtrip_ok": r["roundtrip_ok"], "timing": sustained_method(device),
        })
        print(json.dumps(rows[-1]), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps({"written": args.out}))
    return rows


if __name__ == "__main__":
    main()
