"""Stage split of `TorchCodec.encode_device` on the biased block.

Counterpart: ``tools/probe_encode_stages.py``.  Each stage is timed alone
by `bench.harness.sustained_seconds` (CUDA-graph replays on a card):

* ``dep``: the carried dependency alone (`bench.fused.carry` of the
  block), which every body below but ``table`` pays besides its stage;
* ``hist/1``: hist256's full count of the block;
* ``hist/S``: the table histogram at the codec's ``hist_stride`` for this
  size (the 1-in-32 row sample from 4 MiB up), as ``encode_device`` runs it;
* ``table``: `build_coding_device` from a histogram;
* ``kernel``: `encode_lanes` from a table;
* ``full``: the whole ``encode_device``.

Each stage's device time is its row less ``dep`` (``table`` carries the
dependency on 256 counts only) and less its fold: as in the JAX tool's
bodies, each folds the int32 sum of its results into the accumulator
with one `bench.fused.fold` (``kernel`` and ``full`` sum the words too,
whose u32 sum JAX adds to the int32 ones in int32; ``dep`` folds the
first carried byte).

    python3 -m huffman_tpu_torch.tools.probe_encode_stages [n_mib] [--out bench_out/probe_encode_stages.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..bench import fused
from ..bench.harness import sustained_method, sustained_seconds
from ..bench.workloads import biased_u8
from ..constants import TPU_MAX_CODE_LEN
from ..models.torch_codec import TorchCodec
from ..ops.encode import encode_lanes
from ..ops.lookup import histogram256, table_hist
from ..ops.table_build import build_coding_device

GIB = 1 << 30


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_mib", nargs="?", type=float, default=16.0)
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--out", default="bench_out/probe_encode_stages.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    n = int(args.n_mib * (1 << 20))
    codec = TorchCodec(device=device)
    k = codec._lanes(n)
    s = -(-n // k)
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    hs = codec._hist_stride(n)
    block = torch.from_numpy(biased_u8(n)).to(device)
    data = block if s * k == n else torch.nn.functional.pad(block, (0, s * k - n))
    hist0 = histogram256(data)
    enc_table = build_coding_device(hist0)["enc_table"]
    print(f"n={n} k={k} s={s} w32={w32} hist_stride={hs} ({sustained_method(device)})", flush=True)

    carry, fold = fused.carry, fused.fold

    def kernel(acc):
        words, bits = encode_lanes(carry(data, acc), enc_table, s, k, w32)
        fold(acc, words, bits)

    def full(acc):
        c = codec.encode_device(carry(block, acc))
        fold(acc, c.words, c.bit_counts, c.tables["enc_table"])

    stages = [
        ("dep", lambda acc: fold(acc, carry(data, acc)[:1])),
        ("hist/1", lambda acc: fold(acc, table_hist(carry(data, acc), 1))),
        (f"hist/{hs}", lambda acc: fold(acc, table_hist(carry(data, acc), hs))),
        ("table", lambda acc: fold(acc, build_coding_device(carry(hist0, acc))["enc_table"])),
        ("kernel", kernel),
        ("full", full),
    ]
    rows = []
    for name, body in stages:
        sec = sustained_seconds(body, reps=args.reps, tries=3, device=device)
        rows.append({"stage": name, "ms": sec * 1e3, "GiB_s": n / sec / GIB,
                     "timing": sustained_method(device)})
        print(f"{name:8s} {sec * 1e3:10.6f} ms {n / sec / GIB:10.3f} GiB/s", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"n": n, "k": k, "s": s, "w32": w32, "hist_stride": hs, "stages": rows}, f,
                  indent=1)
    print(json.dumps({"written": args.out}))
    return rows


if __name__ == "__main__":
    main()
