"""Stage split of `TorchCodec.encode_batch` by batch size.

Counterpart: ``tools/probe_batched.py``.  B biased 100 KiB blocks at
K = 1024 (S = 100), each stage timed alone by
`bench.harness.sustained_seconds` (CUDA-graph replays on a card):

* ``dep``: the carried dependency alone (`bench.fused.carry` of the
  blocks);
* ``hist_b``: hist256_batch;
* ``table``: the batched `build_coding_device_batch` from the counts;
* ``body``: the batched `encode_lanes_batch` from the tables;
* ``full``: the whole ``encode_batch``;

each folding the int32 sum of its results into the accumulator with
one `bench.fused.fold`, as the JAX tool's bodies sum theirs (``dep``
folds the first carried byte); then, unless ``--skip-artifact``,
``full`` at B = ``--artifact-b`` (160) with reps 2 and ``--reps``,
which shows whether the JAX tool's few reps at large B (its reps rule)
move the reading.  ``--max-reps`` caps every stage's rep escalation, as
in the JAX tool.  The JAX tool's ``hist`` stage
(a vmapped single-block histogram, the A side of a TPU fix) has no
counterpart: the port has one batched histogram.

    python3 -m huffman_tpu_torch.tools.probe_batched [--bs 16,64,96,128,160,192] [--skip-artifact] [--max-reps 512] [--out bench_out/probe_batched.json]
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
from ..ops.encode import encode_lanes_batch
from ..ops.lookup import histogram256_batch
from ..ops.table_build import build_coding_device_batch
from .bench_streaming import BK, GIB, NB

S = NB // BK
W32 = (S * TPU_MAX_CODE_LEN + 31) // 32 + 1


def _blocks(b: int, device) -> torch.Tensor:
    return torch.from_numpy(biased_u8(b * NB, seed=b).reshape(b, NB)).to(device)


def _full(codec, blocks):
    def full(acc):
        _, bits, t = codec.encode_batch(fused.carry(blocks, acc))
        fused.fold(acc, bits, t["enc_table"])

    return full


def stage_row(b: int, reps: int, device, max_reps: int = 512) -> dict:
    """Each stage's sustained ms at B = ``b``, rep escalation capped at
    ``max_reps``."""
    codec = TorchCodec(k=BK, device=device)
    blocks = _blocks(b, device)
    hists = histogram256_batch(blocks)
    enc_t = build_coding_device_batch(hists)["enc_table"]
    carry, fold = fused.carry, fused.fold
    stages = {
        "dep": lambda acc: fold(acc, carry(blocks, acc).view(-1)[:1]),
        "hist_b": lambda acc: fold(acc, histogram256_batch(carry(blocks, acc))),
        "table": lambda acc: fold(acc, build_coding_device_batch(carry(hists, acc))["enc_table"]),
        "body": lambda acc: fold(acc, encode_lanes_batch(carry(blocks, acc), enc_t, S, BK, W32)[1]),
        "full": _full(codec, blocks),
    }
    row = {"blocks": b, "bytes": b * NB}
    for name, body in stages.items():
        sec = sustained_seconds(body, reps=reps, tries=3, max_reps=max_reps, device=device)
        row[f"{name}_ms"] = sec * 1e3
    row["full_GiB_s"] = b * NB / (row["full_ms"] / 1e3) / GIB
    row["sum_stages_ms"] = row["hist_b_ms"] + row["table_ms"] + row["body_ms"]
    row["timing"] = sustained_method(device)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", default="16,64,96,128,160,192")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--artifact-b", type=int, default=160)
    ap.add_argument("--out", default="bench_out/probe_batched.json")
    ap.add_argument("--skip-artifact", action="store_true",
                    help="skip the reps-sensitivity check at --artifact-b")
    ap.add_argument("--max-reps", type=int, default=512,
                    help="cap of every stage's rep escalation")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    rows = []
    for b in (int(x) for x in args.bs.split(",")):
        rows.append(stage_row(b, args.reps, device, args.max_reps))
        print(json.dumps(rows[-1]), flush=True)

    art = {}
    if not args.skip_artifact:
        b = args.artifact_b
        full = _full(TorchCodec(k=BK, device=device), _blocks(b, device))
        art = {"blocks": b, "timing": sustained_method(device)}
        for reps in (2, args.reps):
            sec = sustained_seconds(full, reps=reps, tries=3, max_reps=args.max_reps,
                                    device=device)
            art[f"reps{reps}_GiB_s"] = b * NB / sec / GIB
        print(json.dumps({"artifact_check": art}), flush=True)

    out = {"curve": rows, "artifact_check": art}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"written": args.out}))
    return out


if __name__ == "__main__":
    main()
