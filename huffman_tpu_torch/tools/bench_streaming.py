"""Shared-table streaming and batched-blocks rates on the biased bytes.

Counterpart: ``tools/bench_streaming.py``.

1. Shared-table stream: `TorchCodec.build_tables` once from the first
   block, then ``encode_device(..., tables=)`` and the lane decode of a
   ``--block-mib`` block (16 MiB; `bench.harness.decode_body`, over the
   words the block fills): compress, decompress and combined (encode
   then decode of its words) GiB/s, the payload ratio and the round
   trip.
2. Batched 100 KiB blocks at K = 1024: `encode_batch` and `decode_batch`
   (statics computed once, outside the timed body) for B in 1, 4, 16,
   64, 160 (1, 16, 160 with ``--fast``; ``--bs`` picks others), with the
   JAX tool's reps rule ``max(2, reps // max(1, B // 8))``.

Every body is timed by `bench.harness.sustained_seconds`: none reads back
to the host, so on a card each is one step captured in a CUDA graph and
replayed; each row names its timing.

    python3 -m huffman_tpu_torch.tools.bench_streaming [--fast] [--out bench_out/streaming.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..bench.harness import decode_body, sustained_method, sustained_seconds
from ..bench.workloads import biased_u8
from ..models.torch_codec import TorchCodec
from ..ops.decode_bits import decode_lanes

NB = 100 << 10  # a batched block
BK = 1024  # its lanes: 100 bytes a lane
GIB = 1 << 30


def shared_table_row(n: int, reps: int, device) -> dict:
    """The shared-table stream of one ``n``-byte biased block."""
    data_np = biased_u8(n)
    d = torch.from_numpy(data_np).to(device)
    codec = TorchCodec(device=device)
    tables = codec.build_tables(d)
    comp = codec.encode_device(d, tables=tables)
    ok = torch.equal(codec.decode_device(comp), d)
    s = -(-n // comp.k)
    eb, gr, sy = tables["e_bound"], tables["g_rank"], tables["sorted_syms"]

    def enc_once(pert):
        return codec.encode_device(d + pert, tables=tables).bit_counts.sum().to(torch.float32)

    def combined_once(pert):
        c = codec.encode_device(d + pert, tables=tables)
        return decode_lanes(c.words, eb, gr, sy, s).sum().to(torch.float32)

    t_c = sustained_seconds(enc_once, reps=reps, device=device)
    t_d = sustained_seconds(decode_body(comp), reps=reps, device=device)
    t_rt = sustained_seconds(combined_once, reps=reps, device=device)
    return {
        "block_bytes": n,
        "compress_GiB_s": n / t_c / GIB,
        "decompress_GiB_s": n / t_d / GIB,
        "combined_GiB_s": n / t_rt / GIB,
        "ratio": n / (int(comp.bit_counts.sum()) / 8),
        "roundtrip_ok": bool(ok),
        "timing": sustained_method(device),
    }


def batched_row(b: int, reps: int, device) -> dict:
    """``b`` biased 100 KiB blocks through the batched API."""
    codec = TorchCodec(k=BK, device=device)
    blocks = torch.from_numpy(biased_u8(b * NB, seed=b).reshape(b, NB)).to(device)
    words, bits, tables = codec.encode_batch(blocks)
    statics = codec.batch_decode_statics(words, bits, tables, NB)
    out = codec.decode_batch(words, bits, tables, NB, statics=statics)
    ok = torch.equal(out.reshape(b, NB), blocks)

    def enc_b(pert):
        _, bits_, t_ = codec.encode_batch(blocks + pert)
        return (bits_.sum() + t_["enc_table"].sum()).to(torch.float32)

    def dec_b(pert):
        o = codec.decode_batch(words + pert.to(torch.int32), bits, tables, NB, statics=statics)
        return o.sum().to(torch.float32)

    rb = max(2, reps // max(1, b // 8))
    t_cb = sustained_seconds(enc_b, reps=rb, device=device)
    t_db = sustained_seconds(dec_b, reps=rb, device=device)
    return {
        "blocks": b,
        "reps": rb,
        "compress_GiB_s": b * NB / t_cb / GIB,
        "decompress_GiB_s": b * NB / t_db / GIB,
        "roundtrip_ok": bool(ok),
        "timing": sustained_method(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default="bench_out/streaming.json")
    ap.add_argument("--block-mib", type=int, default=16)
    ap.add_argument("--bs", default=None, help="comma-separated batch sizes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    reps = 8 if args.fast else 32
    bs = args.bs or ("1,16,160" if args.fast else "1,4,16,64,160")

    results = {"streaming_shared_table": shared_table_row(args.block_mib << 20, reps, device)}
    print("streaming:", json.dumps(results["streaming_shared_table"]), flush=True)
    curve = []
    for b in (int(x) for x in bs.split(",")):
        curve.append(batched_row(b, reps, device))
        print("batched:", json.dumps(curve[-1]), flush=True)
    results["batched_100KiB_curve"] = curve

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"written": args.out}))
    return results


if __name__ == "__main__":
    main()
