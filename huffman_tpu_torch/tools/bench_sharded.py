"""Weak-scaling benchmark of the sharded round trip.

Counterpart: ``tools/bench_sharded.py``.  Each rank holds the same
workload (``--per-device-mib`` blocks of 1 MiB, biased bytes, cut into
``--stream`` lane shards) and runs `parallel.sharded_roundtrip` on it;
each row gives the aggregate GiB/s, the scaling efficiency against the
one-rank row, and whether the step is right: every shard came back and,
in the world's row, `ShardedCodec` on the world's mesh gives every rank
the blob, bytes and roundtrip arrays of a one-rank codec.

    python3 -m huffman_tpu_torch.tools.bench_sharded [--per-device-mib 4] [--stream 1] [--k 8192]
    torchrun --nproc-per-node N -m huffman_tpu_torch.tools.bench_sharded [...]

Alone (world size 1) it prints the one-rank row: the step has no
collective, so `sustained_seconds` times it as one CUDA graph replayed.
Under ``torchrun`` (one card a rank, nccl; the group starts from env://) rank 0
times that row alone first, then every rank runs the world's step between
barriers, timed by CUDA events, and the row takes the slowest rank's time.
Rank 0 prints ``{"per_device_blocks", "device", "rows": [{"devices",
"roundtrip_GiB_s", "efficiency", "ok"}, ...]}``.  It needs a card a rank;
the row functions also take the CPU, where they time the plain versions
(the tests' rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..bench.harness import sustained_seconds
from ..bench.workloads import biased_u8
from ..constants import TPU_MAX_CODE_LEN
from ..parallel import distributed
from ..parallel.sharded import LocalMesh, ShardedCodec, make_mesh, mesh_shape, sharded_roundtrip

BLOCK = 1 << 20


def _step(mesh, k: int, block: int):
    """``run(shard)``: the sharded round trip of a (B, block/stream) shard."""
    s = block // k
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    return lambda shard: sharded_roundtrip(shard, mesh=mesh, k=k, s=s, w32=w32)


def one_rank_row(per_dev_blocks: int, k: int, device, block: int = BLOCK, reps: int = 8) -> dict:
    """The one-rank row: ``per_dev_blocks`` blocks through the step with
    no collective, timed by `sustained_seconds` (CUDA-graph replays on a
    card, the host clock on the CPU)."""
    run = _step(LocalMesh(), k, block)
    blocks = torch.from_numpy(biased_u8(per_dev_blocks * block, 0).reshape(-1, block)).to(device)
    ok = torch.equal(run(blocks)[0], blocks)

    def body(pert):
        return run(blocks + pert)[1].sum().to(torch.float32)

    t = sustained_seconds(body, reps=reps, device=device)
    return {"devices": 1, "roundtrip_GiB_s": per_dev_blocks * block / t / (1 << 30), "ok": ok}


def codec_matches_one_rank(mesh, n_blocks: int, k: int, device, block: int = BLOCK) -> bool:
    """Whether `ShardedCodec` on ``mesh`` gives this rank the compress
    bytes, decompressed bytes and roundtrip arrays of a one-rank codec, on
    ``n_blocks`` blocks of biased bytes that every rank passes."""
    raw_np = biased_u8(n_blocks * block, 0)
    raw = raw_np.tobytes()
    ours = ShardedCodec(mesh, block, k, device=device)
    alone = ShardedCodec(LocalMesh(), block, k, device=device)
    blob = ours.compress(raw)
    got, want = ours.roundtrip(raw_np), alone.roundtrip(raw_np)
    return (
        blob == alone.compress(raw)
        and ours.decompress(blob) == raw
        and np.array_equal(got[0], want[0])
        and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    )


def world_row(mesh, per_dev_blocks: int, k: int, device, block: int = BLOCK, reps: int = 8) -> dict:
    """The world's row: every rank runs the step on its own shard of
    ``per_dev_blocks`` blocks (``block / stream`` bytes each) between two
    barriers; the slowest rank's mean time a step (CUDA events on a card,
    the host clock on the CPU) over the world's bytes.  ``ok``: every
    shard came back and `codec_matches_one_rank` held on every rank."""
    shape = mesh_shape(mesh)
    run = _step(mesh, k, block)
    rank = dist.get_rank()
    shard = torch.from_numpy(
        biased_u8(per_dev_blocks * block // shape["stream"], 1 + rank).reshape(per_dev_blocks, -1)
    ).to(device)
    right = torch.equal(run(shard)[0], shard) and codec_matches_one_rank(
        mesh, per_dev_blocks * shape["data"], k, device, block)
    ok = torch.tensor([int(right)], device=device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    on_card = torch.device(device).type == "cuda"
    dist.barrier()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        run(shard)
    if on_card:
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        sec = time.perf_counter() - t0
    slowest = torch.tensor([sec / reps], dtype=torch.float64, device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    dist.barrier()
    total = per_dev_blocks * shape["data"] * block
    return {
        "devices": dist.get_world_size(),
        "roundtrip_GiB_s": total / float(slowest) / (1 << 30),
        "ok": bool(ok.item()),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="bench_sharded", description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-device-mib", type=float, default=4.0)
    ap.add_argument("--stream", type=int, default=1)
    ap.add_argument("--k", type=int, default=8192)
    args = ap.parse_args(argv)
    per_dev_blocks = max(1, int(args.per_device_mib))
    if not torch.cuda.is_available():
        raise SystemExit("bench_sharded: no CUDA device")
    if dist.is_torchelastic_launched():
        distributed.initialize(backend="nccl")  # env:// from torchrun's variables
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    rank = dist.get_rank() if dist.is_initialized() else 0
    rows = []
    with torch.cuda.device(device):
        if rank == 0:
            rows.append(one_rank_row(per_dev_blocks, args.k, device))
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
            rows.append(world_row(make_mesh(stream=args.stream), per_dev_blocks, args.k, device))
        name = torch.cuda.get_device_name(device)
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank != 0:
        return {}
    base = rows[0]["roundtrip_GiB_s"]
    result = {
        "per_device_blocks": per_dev_blocks,
        "device": name,
        "rows": [dict(r, efficiency=r["roundtrip_GiB_s"] / (base * r["devices"])) for r in rows],
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
