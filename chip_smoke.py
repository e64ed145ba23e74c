"""Build the port's CUDA kernels and drive its main path once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):

1. Device: a CUDA device must be present; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``huffman_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) and
   prints the build time and each kernel's register and shared-memory use.
3. Kernels: each of hist256, table_build, encode_lanes and decode_lanes
   on the card, at the single-block path's shapes (16 MiB biased block,
   S = 128, K = 131072), must equal its plain PyTorch version exactly;
   table_build also on the named tables of ``bench.kernel_cases``, and
   decode_lanes on the first w rows of the words (the benchmark's decode
   body; w from ``decode_statics``), which must give the bytes of all W,
   on every 15-bit window (2^15 lanes, s = 4) of five tables from 0- to
   15-bit codes and on the escape-heavy 16 MiB block
   (the Fibonacci table fed its 20 symbols uniformly), which must also
   round-trip; encode_lanes on ``kernel_cases.encode_cases``, which
   reach every path of the kernel (the lane-skewed and escape-heavy
   16 MiB blocks, K = 8 with S = 4096, K = 24, and offset views at
   K = 1001 and at 16 MiB), and hist256's sampled and full counts of those and of a
   constant and a uniform 16 MiB block.  The measurement harness's
   kernels (``bench.fused``: carry, which adds the accumulator's NaN test,
   with acc 0 and NaN; fold, which adds the float32 of the int32 sum of
   one to four tensors to the accumulator) must equal their plain
   versions exactly on the bodies' inputs (the 16 MiB block, the first w
   and all W rows of words, the bit counts, the coding table) and on
   16 MiB of 0xFF (the sum wraps to -2^24, 0xFF + 1 to 0), a 16 MiB view
   3 bytes past 16-byte alignment, 16 MiB + 13 bytes, u8 views at every
   offset 1-15 and int32 views 1-3 words past alignment, and lengths 0
   to 31; fold also on the bodies' sets of tensors, a NaN accumulator,
   totals past 2^24 (one conversion of the int32 total), four mixed
   tensors off alignment, 3 launches back to back and 64 replays of a
   captured carry and fold (the kernel must leave its scratch word 0).
4. End to end: ``TorchCodec(device="cuda")`` on the 16 MiB biased block:
   encode -> serialize -> deserialize -> decode gives the input back, the
   blob equals the CPU path's blob, the ratio is 2.1626, compress /
   decompress round-trip the six benchmark workloads, and a 4 MiB block
   at K = 8192 (S = 512) gives the CPU path's blob and round-trips.  The
   single-block kernels' launch counters, zeroed just before, must all be
   nonzero after.
4b. Batched blocks: 160 blocks of 100 KiB at K = 1024 (S = 100), as
   ``tools/bench_streaming.py`` batches them.  hist256_batch and the
   batched table_build, encode_lanes and decode_lanes must equal their
   plain versions exactly, and table_build on one launch of 2,001
   histograms (the sampled one and ``kernel_cases.table_hists``: 0 to
   256 symbols, ties, repairs, totals near 2^30), and the batched
   encode_lanes on batches of three of each of phase 3's encode inputs;
   then, with the counters zeroed just before,
   ``encode_batch`` -> ``batch_decode_statics`` -> ``decode_batch`` must
   return the 160 blocks and a small batch holding a constant block; the
   batched kernels' counters must be nonzero after.  Blocks 0, 1 and 159
   and the constant block must serialize to the CPU path's solo
   ``compress`` bytes.
5. Times: each kernel's device time per launch (torch.profiler) beside
   its wrapper call and its plain version (CUDA events around
   back-to-back calls), single-block kernels at the 16 MiB block and
   batched forms at B = 160, decode_lanes and encode_lanes on the
   escape-heavy block, and encode_lanes on a 16 MiB view 3 bytes past
   16-byte alignment beside the same bytes aligned, with the device
   operations of ``encode_device`` on that view; compress / decompress GiB/s on the 16 MiB
   block (the device path with CUDA events after warm-up and its device
   busy time, each device operation of one ``encode_device`` call by
   name, the bytes API as the median of 5 synchronised host-clock
   calls); and the batched device path at B = 1, 16 and 160 (the same,
   decode with statics precomputed).  Also hist256's full count of the
   16 MiB block, and hist256_onehot in each MMA type on it, each beside
   its plain version and ``torch.bincount`` (the library yardstick);
   hist256_batch's kernel at B = 160 x 100 KiB and at the sharded path's
   B = 64 x 1 MiB beside one ``torch.bincount`` of the bytes offset by
   256 times their row (the same (B, 256) counts; the plain version is
   that call cast to int32).
   carry and fold at 16 MiB (and at the decode body's words, the bit
   counts and table) beside their plain versions and the PyTorch ops
   they replace (the NaN test, its cast and the add; the int32 sums,
   their cast and the float add).
6. hist256_onehot (the histogram race's kernel) in each MMA type (s8,
   bf16, tf32) must equal its plain version and hist256's full count on
   five 16 MiB blocks (biased, uniform, constant, whose one bin is 2^24,
   all 0xFF, whose nibbles all take the lookups' msb-replicate path, and
   every byte value in turn, which reaches every row) and on a 256 MiB
   block, where every warp flushes its sums mid-loop; a length that is not a multiple of 2^19 must raise.
7. The measurement path at full width, with the launch counters zeroed
   just before: ``bench_torch_codec`` on the 16 MiB biased block (round
   trip, ratio len(blob) / n of phase 4; its decode body over the first
   w rows of words), ``run_suite`` of the biased and
   uniform workloads at 4 MiB over the suite's rows
   (``tools.run_benchmarks.suite_codecs``, every row must round-trip),
   and ``race(16 MiB)`` (every row OK); the counters of hist256_onehot,
   hist256, table_build, encode_lanes, decode_lanes, carry and fold
   must be nonzero after, and carry and fold must have launched in
   each of the three.  One step of the encode and of the decode body
   must launch exactly the codec's kernels, hist256's memset, one carry
   and one fold (``harness.device_ops``; printed with the busy ms a
   step), and each body's accumulator after 65 steps (64 graph replays)
   must be 65 float32 adds of what one step adds on the CPU.  It runs after phase 5's profiler windows, which leave every
   later launch costing the host more; its timings replay CUDA graphs,
   one launch per rep.
8. The ref profile (``TorchRefCodec``, the reference's K-stream format).
   First encode_lanes with per-lane row counts must equal its plain
   version on the 16 MiB block laid out at K = 65536 (S = 256) and
   K = 4096 (S = 4096, the direct kernel), with the slice sizes and with
   random counts of S or S - 1, and on ``kernel_cases.encode_cases`` with
   random counts of S or S - 1; decode_lanes on the same words with the
   12-bit table.  Then, with the launch counters zeroed just before:
   ``TorchRefCodec(k, device="cuda")`` on the 16 MiB block at K = 65536
   and 4096, on it less 1,000 bytes at K = 65536 (slices of S and S - 1)
   and on a 128 KiB block at K = 32 must write the host library's blob
   (``native.compress``, which the JAX package's tests hold equal to
   golden and ``JaxCodec``) and decode it and native's; the port's golden
   must write and read the 128 KiB blob; the six workloads at 4 MiB
   round-trip at K = 65536; the CLI's ``roundtrip`` of a 16 MiB file
   passes with each profile (ref at --k 65536); hist256, encode_lanes and
   decode_lanes must have launched.  Times at K = 65536 (and the kernels
   at K = 4096): each kernel's device time and bound, each device
   operation of one compress and one decompress (``encode_device`` /
   ``decode_device``), their GiB/s by CUDA events and the bytes API's
   (median of 5, host clock), after phase 5's profiler windows.
9. The multi-GPU path (``parallel.ShardedCodec``) at the JAX package's
   defaults, 1 MiB blocks at K = 4096 (S = 256).  First the batched
   kernels against their plain versions at its shapes: B = 64 at K =
   4096, and B = 16 at K = 2048 (a stream rank's lanes on two ranks).
   Then, with the counters zeroed just before, ``ShardedCodec(device=
   "cuda")`` at world size 1 on the 64 MiB biased block (64 blocks):
   compress -> decompress and ``roundtrip`` give the input back, and
   hist256_batch, table_build, encode_lanes and decode_lanes launched,
   hist256 did not.  The blob must equal ``container.compress_blocks`` of
   ``TorchCodec(4096, hist_stride=1)`` at 1 MiB blocks (every byte
   counted, no +1), and ``roundtrip``'s bit counts and words
   ``encode_batch``'s.  Then two gloo ranks spawned on the one card run
   meshes (1, 2) and (2, 1) on 16 MiB: each rank's blob, decompressed
   bytes and ``roundtrip`` arrays must equal the world-size-1 results.
   Times beside the card: ``tools.bench_sharded``'s one-rank row (4 MiB,
   K = 8192; carry and fold must launch in its body), the bytes
   API's GiB/s at 64 MiB (median of 3, host clock),
   one ``sharded_roundtrip`` of the 64 blocks by CUDA events, its
   device-busy share and each device operation.

10. The block pipeline (``container.PIPELINE_DEPTH`` = 2 blocks in
   flight).  With the counters zeroed just before, ``TorchCodec(device=
   "cuda")`` compresses and decompresses six 16 MiB blocks: four biased,
   a uniform one after the second (stored), and a ragged biased tail;
   hist256, table_build, encode_lanes and decode_lanes must have
   launched.  The container must equal the one written at depth 1 byte
   for byte, each H record its block's solo ``serialize(encode_device)``,
   and decompress must give the input back at both depths.  Times beside
   the card: compress and decompress at depth 1 and 2 (median of 6 calls
   in turns 1, 2, 2, 1, host clock), each device operation and the
   device-busy share of one depth-2 compress.  Then the measurement tools
   through their ``main()``, JSON to
   ``chiprun_out/``: ``bench_streaming --fast``, ``bench_small --reps 16``,
   ``probe_k``, ``probe_encode_stages`` and ``probe_batched --bs
   16,64,160``; every row that has ``roundtrip_ok`` must hold it, and
   carry and fold must launch in each tool's bodies.
11. The benchmark entry: ``python3 bench_torch.py`` (the supervisor) in a
   child process under a 300 s limit.  Its last stdout line must have a
   value, ``roundtrip_ok``, ratio 2.1626, ratio_payload 2.1916, k_lanes
   131072 and launches of hist256, table_build, encode_lanes and
   decode_lanes, carry and fold; it is printed with the card.  Then, in
   this process, each body's launches of carry and fold (one call), the
   sustained ms of the entry's encode and decode bodies each in turns
   with the same body in PyTorch's own ops (``isnan``, ``+``,
   ``.sum()``, ``add_``; marked as comparison rows), and of an all-rows
   decode body (the carried 0 added to all 61 rows, a u8 sum; a
   comparison row), and each device operation of every body's timed
   step, by name.  The entry's encode step must launch exactly hist256,
   its memset, table_build, encode_lanes, carry and fold, and its decode
   step decode_lanes, carry and fold, each once: no PyTorch op and no
   other memset.
12. The fuzz battery of ``tests/test_fuzz.py`` (``bench.kernel_cases``:
   its 36 tpu-profile cases, n < 50,000, K in {8, 16, 64, 128, 256},
   four byte styles, and its 12 hist_stride cases, strides 2, 3, 8 and
   17), with the counters zeroed just before: each case's blob from
   ``TorchCodec(k, device="cuda")`` must equal the CPU path's and decode
   on the card to the input, synchronised after each case; the encode
   kernel each shape takes (tiled or direct) is checked against the
   trace once a kernel.  Then 120 single-byte flips of the 50,000-byte
   biased block's blob at K = 256: the card gives the CPU path's bytes
   or both raise ValueError; its raw size times 4, times 64 and with
   0x40 in its high byte must raise ValueError on both with no launch.
   hist256, table_build, encode_lanes and decode_lanes must have
   launched.  Prints the cases, the K values, the encode kernels by
   shape and the phase's seconds.

The line before the last is a JSON object of the kernels (launches
counted in phases 4, 4b, 7, 8, 9, 10 and 12; ms is the kernel's device time at the
single-block shapes, hist256_batch's at B = 160, hist256_onehot's in
bf16 (the TPU's base variant) at 16 MiB, carry's and fold's on the
16 MiB u8 block with the L2 evicted; plain_ms the plain version's call; bound_ms the least
time of the same work on an H100 at its published peaks, from the bytes
moved or the tensor operations, and for table_build, which moves 2 KiB,
from its serial chain of dependent steps; library_ms ``torch.bincount``'s
call where it computes the same function (for hist256_batch of the
row-offset bytes at B = 160), and for carry ``x + pert``,
for fold ``x.sum(dtype=torch.int32)``); the last is ``{"ok": true, "device": {...}}``.  Imports
neither jax nor huffman_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

N = 16 << 20  # the headline block
K = 131072  # default_lanes(16 MiB)
RATIO = 2.1626  # whole-blob ratio of the 16 MiB biased block
RATIO_PAYLOAD = 2.1916  # its payload ratio: n / (the bit counts' sum / 8)
NB = 100 << 10  # batched block size
BK = 1024  # lanes of a batched block (S = 100)
BATCH = 160  # the batched path's full width

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "hist256": ("huffman_tpu_torch/csrc/hist256.cu", "huffman_tpu/ops/lookup.py:98"),
    "hist256_batch": (
        "huffman_tpu_torch/csrc/hist256_batch.cu",
        "huffman_tpu/ops/lookup.py:111",
    ),
    "table_build": (
        "huffman_tpu_torch/csrc/table_build.cu",
        "huffman_tpu/ops/table_build.py:190",
    ),
    "encode_lanes": (
        "huffman_tpu_torch/csrc/encode_lanes.cu",
        "huffman_tpu/ops/encode_pallas.py:140",
    ),
    "decode_lanes": (
        "huffman_tpu_torch/csrc/decode_lanes.cu",
        "huffman_tpu/ops/decode_pallas.py:118",
    ),
    "hist256_onehot": (
        "huffman_tpu_torch/csrc/hist256_onehot.cu",
        "tools/hist_experiments.py:36",
    ),
    # The measurement harness's two passes: XLA fusions in the JAX loop,
    # no Pallas kernel (bench.py:174 ``d + pert`` of the harness's
    # ``isnan(acc)``, :176 the int32 sum, converted and added to ``acc``).
    "carry": ("huffman_tpu_torch/csrc/bench_ops.cu", "bench.py:174"),
    "fold": ("huffman_tpu_torch/csrc/bench_ops.cu", "bench.py:176"),
}
# The kernels each path must launch.
SINGLE_PATH = ("hist256", "table_build", "encode_lanes", "decode_lanes")
BATCHED_PATH = ("hist256_batch", "table_build", "encode_lanes", "decode_lanes")
FUSED = ("carry", "fold")
# The device operations of one sustained step of bench_torch.py's bodies,
# each launched once: the codec's kernels (hist256's memset among them),
# one carry and one fold, as one iteration of bench.py's fori_loop.
ENCODE_STEP = ("hist256_kernel", "Memset", "table_build_kernel", "encode_lanes_kernel",
               "carry_kernel", "fold_kernel")
DECODE_STEP = ("decode_lanes_kernel", "carry_kernel", "fold_kernel")
MEASURE_PATH = ("hist256_onehot",) + SINGLE_PATH + FUSED
REF_PATH = ("hist256", "encode_lanes", "decode_lanes")
REF_KS = (65536, 4096)  # the ref profile's lanes at 16 MiB: S = 256 and 4096
# The sharded path (phase 9): ShardedCodec's defaults, at world size 1 on
# 64 blocks and on two gloo ranks sharing the card on 16.
SB, SK = 1 << 20, 4096
SN, SN_RANKS = 64 << 20, 16 << 20
SHARDED_PATH = BATCHED_PATH
RANK_SECONDS = 300  # the two ranks' limit, start-up included
# The block pipeline (phase 10): four biased 16 MiB blocks with a uniform
# one (stored) after the second, and a ragged biased tail: six blocks.
PIPE_TAIL = (12 << 20) + 12345
PIPE_KINDS = "HHSHHHC"
OUT_DIR = "chiprun_out"  # the tools' JSON
# The benchmark entry (phase 11): its supervisor's budget and the child's
# limit; a budget under BENCH_DEADLINE_S leaves no room for a retry.
BENCH_SECONDS = 300
# The fuzz battery (phase 12): mutated blobs of the 50,000-byte block, and
# encode_lanes.cu's tile (kTileLanes lanes, kTileBytes of words): lanes of
# more than kTileBytes / (4 * kTileLanes) words take the direct kernel.
FUZZ_FLIPS = 120
ENCODE_TILE_LANES, ENCODE_TILE_BYTES = 128, 64 << 10

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory
# bytes/s and tensor-core operations/s by input type.
HBM_BPS = 3.35e12
MMA_OPS = {"s8": 1979e12, "bf16": 989e12, "tf32": 495e12}
# A dependent arithmetic instruction waits 4 cycles (CUDA C++ Programming
# Guide, multiprocessor level); 1980 MHz is the H100's maximum SM clock.
DEP_CYCLES, SM_HZ = 4, 1980e6


def bound(nbytes: float, ops: float = 0.0, peak: float = 1.0) -> tuple[float, str]:
    """(least ms, what bounds it) for moving ``nbytes`` through device
    memory and doing ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls, so a call shorter than its host-side enqueue time
    measures the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def kernel_ms(fn, kernel: str, reps: int = 50, match: str | None = None) -> float:
    """Mean device milliseconds of one launch of the CUDA function
    ``<kernel>_kernel`` (or whose name holds ``match``) over ``reps``
    calls of ``fn()``, from the profiler's device trace.  (`cuda_ms` of
    back-to-back calls also counts the host's time to enqueue each call,
    which bounds a kernel of a few microseconds.)  Late in a long run the
    trace loses launches now and then (1-2 of 50, once 36), so the mean
    is over the launches it recorded, and a window that recorded fewer
    than 90 % of the calls is taken again; fails unless one of three
    windows records at most one a call and at least 90 % of the calls."""
    match = match or f"{kernel}_kernel("
    for _ in range(3):
        hits = [e for e in _profile(fn, reps) if match in e.key]
        if len(hits) == 1 and 0.9 * reps <= hits[0].count <= reps:
            return hits[0].device_time_total / hits[0].count / 1e3
    raise AssertionError(
        f"profiler saw {[(e.key, e.count) for e in hits]}, expected {reps} x {kernel}"
    )


def host_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of ``fn()`` over ``reps`` synchronised calls."""
    import statistics

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def expect_equal(name: str, a, b) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
    return err


def fused_launches(seen: dict, label: str, fn):
    """``fn()``'s result; ``seen[label]`` takes the launches of carry and
    fold during it, which must both be nonzero."""
    from huffman_tpu_torch.ops import _cuda

    before = dict(_cuda.LAUNCHES)
    result = fn()
    seen[label] = {k: _cuda.LAUNCHES[k] - before[k] for k in FUSED}
    if not all(seen[label].values()):
        raise AssertionError(f"{label}: carry and fold launched {seen[label]}")
    return result


def step_ops(label: str, body, dev, expected: tuple | None = None) -> float:
    """Prints each device operation of one step of ``body`` as
    `sustained_seconds` runs it (``harness.device_ops``: ms a launch,
    launches a step) and the busy ms a step, which it returns.  With
    ``expected``, fails unless the step's operations are exactly those,
    each once.  The trace may lose launches (as `kernel_ms` says): each
    operation's mean over the launches it recorded, times its launches a
    step (the recorded count a step, rounded up), and the share
    recorded."""
    from huffman_tpu_torch.bench.harness import device_ops, sustained_step

    _, step = sustained_step(body, dev)
    ops = [(name, math.ceil(count - 0.01), op_ms / count, count)
           for name, count, op_ms in device_ops(step)]
    for name, per_step, launch_ms, count in ops:
        print(f"{label} step device operation: {name} {launch_ms:.6f} ms a launch, "
              f"{per_step} a step (recorded {count:g} a step)")
    busy = sum(n * launch_ms for _, n, launch_ms, _ in ops)
    print(f"{label} step: device busy {busy:.6f} ms, {sum(n for _, n, _, _ in ops)} launches")
    if expected is not None:
        got = {}
        for name, per_step, _, _ in ops:
            keys = [k for k in expected if k in name]
            if len(keys) != 1:
                raise AssertionError(f"{label}: a step launched {name}, outside {expected}")
            got[keys[0]] = got.get(keys[0], 0) + per_step
        if got != dict.fromkeys(expected, 1):
            raise AssertionError(f"{label}: a step launched {got}, not each of {expected} once")
    return busy


def sharded_rank(
    rank: int, world: int, store: str, raw_path: str, out_dir: str, device: str
) -> None:
    """One of phase 9's gloo ranks, all on one ``device``: meshes (1, 2)
    and (2, 1) on the bytes of ``raw_path``; writes each mesh's results
    to ``out_dir``.  Runs in a spawned process."""
    import numpy as np
    import torch.distributed as dist

    from huffman_tpu_torch.parallel import ShardedCodec, distributed, make_mesh

    # Both ranks are on this host: gloo binds to loopback, resolving no
    # host name.
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    distributed.initialize(backend="gloo", init_method=f"file://{store}", world_size=world,
                           rank=rank)
    with open(raw_path, "rb") as f:
        raw = f.read()
    for stream in (2, 1):
        codec = ShardedCodec(make_mesh(stream=stream), block_bytes=SB, k=SK, device=device)
        blob = codec.compress(raw)
        back = codec.decompress(blob)
        out, bits, words = codec.roundtrip(np.frombuffer(raw, np.uint8))
        np.savez(os.path.join(out_dir, f"rank{rank}_stream{stream}.npz"),
                 blob=np.frombuffer(blob, np.uint8), back=np.frombuffer(back, np.uint8),
                 out=out, bits=bits.cpu().numpy(), words=words.cpu().numpy(),
                 coordinate=np.asarray(codec.mesh.get_coordinate()))
    dist.destroy_process_group()


def run_ranks(fn, args: tuple, nprocs: int, seconds: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; raises if one
    fails, or kills them all and raises after ``seconds``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise AssertionError(f"{nprocs} ranks still running after {seconds} s")


def main() -> None:
    import numpy as np
    import torch

    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from huffman_tpu_torch import TorchCodec, TorchRefCodec, cli, coding, container, golden, native
    from huffman_tpu_torch.parallel import ShardedCodec
    from huffman_tpu_torch.parallel.sharded import sharded_roundtrip
    from huffman_tpu_torch.tools import (
        bench_sharded,
        bench_small,
        bench_streaming,
        probe_batched,
        probe_encode_stages,
        probe_k,
    )
    from huffman_tpu_torch import format as ref_format
    from huffman_tpu_torch.constants import MAX_CODE_LEN
    from huffman_tpu_torch.models.torch_ref_codec import lane_layout, slice_order
    from huffman_tpu_torch.ops.tables import pack_encode_table
    from huffman_tpu_torch.bench import fused, kernel_cases, render_markdown, run_suite, workloads
    from huffman_tpu_torch.bench.harness import (
        bench_torch_codec,
        card_line,
        decode_body,
        device_busy_ms,
        device_ops,
        encode_body,
        sustained_seconds,
        sustained_step,
    )
    from huffman_tpu_torch.constants import TPU_MAX_CODE_LEN
    from huffman_tpu_torch.ops import _cuda
    from huffman_tpu_torch.ops.hist_variants import (
        CHUNK,
        MMA_TYPES,
        hist_variant,
        hist_variant_plain,
    )
    from huffman_tpu_torch.tools.hist_experiments import format_row, race
    from huffman_tpu_torch.tools.run_benchmarks import suite_codecs
    from huffman_tpu_torch.models.torch_codec import TorchCompressed, decode_statics
    from huffman_tpu_torch.ops.decode_bits import (
        decode_lanes,
        decode_lanes_batch,
        decode_lanes_batch_plain,
        decode_lanes_plain,
        decode_tables_bitserial,
    )
    from huffman_tpu_torch.ops.encode import (
        encode_lanes,
        encode_lanes_batch,
        encode_lanes_batch_plain,
        encode_lanes_plain,
    )
    from huffman_tpu_torch.ops.lookup import (
        histogram256_batch,
        histogram256_batch_plain,
        table_hist,
        table_hist_plain,
    )
    from huffman_tpu_torch.ops.table_build import (
        TABLE_LEN,
        _unpack,
        build_coding_device,
        build_coding_flat,
        build_coding_flat_batch,
        build_coding_plain,
        build_coding_plain_batch,
    )

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")

    # 2. Build.
    t0 = time.perf_counter()
    _cuda.load()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. Kernels against their plain versions, exact.
    data_np = workloads.biased_u8(N, 0)
    data = torch.from_numpy(data_np).to(dev)
    s = N // K
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    err, ms = {}, {}

    hist = table_hist(data, 32)
    err["hist256"] = max(
        expect_equal("hist256 sampled", hist, table_hist_plain(data, 32)),
        expect_equal("hist256 full", table_hist(data, 1), table_hist_plain(data, 1)),
    )
    if int(hist.sum()) != N // 32 + 256:
        raise AssertionError("sampled histogram does not count 1/32 of the block + 256")

    hists = {"sampled": hist}
    for name, h in kernel_cases.fixed_hists().items():
        hists[name] = torch.from_numpy(h.astype(np.int32))
    err["table_build"] = 0
    for name, h in hists.items():
        h = h.to(dev)
        err["table_build"] = max(
            err["table_build"],
            expect_equal(f"table_build {name}", build_coding_flat(h), build_coding_plain(h)),
        )
    if int(build_coding_device(hists["fibonacci"].to(dev))["len_count"][15]) == 0:
        raise AssertionError("the Fibonacci histogram should reach 15-bit codes")
    tables = build_coding_device(hist)
    enc = tables["enc_table"]

    words, bits = encode_lanes(data, enc, s, K, w32)
    pw, pb = encode_lanes_plain(data, enc, s, K, w32)
    err["encode_lanes"] = max(expect_equal("encode words", words, pw), expect_equal("encode bits", bits, pb))

    eb, gr, sy = tables["e_bound"], tables["g_rank"], tables["sorted_syms"]
    out = decode_lanes(words, eb, gr, sy, s)
    err["decode_lanes"] = expect_equal("decode", out, decode_lanes_plain(words, eb, gr, sy, s))
    expect_equal("decode vs input", out.reshape(-1), data)
    # The benchmark's decode body reads the first w rows of the words.
    w_scan = decode_statics({"max_bits": int(bits.max())}, s)
    out_w = decode_lanes(words[:w_scan], eb, gr, sy, s)
    err["decode_lanes"] = max(err["decode_lanes"], expect_equal(
        f"decode first {w_scan} rows", out_w, decode_lanes_plain(words[:w_scan], eb, gr, sy, s)))
    expect_equal(f"decode first {w_scan} rows vs all {w32}", out_w, out)
    # Every 15-bit window as the first of 4 symbols, random bits after it,
    # through five tables from 0- to 15-bit codes.
    xwords = torch.from_numpy(kernel_cases.window_words()).to(dev)
    xk = xwords.shape[1]
    for name, h in kernel_cases.decode_hists(hist.cpu().numpy()).items():
        t = build_coding_device(torch.from_numpy(h.astype(np.int32)).to(dev))
        xt = (t["e_bound"], t["g_rank"], t["sorted_syms"])
        err["decode_lanes"] = max(err["decode_lanes"], expect_equal(
            f"decode every window, {name} table",
            decode_lanes(xwords, *xt, 4), decode_lanes_plain(xwords, *xt, 4)))
    # The escape-heavy block: the Fibonacci table fed its 20 symbols
    # uniformly; 9 of them have codes longer than the decode's lookup.
    esc = torch.from_numpy(kernel_cases.escape_block(N)).to(dev)
    fib_hist = torch.from_numpy(kernel_cases.fibonacci_hist().astype(np.int32))
    etab = build_coding_device(fib_hist.to(dev))
    ewords, ebits = encode_lanes(esc, etab["enc_table"], s, K, w32)
    et = (etab["e_bound"], etab["g_rank"], etab["sorted_syms"])
    eout = decode_lanes(ewords, *et, s)
    err["decode_lanes"] = max(err["decode_lanes"], expect_equal(
        "decode escape-heavy", eout, decode_lanes_plain(ewords, *et, s)))
    expect_equal("escape-heavy round trip", eout.reshape(-1), esc)
    # The encode's hard inputs (kernel_cases.encode_cases, the escape-heavy
    # block among them), each through every path of the kernel, and their
    # sampled and full counts beside a constant and a uniform block.
    hard, counted = {}, {}
    for name, c in kernel_cases.encode_cases().items():
        cs, ck, off = c["s"], c["k"], c["offset"]
        cw32 = (cs * TPU_MAX_CODE_LEN + 31) // 32 + 1
        x = torch.from_numpy(c["data"]).to(dev)[off:]
        ctab = build_coding_device(torch.from_numpy(c["hist"].astype(np.int32)).to(dev))
        hard[name] = (x, ctab["enc_table"], cs, ck, cw32, off)
        got = encode_lanes(x, ctab["enc_table"], cs, ck, cw32)
        want = encode_lanes_plain(x, ctab["enc_table"], cs, ck, cw32)
        err["encode_lanes"] = max(
            err["encode_lanes"],
            expect_equal(f"encode words, {name}", got[0], want[0]),
            expect_equal(f"encode bits, {name}", got[1], want[1]),
        )
        counted[name] = x
    for name, blk in kernel_cases.hist_blocks(N).items():
        counted[name] = torch.from_numpy(blk).to(dev)
    for name, x in counted.items():
        for stride in (32, 1):
            err["hist256"] = max(err["hist256"], expect_equal(
                f"hist256 stride {stride}, {name}", table_hist(x, stride),
                table_hist_plain(x, stride)))
    if int(table_hist(counted["constant"], 1)[0xA5]) != N:
        raise AssertionError("hist256: the constant block's bin is not n")
    torch.cuda.synchronize()
    print("kernels: all four single-block kernels equal their plain versions at "
          "S=128, K=131072; decode_lanes equals its plain version on every 15-bit "
          f"window ({xk} lanes, s=4) of the sampled, Fibonacci, 1-bit, 8-bit and "
          "single-symbol tables, and round-trips the escape-heavy 16 MiB block; "
          f"encode_lanes equals its plain version on {', '.join(hard)}; hist256's "
          f"sampled and full counts equal the plain version's on those and on "
          f"{', '.join(kernel_cases.hist_blocks(0))} 16 MiB blocks", flush=True)

    # The measurement harness's carry and fold on the bodies' inputs and
    # on their hard ones: sums that wrap, totals past 2^24, a NaN
    # accumulator, every misalignment, ragged tails and short lengths;
    # then folds launched back to back and steps replayed from a CUDA
    # graph, which hold only if each fold leaves its scratch word zeroed.
    acc0 = fused.accumulator(dev)
    acc_nan = fused.accumulator(dev)
    acc_nan.fill_(math.nan)
    p0 = torch.zeros((), dtype=torch.uint8, device=dev)  # the carried 0 in PyTorch's ops
    spare = torch.from_numpy(workloads.biased_u8(N + 32, 3)).to(dev)
    ones = torch.full((N,), 0xFF, dtype=torch.uint8, device=dev)
    fused_in = {
        "16 MiB biased u8": data,
        "16 MiB of 0xFF": ones,
        "16 MiB 3 bytes past alignment": spare[3 : 3 + N],
        "16 MiB + 13 bytes": spare[: N + 13],
        f"({w_scan}, {K}) int32 words": words[:w_scan],
        f"({w32}, {K}) int32 words": words,
        f"({K},) int32 bit counts": bits,
        "(256,) int32 coding table": enc,
    }
    for off in range(1, 16):
        fused_in[f"1 MiB + 7 bytes, {off} past alignment"] = spare[off : off + (1 << 20) + 7]
    for off in range(1, 4):
        fused_in[f"{K} + 5 int32 words, {off} past alignment"] = words.view(-1)[off : off + K + 5]
    for n_short in (0, 1, 15, 16, 17, 31):
        fused_in[f"{n_short} bytes"] = spare[5 : 5 + n_short]
    past24 = (torch.tensor([1 << 24, 1], dtype=torch.int32, device=dev),
              torch.ones(1, dtype=torch.int32, device=dev))
    # (acc before, the tensors of one fold)
    fold_in = {f"fold {name}": (0.0, (x,)) for name, x in fused_in.items()}
    fold_in |= {
        "fold 16 MiB biased u8 into -2.5": (-2.5, (data,)),
        "fold into a NaN acc": (math.nan, (bits,)),
        "fold bit counts and table (the encode body's)": (0.0, (bits, enc)),
        "fold words, bit counts and table (probe_encode_stages' full)": (0.0, (words, bits, enc)),
        "fold 2^24 + 1 and 1, one total": (0.0, past24),
        "fold 1 into 2^24": (float(1 << 24), past24[1:]),
        "fold four: u8 and int32 views off alignment, 0xFF, bit counts": (
            1.5, (spare[7 : 7 + (1 << 20) + 3], words.view(-1)[1 : 1 + K + 5], ones, bits)),
    }

    def accs(value: float):
        pair = fused.accumulator(dev), fused.accumulator(dev)
        for a in pair:
            a.fill_(value)
        return pair

    def expect_same_float(name: str, got, want) -> float:
        """``got`` (the kernel's accumulator) bit for bit ``want`` (the
        plain version's), or both NaN."""
        g, w = got.view(torch.int32).item(), want.view(torch.int32).item()
        if g != w and not (math.isnan(float(got)) and math.isnan(float(want))):
            raise AssertionError(f"{name}: kernel {float(got)!r} != plain {float(want)!r}")
        return float(got)

    def expect_fold(name: str, value: float, xs, launches: int = 1) -> float:
        got, want = accs(value)
        for _ in range(launches):
            fused.fold(got, *xs)
            fused.fold_plain(want, *xs)
        return expect_same_float(name, got, want)

    def graph_steps(body, steps: int):
        """The accumulator after a warm-up step of ``body`` and ``steps``
        replays of one step captured in a CUDA graph, as
        `sustained_seconds` runs it."""
        acc, step = sustained_step(body, dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(steps):
            graph.replay()
        torch.cuda.synchronize()
        return acc

    err["carry"] = err["fold"] = 0
    for name, x in fused_in.items():
        for a in (acc0, acc_nan):
            err["carry"] = max(err["carry"], expect_equal(
                f"carry {name}, acc {float(a)}", fused.carry(x, a), fused.carry_plain(x, a)))
    folded = {name: expect_fold(name, value, xs) for name, (value, xs) in fold_in.items()}
    if (folded["fold 16 MiB of 0xFF"] != -(1 << 24) or int(fused.carry(ones, acc_nan).max()) != 0
            or folded["fold 2^24 + 1 and 1, one total"] != (1 << 24) + 2):
        raise AssertionError("16 MiB of 0xFF does not fold to -2^24, 0xFF + 1 does not carry "
                             "to 0, or 2^24 + 1 and 1 do not fold to 2^24 + 2")
    for name, x in (("16 MiB biased u8", data), ("bit counts", bits)):
        expect_fold(f"3 folds of {name} back to back", 0.5, (x,), launches=3)
    replays = {"16 MiB biased u8": (data,), "bit counts and table": (bits, enc)}
    for name, xs in replays.items():
        got = graph_steps(lambda acc, xs=xs: fused.fold(acc, fused.carry(xs[0], acc), *xs[1:]), 64)
        want = fused.accumulator(dev)
        for _ in range(65):
            fused.fold_plain(want, fused.carry_plain(xs[0], want), *xs[1:])
        expect_same_float(f"64 graph replays of carry and fold, {name}", got, want)
    torch.cuda.synchronize()
    print(f"carry (acc 0 and NaN) equals its plain version on {len(fused_in)} inputs: "
          f"{', '.join(fused_in)}; fold equals its plain version bit for bit on "
          f"{len(fold_in)} folds ({', '.join(fold_in)}), 3 launches back to back, and 64 "
          f"replays of a captured carry and fold on {' and on '.join(replays)}", flush=True)
    del ones, spare

    # 4. End to end on the card; the launch counters cover this phase only.
    codec = TorchCodec(device=dev)
    _cuda.reset_launches()
    comp = codec.encode_device(data)
    blob = codec.serialize(comp)
    back = codec.decode_device(codec.deserialize(blob))
    if not torch.equal(back, data):
        raise AssertionError("16 MiB round trip through serialize/deserialize differs")
    ratio = N / len(blob)
    round_trips = {}
    for name in workloads.WORKLOADS:
        raw = workloads.make_workload(name)
        b = codec.compress(raw)
        if codec.decompress(b) != raw:
            raise AssertionError(f"workload {name} does not round-trip")
        round_trips[name] = (len(raw), len(b))
    # Long lanes (S = 512), past the TPU encode kernel's S <= 256 limit.
    raw4 = workloads.biased_u8(4 << 20, 1).tobytes()
    b4 = TorchCodec(k=8192, device=dev).compress(raw4)
    if codec.decompress(b4) != raw4:
        raise AssertionError("k=8192 on 4 MiB does not round-trip")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in SINGLE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"single-block path never launched {missing}")
    if round(ratio, 4) != RATIO:
        raise AssertionError(f"ratio {ratio:.6f} != {RATIO}")
    cpu = TorchCodec(device="cpu")
    if cpu.serialize(cpu.encode_device(torch.from_numpy(data_np))) != blob:
        raise AssertionError("the card's 16 MiB blob differs from the CPU path's")
    if TorchCodec(k=8192, device="cpu").compress(raw4) != b4:
        raise AssertionError("the card's k=8192 4 MiB blob differs from the CPU path's")
    print(f"end to end: 16 MiB round trip ok, ratio {ratio:.6f}, blob equals the CPU path's; "
          "k=8192 4 MiB (S=512) ok")
    print(f"workloads (raw, blob bytes): {json.dumps(round_trips)}")
    print(f"launches in the end-to-end phase: {json.dumps(launches)}", flush=True)

    # 4b. Batched blocks.  First each batched kernel against its plain
    # version at the path's shapes, then the path itself, counted.
    bcodec = TorchCodec(k=BK, device=dev)
    bs = NB // BK
    bw32 = (bs * TPU_MAX_CODE_LEN + 31) // 32 + 1
    blocks_np = workloads.biased_u8(BATCH * NB, BATCH).reshape(BATCH, NB)
    blocks = torch.from_numpy(blocks_np).to(dev)
    bhist = histogram256_batch(blocks)
    err["hist256_batch"] = expect_equal(
        "hist256_batch", bhist, histogram256_batch_plain(blocks)
    )
    if bhist.sum(dim=1).tolist() != [NB] * BATCH:
        raise AssertionError("a batched histogram does not count every byte of its block")
    bflat = build_coding_flat_batch(bhist)
    err["table_build"] = max(
        err["table_build"],
        expect_equal("table_build batched", bflat, build_coding_plain_batch(bhist)),
    )
    gen = torch.from_numpy(np.concatenate([hist.cpu().numpy()[None], kernel_cases.table_hists()]))
    err["table_build"] = max(err["table_build"], expect_equal(
        f"table_build generated batch of {gen.shape[0]}",
        build_coding_flat_batch(gen.to(dev)), build_coding_plain_batch(gen).to(dev)))
    btab = _unpack(bflat, BATCH)
    benc = btab["enc_table"]
    bwords, bbits = encode_lanes_batch(blocks, benc, bs, BK, bw32)
    pw, pb = encode_lanes_batch_plain(blocks, benc, bs, BK, bw32)
    err["encode_lanes"] = max(
        err["encode_lanes"],
        expect_equal("encode words batched", bwords, pw),
        expect_equal("encode bits batched", bbits, pb),
    )
    _, bw, _ = bcodec.batch_decode_statics(bwords, bbits, btab, NB)
    beb, bgr, bsy = btab["e_bound"], btab["g_rank"], btab["sorted_syms"]
    bout = decode_lanes_batch(bwords, beb, bgr, bsy, bs, bw)
    err["decode_lanes"] = max(
        err["decode_lanes"],
        expect_equal("decode batched", bout, decode_lanes_batch_plain(bwords, beb, bgr, bsy, bs, bw)),
    )
    expect_equal("batched decode vs input", bout.reshape(BATCH, NB), blocks)
    # The encode's hard inputs as batches of three blocks (the block, its
    # reverse and its rotation by one), offset as the single block is.
    for name, (x, ctab, cs, ck, cw32, off) in hard.items():
        buf = torch.empty(3 * x.numel() + off, dtype=torch.uint8, device=dev)
        buf[off:] = torch.cat([x, x.flip(0), x.roll(1)])
        three = buf[off:].view(3, -1)
        tabs = ctab.expand(3, 256).contiguous()
        got = encode_lanes_batch(three, tabs, cs, ck, cw32)
        want = encode_lanes_batch_plain(three, tabs, cs, ck, cw32)
        err["encode_lanes"] = max(
            err["encode_lanes"],
            expect_equal(f"encode words batched, {name}", got[0], want[0]),
            expect_equal(f"encode bits batched, {name}", got[1], want[1]),
        )
    del buf, three
    torch.cuda.synchronize()
    print(f"kernels: hist256_batch and the batched table_build, encode_lanes and "
          f"decode_lanes equal their plain versions at B={BATCH}, S={bs}, K={BK}; "
          f"table_build equals its plain version on {gen.shape[0]} generated "
          "histograms in one launch; the batched encode_lanes on batches of three of "
          f"each of {', '.join(hard)}", flush=True)

    const_np = np.stack([
        np.full(NB, ord("a"), np.uint8),
        workloads.biased_u8(NB, 7),
        np.zeros(NB, np.uint8),
    ])
    const = torch.from_numpy(const_np).to(dev)
    _cuda.reset_launches()
    words_b, bits_b, tables_b = bcodec.encode_batch(blocks)
    statics = bcodec.batch_decode_statics(words_b, bits_b, tables_b, NB)
    out_b = bcodec.decode_batch(words_b, bits_b, tables_b, NB, statics=statics)
    cw, cb, ct = bcodec.encode_batch(const)
    out_c = bcodec.decode_batch(cw, cb, ct, NB)
    torch.cuda.synchronize()
    launches_b = dict(_cuda.LAUNCHES)
    if not torch.equal(out_b.reshape(BATCH, NB), blocks):
        raise AssertionError(f"the {BATCH} x 100 KiB batch does not round-trip")
    if not torch.equal(out_c.reshape(3, NB), const):
        raise AssertionError("the batch holding a constant block does not round-trip")
    missing = [k for k in BATCHED_PATH if launches_b[k] == 0]
    if missing:
        raise AssertionError(f"batched path never launched {missing}")

    def batch_block(triple, i):
        w_, b_, t_ = triple
        return TorchCompressed(words=w_[i], bit_counts=b_[i], raw_size=NB, k=BK,
                               tables={key: v[i] for key, v in t_.items()})

    blob_checks = [((words_b, bits_b, tables_b), i, blocks_np[i]) for i in (0, 1, BATCH - 1)]
    blob_checks.append(((cw, cb, ct), 0, const_np[0]))
    for triple, i, raw_np in blob_checks:
        if bcodec.serialize(batch_block(triple, i)) != cpu.compress(raw_np.tobytes()):
            raise AssertionError(f"batched block {i} serializes unlike the CPU path's compress")
    print(f"batched: B={BATCH} x 100 KiB round trip ok, statics {statics}; constant-block "
          "batch ok; blocks 0, 1, 159 and the constant block equal the CPU path's blobs")
    print(f"launches in the batched phase: {json.dumps(launches_b)}", flush=True)

    # 5. Times, after warm-up.  CUDA events around back-to-back calls and
    # the host clock come first: once the profiler has run, CUPTI stays
    # attached and every launch costs the host more.  Then each kernel's
    # device time per launch and each path's device-busy time, from the
    # profiler.
    single = {
        "hist256": (lambda: table_hist(data, 32), lambda: table_hist_plain(data, 32), 20),
        "hist256_batch": (lambda: histogram256_batch(blocks),
                          lambda: histogram256_batch_plain(blocks), 20),
        "table_build": (lambda: build_coding_flat(hist), lambda: build_coding_plain(hist), 5),
        "encode_lanes": (lambda: encode_lanes(data, enc, s, K, w32),
                         lambda: encode_lanes_plain(data, enc, s, K, w32), 5),
        "decode_lanes": (lambda: decode_lanes(words, eb, gr, sy, s),
                         lambda: decode_lanes_plain(words, eb, gr, sy, s), 5),
    }
    batched = {
        "table_build": (lambda: build_coding_flat_batch(bhist),
                        lambda: build_coding_plain_batch(bhist), 2),
        "encode_lanes": (lambda: encode_lanes_batch(blocks, benc, bs, BK, bw32),
                         lambda: encode_lanes_batch_plain(blocks, benc, bs, BK, bw32), 5),
        "decode_lanes": (lambda: decode_lanes_batch(bwords, beb, bgr, bsy, bs, bw),
                         lambda: decode_lanes_batch_plain(bwords, beb, bgr, bsy, bs, bw), 5),
    }
    call_ms = {name: cuda_ms(kern, 50) for name, (kern, _, _) in single.items()}
    plain_ms = {name: cuda_ms(plain, reps) for name, (_, plain, reps) in single.items()}
    bcall_ms = {name: cuda_ms(kern, 50) for name, (kern, _, _) in batched.items()}
    bplain_ms = {name: cuda_ms(plain, reps) for name, (_, plain, reps) in batched.items()}
    # Full counts of the 16 MiB block: hist256 and hist256_onehot by MMA
    # type, beside torch.bincount of the same bytes; hist256's sampled
    # call beside bincount of its 512 KiB sample, gathered beforehand.
    full = {"hist256": (lambda: table_hist(data, 1), lambda: table_hist_plain(data, 1), 20)}
    for mma in MMA_TYPES:
        full[mma] = (lambda mma=mma: hist_variant(data, mma),
                     lambda mma=mma: hist_variant_plain(data, mma), 5)
    fcall_ms = {name: cuda_ms(kern, 50) for name, (kern, _, _) in full.items()}
    fplain_ms = {name: cuda_ms(plain, reps) for name, (_, plain, reps) in full.items()}
    sample = data.view(-1, 512 * 32)[:, :512].contiguous().view(-1)
    library_ms = {
        "hist256": cuda_ms(lambda: torch.bincount(sample, minlength=256), 20),
        "hist256_onehot": cuda_ms(lambda: torch.bincount(data, minlength=256), 20),
    }
    # hist256_batch beside the one PyTorch call that gives the same (B, 256)
    # counts, a bincount of each byte offset by 256 times its row (the
    # plain version is that call, cast to int32), at B = 160 x 100 KiB and
    # at the sharded path's B = 64 x 1 MiB.
    raw64_np = workloads.biased_u8(SN, 0)
    k2_blocks = {"160 x 100 KiB": blocks,
                 "64 x 1 MiB": torch.from_numpy(raw64_np.reshape(-1, SB)).to(dev)}
    k2_library_ms = {}
    for key, x in k2_blocks.items():
        rows = torch.arange(x.shape[0], device=dev)[:, None] * 256
        k2_library_ms[key] = cuda_ms(lambda x=x, rows=rows: torch.bincount(
            (x.long() + rows).reshape(-1), minlength=256 * x.shape[0]), 20)
    library_ms["hist256_batch"] = k2_library_ms["160 x 100 KiB"]
    # carry and fold on the 16 MiB block beside their plain versions and
    # the one PyTorch call that computes the pass: the add of a carried 0
    # computed beforehand, the int32 sum.
    fcalls = {"carry": (lambda: fused.carry(data, acc0), lambda: fused.carry_plain(data, acc0),
                        lambda: data + p0),
              "fold": (lambda: fused.fold(acc0, data), lambda: fused.fold_plain(acc0, data),
                       lambda: data.sum(dtype=torch.int32))}
    for name, (kern, plain, lib) in fcalls.items():
        call_ms[name], plain_ms[name] = cuda_ms(kern, 50), cuda_ms(plain, 20)
        library_ms[name] = cuda_ms(lib, 20)

    comp_t = codec.deserialize(blob)
    codec.decode_device(comp_t)  # fetches and caches the block's metadata
    paths = {
        "device path": (N, lambda: codec.encode_device(data), lambda: codec.decode_device(comp_t)),
    }
    for b in (1, 16, BATCH):
        blk = torch.from_numpy(workloads.biased_u8(b * NB, b).reshape(b, NB)).to(dev)
        triple = bcodec.encode_batch(blk)
        st = bcodec.batch_decode_statics(*triple, NB)
        if not torch.equal(bcodec.decode_batch(*triple, NB, statics=st).reshape(b, NB), blk):
            raise AssertionError(f"B={b} batch does not round-trip")
        paths[f"batched device path B={b}"] = (
            b * NB,
            lambda blk=blk: bcodec.encode_batch(blk),
            lambda triple=triple, st=st: bcodec.decode_batch(*triple, NB, statics=st),
        )
    path_ms = {key: (cuda_ms(enc_fn, 20), cuda_ms(dec_fn, 20))
               for key, (_, enc_fn, dec_fn) in paths.items()}
    raw = data_np.tobytes()
    c_ms = host_ms(lambda: codec.compress(raw))
    d_ms = host_ms(lambda: codec.decompress(blob))
    ser_ms = host_ms(lambda: codec.serialize(comp))
    des_ms = host_ms(lambda: codec.deserialize(blob))

    for name, (kern, _, _) in single.items():
        ms[name] = kernel_ms(kern, name)
        print(f"time {name}: kernel {ms[name]:.6f} ms device, call {call_ms[name]:.6f} ms, "
              f"plain {plain_ms[name]:.6f} ms")
    for name, (kern, _, _) in batched.items():
        print(f"time {name} B={BATCH}: kernel {kernel_ms(kern, name):.6f} ms device, "
              f"call {bcall_ms[name]:.6f} ms, plain {bplain_ms[name]:.6f} ms")
    for key, x in k2_blocks.items():
        print(f"time hist256_batch B={key} ({card}): kernel "
              f"{kernel_ms(lambda x=x: histogram256_batch(x), 'hist256_batch'):.6f} ms device, "
              f"library call (bincount of the row-offset bytes, events) "
              f"{k2_library_ms[key]:.6f} ms")
    del k2_blocks
    print(f"time decode_lanes escape-heavy 16 MiB: kernel "
          f"{kernel_ms(lambda: decode_lanes(ewords, *et, s), 'decode_lanes'):.6f} ms device")
    eenc = etab["enc_table"]
    print(f"time encode_lanes escape-heavy 16 MiB: kernel "
          f"{kernel_ms(lambda: encode_lanes(esc, eenc, s, K, w32), 'encode_lanes'):.6f} ms device")
    # A 16 MiB block of whole rows at an address 3 bytes past 16: the
    # kernel stages it from unaligned chunks, and encode_device copies it
    # no more than an aligned block.
    ox, oenc, o_s, o_k, ow32, _ = hard["offset view, 16 MiB"]
    oal = ox.clone()
    o_ms = kernel_ms(lambda: encode_lanes(ox, oenc, o_s, o_k, ow32), "encode_lanes")
    a_ms = kernel_ms(lambda: encode_lanes(oal, oenc, o_s, o_k, ow32), "encode_lanes")
    print(f"time encode_lanes 16 MiB offset by 3 bytes: kernel {o_ms:.6f} ms device, "
          f"the same bytes aligned {a_ms:.6f} ms")
    expect_equal("encode_device offset view", codec.encode_device(ox).words,
                 codec.encode_device(oal).words)
    for name, count, op_ms in device_ops(lambda: codec.encode_device(ox)):
        print(f"encode_device 16 MiB offset view device operation: {name} x{count:g} "
              f"{op_ms:.6f} ms")
    print(f"time torch.bincount of hist256's 512 KiB sample: call {library_ms['hist256']:.6f} ms")
    full_ms = {}
    for key, (kern, _, _) in full.items():
        if key == "hist256":
            label, full_ms[key] = key, kernel_ms(kern, key)
        else:
            label = f"hist256_onehot {key}"
            full_ms[key] = kernel_ms(kern, "hist256_onehot", match="hist256_onehot_kernel<")
        print(f"time {label} full count 16 MiB: kernel {full_ms[key]:.6f} ms device, "
              f"call {fcall_ms[key]:.6f} ms, plain {fplain_ms[key]:.6f} ms, "
              f"torch.bincount call {library_ms['hist256_onehot']:.6f} ms")
    ms["hist256_onehot"] = full_ms["bf16"]
    plain_ms["hist256_onehot"] = fplain_ms["bf16"]
    # carry and fold at the bodies' shapes, each beside its bound, its
    # call's device operations and the device time of the PyTorch ops
    # that would compute it in a step: the NaN test, the cast and the add
    # for carry; the sums, their int32 add, the cast and the float add
    # for fold.
    def isnan_u8(acc):
        return torch.isnan(acc).to(torch.uint8)

    fshapes = (
        ("carry", "16 MiB u8 (the encode body's)", (data,), lambda x: x + isnan_u8(acc0)),
        ("carry", f"({w_scan}, {K}) int32 words (the decode body's)", (words[:w_scan],),
         lambda x: x + isnan_u8(acc0).to(torch.int32)),
        ("fold", "16 MiB u8 (the decode body's)", (data,),
         lambda x: acc0.add_(x.sum(dtype=torch.int32).to(torch.float32))),
        ("fold", f"({K},) int32 bit counts and (256,) table (the encode body's)", (bits, enc),
         lambda x, t: acc0.add_((x.sum(dtype=torch.int32) + t.sum(dtype=torch.int32))
                                .to(torch.float32))),
    )
    # Back to back, a 16 MiB block and its 16 MiB result stay in the 50 MB
    # L2 and the kernels beat the device-memory bound; so at 16 MiB each
    # launch also runs after a read of 128 MiB that leaves the L2 holding
    # clean lines of other data (`ms` of the kernels line: the bound counts
    # device memory).  A write would leave dirty lines, whose write-back
    # the kernel would pay.
    scrub = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)
    for name, label, xs, replaced in fshapes:
        nbytes = sum(x.numel() * x.element_size() for x in xs)
        if name == "carry":
            fn, fb = (lambda xs=xs: fused.carry(xs[0], acc0)), bound(2 * nbytes + 4)
        else:
            fn, fb = (lambda xs=xs: fused.fold(acc0, *xs)), bound(nbytes + 4)
        match = "carry_kernel<" if name == "carry" else "fold_kernel("
        k_ms = kernel_ms(fn, name, match=match)
        cold16 = xs[0] is data
        if cold16:
            ms[name] = kernel_ms(lambda fn=fn: (scrub.max(), fn()), name, match=match)
        print(f"time {name} {label}: kernel {k_ms:.6f} ms device back to back"
              + (f", {ms[name]:.6f} ms after the L2 is evicted" if cold16 else "")
              + f" (bound {fb[0]:.6f}, {fb[1]}), its call's device operations "
              f"{device_busy_ms(fn):.6f} ms; the PyTorch ops it replaces "
              f"{device_busy_ms(lambda xs=xs: replaced(*xs)):.6f} ms device"
              + (f"; call {call_ms[name]:.6f} ms, plain {plain_ms[name]:.6f} ms, library "
                 f"call {library_ms[name]:.6f} ms (events)" if cold16 else ""))
        for op, count, op_ms in device_ops(lambda xs=xs: replaced(*xs)):
            print(f"  replaced by {name}, {label}, device operation: {op} x{count:g} "
                  f"{op_ms:.6f} ms")
        if cold16:
            cold = device_ops(lambda xs=xs: (scrub.max(), replaced(*xs)))
            print("  the same after a 128 MiB read that evicts the L2 (the read listed too): "
                  + ", ".join(f"{op[:70]} {op_ms:.6f} ms" for op, _, op_ms in cold))
    del scrub
    for key, (nbytes, enc_fn, dec_fn) in paths.items():
        gib = nbytes / (1 << 30)
        e_ms, dd_ms = path_ms[key]
        print(f"{key}: encode {e_ms:.6f} ms = {gib / (e_ms / 1e3):.4f} GiB/s "
              f"(device busy {device_busy_ms(enc_fn):.6f} ms), decode {dd_ms:.6f} ms = "
              f"{gib / (dd_ms / 1e3):.4f} GiB/s (device busy {device_busy_ms(dec_fn):.6f} ms)")
    for name, count, op_ms in device_ops(lambda: codec.encode_device(data)):
        print(f"encode_device 16 MiB device operation: {name} x{count:g} {op_ms:.6f} ms")
    gib = N / (1 << 30)
    print(f"bytes API (median of 5, host clock): compress {c_ms:.3f} ms = "
          f"{gib / (c_ms / 1e3):.4f} GiB/s, decompress {d_ms:.3f} ms = "
          f"{gib / (d_ms / 1e3):.4f} GiB/s; serialize {ser_ms:.3f} ms, "
          f"deserialize {des_ms:.3f} ms", flush=True)

    # 6. hist256_onehot in each MMA type against its plain version and
    # hist256's full count.
    before = _cuda.LAUNCHES["hist256_onehot"]
    uniform_np = np.random.default_rng(6).integers(0, 256, N, dtype=np.uint8)
    blocks6 = {
        "biased": data,
        "uniform": torch.from_numpy(uniform_np).to(dev),
        "constant": torch.full((N,), 0xA5, dtype=torch.uint8, device=dev),
        "all 0xFF": torch.full((N,), 0xFF, dtype=torch.uint8, device=dev),
        "every byte value in turn": torch.arange(N, device=dev).to(torch.uint8),
        "biased x16 (256 MiB)": data.repeat(16),
    }
    err["hist256_onehot"] = 0
    for bname, blk in blocks6.items():
        counts = table_hist(blk, 1)
        for mma in MMA_TYPES:
            got = hist_variant(blk, mma)
            err["hist256_onehot"] = max(
                err["hist256_onehot"],
                expect_equal(f"hist256_onehot {mma} {bname}", got, hist_variant_plain(blk, mma)),
            )
            if not torch.equal(got, counts):
                raise AssertionError(f"hist256_onehot {mma} {bname} differs from hist256's count")
    if int(table_hist(blocks6["constant"], 1)[0xA5]) != 1 << 24:
        raise AssertionError("the constant block's bin is not 2^24")
    if not torch.equal(table_hist(blocks6["every byte value in turn"], 1),
                       torch.full((256,), N // 256, dtype=torch.int32, device=dev)):
        raise AssertionError("the block of every byte value in turn is not N / 256 a bin")
    # The C entry takes any multiple of 64; lengths off the 512-byte
    # iteration take the kernel's tail steps.
    tail_out = torch.empty(256, dtype=torch.int32, device=dev)
    for n_tail in (64, 448, CHUNK + 192):
        want_tail = torch.bincount(data[:n_tail], minlength=256).to(torch.int32)
        for mma in MMA_TYPES:
            _cuda.launch("hist256_onehot", data.data_ptr(), n_tail, MMA_TYPES.index(mma),
                         tail_out.data_ptr(), _cuda.stream(data))
            if not torch.equal(tail_out, want_tail):
                raise AssertionError(f"hist256_onehot {mma} of {n_tail} bytes differs from bincount")
    try:
        hist_variant(data[: N - 64], "s8")
    except ValueError:
        pass
    else:
        raise AssertionError(f"a length that is not a multiple of {CHUNK} did not raise")
    torch.cuda.synchronize()
    if _cuda.LAUNCHES["hist256_onehot"] == before:
        raise AssertionError("phase 6 never launched hist256_onehot")
    del blocks6
    print(f"hist256_onehot: s8, bf16 and tf32 equal their plain versions and hist256's "
          f"full count on the biased, uniform, constant (bin 2^24), all-0xFF and "
          f"every-byte-value 16 MiB blocks and a 256 MiB block; the C entry equals bincount "
          f"at 64, 448 and {CHUNK + 192} bytes; a length off the {CHUNK}-byte grid raises",
          flush=True)

    # 7. The measurement path at full width; the counters cover this
    # phase only.
    _cuda.reset_launches()
    t7 = time.perf_counter()
    seen7 = {}
    row = fused_launches(seen7, "bench_torch_codec",
                         lambda: bench_torch_codec(TorchCodec(device=dev), data_np.tobytes()))
    if not row["roundtrip_ok"]:
        raise AssertionError("bench_torch_codec: the 16 MiB block does not round-trip")
    if row["ratio"] != len(blob) / N:
        raise AssertionError(f"bench_torch_codec ratio {row['ratio']} != {len(blob) / N}")
    gib = N / (1 << 30)
    e_ms, dd_ms = path_ms["device path"]
    print(f"bench_torch_codec 16 MiB: ratio {row['ratio']:.6f} (n / blob {1 / row['ratio']:.4f}), "
          f"round trip ok; sustained compress {row['compress_bps'] / (1 << 30):.4f} GiB/s, "
          f"decompress {row['decompress_bps'] / (1 << 30):.4f} GiB/s (CUDA-graph replays; "
          f"the decode body over the first {w_scan} of {w32} rows of words); "
          f"phase 5's device path by events: encode {gib / (e_ms / 1e3):.4f}, "
          f"decode {gib / (dd_ms / 1e3):.4f} GiB/s", flush=True)
    # One step of each of the bodies bench_torch_codec and bench_torch.py
    # time: exactly the codec's kernels, hist256's memset, one carry and
    # one fold.  The accumulator after 65 steps (one eager, 64 graph
    # replays) must be 65 float32 adds of what one step of the same body
    # adds on the CPU.
    codec7, cpu7 = TorchCodec(device=dev), TorchCodec(device="cpu")
    data7 = torch.from_numpy(data_np)
    bodies7 = {
        "encode": (encode_body(codec7, data), encode_body(cpu7, data7), ENCODE_STEP),
        "decode": (decode_body(codec7.encode_device(data)),
                   decode_body(cpu7.encode_device(data7)), DECODE_STEP),
    }
    for key, (body, cpu_body, expected) in bodies7.items():
        step_ops(f"bench_torch.py {key} body ({card})", body, dev, expected)
        cpu_acc, cpu_step = sustained_step(cpu_body, "cpu")
        cpu_step()
        want = np.float32(0)
        for _ in range(65):
            want = np.float32(want + np.float32(cpu_acc))
        got = np.float32(graph_steps(body, 64).cpu())
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"{key} body: accumulator {got!r} after 65 steps on the card, "
                                 f"{want!r} from the CPU's step")
        print(f"{key} body: accumulator after 65 steps on the card {float(got)!r} = 65 adds of "
              f"the CPU step's {float(cpu_acc)!r}", flush=True)
    suite = fused_launches(seen7, "run_suite",
                           lambda: run_suite(["biased", "uniform"], suite_codecs(dev), 4 << 20,
                                             reps=8))
    print(render_markdown(suite), flush=True)
    bad = [(w, r["method"], r["streams"]) for w, blk in suite.items() for r in blk["rows"]
           if not r["roundtrip_ok"]]
    if bad:
        raise AssertionError(f"suite rows that do not round-trip: {bad}")
    rows = fused_launches(seen7, "race", lambda: race(N))
    for r in rows:
        print(f"race: {format_row(r)}")
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"race rows that differ from histogram256: {bad}")
    torch.cuda.synchronize()
    launches_m = dict(_cuda.LAUNCHES)
    missing = [k for k in MEASURE_PATH if launches_m[k] == 0]
    if missing:
        raise AssertionError(f"measurement path never launched {missing}")
    print(f"launches in the measurement phase: {json.dumps(launches_m)} "
          f"({time.perf_counter() - t7:.1f} s); of carry and fold by call: "
          f"{json.dumps(seen7)}", flush=True)

    # 8. The ref profile.  Kernels against their plain versions first, at
    # the path's shapes and with ragged row counts.
    t8 = time.perf_counter()
    ref_cc = coding.make_canonical_coding(table_hist(data, 1).cpu().numpy())
    ref_enc = torch.from_numpy(pack_encode_table(ref_cc).astype(np.int32)).to(dev)
    rt = decode_tables_bitserial(ref_cc.len_count, ref_cc.sorted_syms)
    ref_tabs = tuple(torch.from_numpy(rt[key].astype(np.int32)).to(dev)
                     for key in ("e_bound", "g_rank", "syms"))
    rng8 = np.random.default_rng(8)
    ref_in = {}  # k -> (lanes, slice sizes, s, w32, words, bit counts)
    for rk in REF_KS:
        lanes, sizes = lane_layout(data, rk)
        rs = lanes.shape[0]
        rw32 = (rs * MAX_CODE_LEN + 31) // 32 + 2  # as TorchRefCodec
        ragged = torch.from_numpy((rs - rng8.integers(0, 2, rk)).astype(np.int32)).to(dev)
        for label, rows in (("slice sizes", sizes), ("S or S - 1 rows", ragged)):
            got = encode_lanes(lanes.view(-1), ref_enc, rs, rk, rw32, lane_rows=rows)
            want = encode_lanes_plain(lanes.view(-1), ref_enc, rs, rk, rw32, lane_rows=rows)
            err["encode_lanes"] = max(
                err["encode_lanes"],
                expect_equal(f"encode words K={rk}, {label}", got[0], want[0]),
                expect_equal(f"encode bits K={rk}, {label}", got[1], want[1]),
            )
            if label == "slice sizes":
                ref_in[rk] = (lanes, sizes, rs, rw32, *got)
        rout = decode_lanes(ref_in[rk][4], *ref_tabs, rs)
        err["decode_lanes"] = max(err["decode_lanes"], expect_equal(
            f"decode K={rk}, 12-bit table", rout, decode_lanes_plain(ref_in[rk][4], *ref_tabs, rs)))
        expect_equal(f"ref decode K={rk} vs input", slice_order(rout, N), data)
    for name, (x, ctab, cs, ck, cw32, _) in hard.items():
        rows = torch.from_numpy((cs - rng8.integers(0, 2, ck)).astype(np.int32)).to(dev)
        got = encode_lanes(x, ctab, cs, ck, cw32, lane_rows=rows)
        want = encode_lanes_plain(x, ctab, cs, ck, cw32, lane_rows=rows)
        err["encode_lanes"] = max(
            err["encode_lanes"],
            expect_equal(f"encode words with row counts, {name}", got[0], want[0]),
            expect_equal(f"encode bits with row counts, {name}", got[1], want[1]),
        )
    torch.cuda.synchronize()
    print(f"kernels: encode_lanes with row counts equals its plain version at K={REF_KS} "
          f"on the 16 MiB block (slice sizes; S or S - 1 rows) and on {', '.join(hard)} "
          "(S or S - 1 rows); decode_lanes with the 12-bit table equals its plain version "
          "and gives the block back", flush=True)

    # The path, counted: the codec at each shape, golden, the workloads, the CLI.
    raw16 = data_np.tobytes()
    raw128 = workloads.biased_u8(128 << 10, 8).tobytes()
    ref_runs = {
        "16 MiB, K=65536": (raw16, 65536),
        "16 MiB, K=4096": (raw16, 4096),
        "16 MiB less 1000 bytes, K=65536": (raw16[: N - 1000], 65536),
        "128 KiB, K=32": (raw128, 32),
    }
    _cuda.reset_launches()
    ref_blobs = {}
    for label, (raw_r, rk) in ref_runs.items():
        rc = TorchRefCodec(rk, device=dev)
        blob_r, nblob = rc.compress(raw_r), native.compress(raw_r, rk)
        if blob_r != nblob:
            raise AssertionError(f"ref {label}: the blob differs from native.compress's")
        if rc.decompress(blob_r) != raw_r or rc.decompress(nblob) != raw_r:
            raise AssertionError(f"ref {label}: a blob does not decode back")
        ref_blobs[label] = blob_r
    gblob = ref_blobs["128 KiB, K=32"]
    if golden.compress(raw128, 32) != gblob or golden.decompress(gblob, 32) != raw128:
        raise AssertionError("golden: the 128 KiB blob differs or does not decode")
    ref_trips = {}
    for name in workloads.WORKLOADS:
        raw_w = workloads.make_workload(name, 4 << 20)
        rc = TorchRefCodec(65536, device=dev)
        blob_w = rc.compress(raw_w)
        if rc.decompress(blob_w) != raw_w:
            raise AssertionError(f"ref workload {name} does not round-trip")
        ref_trips[name] = (len(raw_w), len(blob_w))
    cli_lines = []
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "in.bin")
        with open(path, "wb") as f:
            f.write(raw16)
        for profile, extra in (("tpu", []), ("ref", ["--k", "65536"]), ("native", [])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["roundtrip", path, "--profile", profile, *extra])
            if "roundtrip OK" not in out.getvalue():
                raise AssertionError(f"CLI roundtrip --profile {profile}: {out.getvalue()}")
            cli_lines.append(f"{profile}: {out.getvalue().strip()}")
    torch.cuda.synchronize()
    launches_r = dict(_cuda.LAUNCHES)
    missing = [k for k in REF_PATH if launches_r[k] == 0]
    if missing:
        raise AssertionError(f"ref path never launched {missing}")
    print("ref: " + "; ".join(f"{label} blob {len(b)} bytes = native's, decodes"
                              for label, b in ref_blobs.items()))
    print("ref: golden writes and reads the 128 KiB blob; workloads at 4 MiB, K=65536 "
          f"(raw, blob bytes): {json.dumps(ref_trips)}")
    for line in cli_lines:
        print(f"ref: CLI {line}")
    print(f"launches in the ref phase: {json.dumps(launches_r)} "
          f"({time.perf_counter() - t8:.1f} s with the kernel checks)", flush=True)

    # Times at K = 65536: events and the host clock, then the profiler.
    rc = TorchRefCodec(65536, device=dev)
    blob65 = ref_blobs["16 MiB, K=65536"]
    h65 = ref_format.parse_header(blob65, 65536)
    payload65 = torch.from_numpy(np.frombuffer(h65.payload, np.uint8).copy()).to(dev)
    gib = N / (1 << 30)
    re_ms = cuda_ms(lambda: rc.encode_device(data), 20)
    rd_ms = cuda_ms(lambda: rc.decode_device(h65, payload65), 20)
    rc_ms = host_ms(lambda: rc.compress(raw16))
    rdd_ms = host_ms(lambda: rc.decompress(blob65))
    for rk in REF_KS:
        lanes, sizes, rs, rw32, rwords, rbits = ref_in[rk]
        flat = lanes.view(-1)
        e_ms = kernel_ms(lambda: encode_lanes(flat, ref_enc, rs, rk, rw32, lane_rows=sizes),
                         "encode_lanes", match="encode_lanes_rows_kernel(" if rk == 65536
                         else "encode_lanes_direct_kernel(")
        d_ms = kernel_ms(lambda: decode_lanes(rwords, *ref_tabs, rs), "decode_lanes")
        # Bytes, table and row counts in; words and bit counts out.
        e_bound = bound(N + 256 * 4 + rk * 4 + rw32 * rk * 4 + rk * 4)
        d_bound = bound(int(rbits.sum()) / 8 + (2 * TPU_MAX_CODE_LEN + 3 + 256) * 4 + N)
        print(f"time ref K={rk} (S={rs}): encode_lanes {e_ms:.6f} ms device "
              f"(bound {e_bound[0]:.6f}, {e_bound[1]}), decode_lanes {d_ms:.6f} ms device "
              f"(bound {d_bound[0]:.6f}, {d_bound[1]})")
    print(f"time ref hist256 full count 16 MiB: kernel "
          f"{kernel_ms(lambda: table_hist(data, 1), 'hist256'):.6f} ms device")
    for what, fn in (("compress", lambda: rc.encode_device(data)),
                     ("decompress", lambda: rc.decode_device(h65, payload65))):
        for name, count, op_ms in device_ops(fn):
            print(f"ref {what} 16 MiB K=65536 device operation: {name} x{count:g} {op_ms:.6f} ms")
    print(f"ref device path 16 MiB K=65536 (events): encode_device {re_ms:.6f} ms = "
          f"{gib / (re_ms / 1e3):.4f} GiB/s, decode_device {rd_ms:.6f} ms = "
          f"{gib / (rd_ms / 1e3):.4f} GiB/s")
    print(f"ref bytes API 16 MiB K=65536 (median of 5, host clock): compress {rc_ms:.3f} ms = "
          f"{gib / (rc_ms / 1e3):.4f} GiB/s, decompress {rdd_ms:.3f} ms = "
          f"{gib / (rdd_ms / 1e3):.4f} GiB/s", flush=True)

    # 9. The multi-GPU path.  The batched kernels against their plain
    # versions at its shapes first: B = 64 at K = 4096 (world size 1) and
    # B = 16 at K = 2048 (a stream rank's lanes on two ranks), S = 256.
    t9 = time.perf_counter()
    s9 = SB // SK
    w9 = (s9 * TPU_MAX_CODE_LEN + 31) // 32 + 1
    for nb9, k9 in ((SN // SB, SK), (SN_RANKS // SB, SK // 2)):
        x9 = torch.from_numpy(raw64_np[: nb9 * s9 * k9].reshape(nb9, -1)).to(dev)
        h9 = histogram256_batch(x9)
        err["hist256_batch"] = max(err["hist256_batch"], expect_equal(
            f"hist256_batch B={nb9}, {s9 * k9} bytes", h9, histogram256_batch_plain(x9)))
        f9 = build_coding_flat_batch(h9)
        err["table_build"] = max(err["table_build"], expect_equal(
            f"table_build B={nb9}", f9, build_coding_plain_batch(h9)))
        t9s = _unpack(f9, nb9)
        gw, gb = encode_lanes_batch(x9, t9s["enc_table"], s9, k9, w9)
        pw, pb = encode_lanes_batch_plain(x9, t9s["enc_table"], s9, k9, w9)
        err["encode_lanes"] = max(
            err["encode_lanes"],
            expect_equal(f"encode words B={nb9}, S={s9}, K={k9}", gw, pw),
            expect_equal(f"encode bits B={nb9}, S={s9}, K={k9}", gb, pb),
        )
        dt9 = (t9s["e_bound"], t9s["g_rank"], t9s["sorted_syms"])
        got9 = decode_lanes_batch(gw, *dt9, s9, w9)
        err["decode_lanes"] = max(err["decode_lanes"], expect_equal(
            f"decode B={nb9}, S={s9}, K={k9}", got9, decode_lanes_batch_plain(gw, *dt9, s9, w9)))
        expect_equal(f"batched decode B={nb9}, K={k9} vs input", got9.reshape(nb9, -1), x9)
    del x9, gw, pw, got9
    torch.cuda.synchronize()
    print(f"kernels: hist256_batch and the batched table_build, encode_lanes and decode_lanes "
          f"equal their plain versions at B={SN // SB}, S={s9}, K={SK} and B={SN_RANKS // SB}, "
          f"S={s9}, K={SK // 2}", flush=True)

    # The path at world size 1, counted; then its oracles.
    raw64 = raw64_np.tobytes()
    sc = ShardedCodec(block_bytes=SB, k=SK, device=dev)
    _cuda.reset_launches()
    blob64 = sc.compress(raw64)
    back64 = sc.decompress(blob64)
    out64, bits64, words64 = sc.roundtrip(raw64_np)
    torch.cuda.synchronize()
    launches_s = dict(_cuda.LAUNCHES)
    missing = [k for k in SHARDED_PATH if launches_s[k] == 0]
    if missing:
        raise AssertionError(f"sharded path never launched {missing}")
    if launches_s["hist256"]:
        raise AssertionError("the sharded path launched hist256 (a sampled single-block count)")
    if back64 != raw64 or not np.array_equal(out64, raw64_np):
        raise AssertionError("the 64 MiB sharded round trip differs from the input")
    oracle = TorchCodec(SK, hist_stride=1, device=dev)
    if container.compress_blocks(raw64, oracle, SB) != blob64:
        raise AssertionError("the sharded blob differs from TorchCodec(hist_stride=1)'s container")
    ow, ob, _ = oracle.encode_batch(torch.from_numpy(raw64_np.reshape(-1, SB)).to(dev))
    if not (torch.equal(words64, ow) and torch.equal(bits64, ob)):
        raise AssertionError("roundtrip's words or bit counts differ from encode_batch's")
    print(f"sharded: 64 MiB ({SN // SB} blocks of 1 MiB, K={SK}) round trip ok, blob "
          f"{len(blob64)} bytes equals TorchCodec(hist_stride=1)'s container, roundtrip's "
          "arrays equal encode_batch's", flush=True)
    print(f"launches in the sharded phase: {json.dumps(launches_s)}", flush=True)

    # Two gloo ranks on the one card, each mesh against world size 1.
    raw16s = raw64[:SN_RANKS]
    want16 = (sc.compress(raw16s), *sc.roundtrip(raw64_np[:SN_RANKS]))
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        raw_path = os.path.join(td, "raw.bin")
        with open(raw_path, "wb") as f:
            f.write(raw16s)
        run_ranks(sharded_rank, (2, os.path.join(td, "store"), raw_path, td, "cuda:0"), 2,
                  RANK_SECONDS)
        for stream, coords in ((2, [[0, 0], [0, 1]]), (1, [[0, 0], [1, 0]])):
            for rank in range(2):
                got = np.load(os.path.join(td, f"rank{rank}_stream{stream}.npz"))
                mesh_name = f"mesh ({2 // stream}, {stream}) rank {rank}"
                if got["coordinate"].tolist() != coords[rank]:
                    raise AssertionError(f"{mesh_name}: coordinate {got['coordinate']}")
                if got["blob"].tobytes() != want16[0] or got["back"].tobytes() != raw16s:
                    raise AssertionError(f"{mesh_name}: blob or decompressed bytes differ")
                if not (np.array_equal(got["out"], want16[1])
                        and np.array_equal(got["bits"], want16[2].cpu().numpy())
                        and np.array_equal(got["words"], want16[3].cpu().numpy())):
                    raise AssertionError(f"{mesh_name}: roundtrip arrays differ")
    print(f"sharded: two gloo ranks on the card, meshes (1, 2) and (2, 1) on 16 MiB: every "
          f"rank's blob, bytes and roundtrip arrays equal world size 1's "
          f"({time.perf_counter() - t_ranks:.1f} s with start-up)", flush=True)

    # Times beside the card.  Events and the host clock before the profiler.
    seen9 = {}
    row = fused_launches(seen9, "one_rank_row", lambda: bench_sharded.one_rank_row(4, 8192, dev))
    print(f"bench_sharded one-rank row (4 x 1 MiB, K=8192; {card}): {json.dumps(row)}; "
          f"launches of carry and fold {json.dumps(seen9['one_rank_row'])}")
    gib64 = SN / (1 << 30)
    sc_ms = host_ms(lambda: sc.compress(raw64), reps=3)
    sd_ms = host_ms(lambda: sc.decompress(blob64), reps=3)
    local64 = sc._local_blocks(np.ascontiguousarray(raw64_np))

    def step():
        return sharded_roundtrip(local64, mesh=sc.mesh, k=SK, s=s9, w32=sc.w32)

    step_ms = cuda_ms(step, 20)
    # Each operation runs once a step, and late in the run the trace may
    # lose launches (as `kernel_ms` says): its mean over the launches it
    # recorded, and the share of the steps recorded.
    ops9 = [(name, count, op_ms / count) for name, count, op_ms in device_ops(step)]
    step_busy = sum(launch_ms for _, _, launch_ms in ops9)
    print(f"sharded bytes API 64 MiB (median of 3, host clock; {card}): compress {sc_ms:.3f} ms "
          f"= {gib64 / (sc_ms / 1e3):.4f} GiB/s, decompress {sd_ms:.3f} ms = "
          f"{gib64 / (sd_ms / 1e3):.4f} GiB/s")
    # Each batched kernel's bound at the step's shapes, as for `ms` below:
    # inputs read once, outputs written once, the decode's payload bits.
    nb64 = SN // SB
    tabs9 = (2 * TPU_MAX_CODE_LEN + 3 + 256) * 4
    step_bounds = {
        "hist256_batch_kernel": bound(SN + nb64 * 256 * 4),
        "encode_lanes_kernel": bound(SN + nb64 * 256 * 4 + words64.numel() * 4 + bits64.numel() * 4),
        "decode_lanes_kernel": bound(int(bits64.sum()) / 8 + nb64 * tabs9 + SN),
    }
    for name, count, launch_ms in ops9:
        b9 = next((v for key, v in step_bounds.items() if key + "(" in name), None)
        print(f"sharded_roundtrip 64 x 1 MiB device operation: {name} {launch_ms:.6f} ms a "
              f"launch (recorded in {count:g} of the steps)"
              + (f" (bound {b9[0]:.6f}, {b9[1]})" if b9 else ""))
    print(f"sharded_roundtrip 64 x 1 MiB ({card}): {step_ms:.6f} ms by events = "
          f"{gib64 / (step_ms / 1e3):.4f} GiB/s, device busy {step_busy:.6f} ms = "
          f"{step_busy / step_ms:.4f} of the call ({time.perf_counter() - t9:.1f} s for "
          "phase 9)", flush=True)

    # 10. The block pipeline: TorchCodec's bytes API on an input of six
    # blocks, two in flight (container.PIPELINE_DEPTH), counted; against
    # one in flight and each block alone.
    t10 = time.perf_counter()
    biased10 = workloads.biased_u8(4 * N + PIPE_TAIL, 10)
    uniform10 = np.random.default_rng(10).integers(0, 256, N, dtype=np.uint8)
    raw10 = np.concatenate([biased10[: 2 * N], uniform10, biased10[2 * N :]]).tobytes()
    pcodec = TorchCodec(device=dev)
    _cuda.reset_launches()
    blob10 = pcodec.compress(raw10)
    back10 = pcodec.decompress(blob10)
    torch.cuda.synchronize()
    launches_c = dict(_cuda.LAUNCHES)
    missing = [k for k in SINGLE_PATH if launches_c[k] == 0]
    if missing:
        raise AssertionError(f"the block pipeline never launched {missing}")
    if back10 != raw10:
        raise AssertionError("the six-block container does not decompress to its input")
    depth = container.PIPELINE_DEPTH
    container.PIPELINE_DEPTH = 1
    blob10_1 = pcodec.compress(raw10)
    back10_1 = pcodec.decompress(blob10)
    container.PIPELINE_DEPTH = depth
    if blob10_1 != blob10:
        raise AssertionError("the container at depth 2 differs from the one at depth 1")
    if back10_1 != raw10:
        raise AssertionError("decompress at depth 1 does not give the input back")
    _, _, recs10 = container.parse_records(blob10)
    kinds10 = "".join(chr(kind) for kind, *_ in recs10)
    if kinds10 != PIPE_KINDS:
        raise AssertionError(f"record kinds {kinds10}, expected {PIPE_KINDS}")
    for i, (kind, _, _, rec) in enumerate(recs10):
        if kind == container.KIND_HUFF:
            chunk = raw10[i * N : (i + 1) * N].ljust(N, b"\0")  # the tail's pad
            solo = pcodec.serialize(pcodec.encode_device(
                torch.frombuffer(bytearray(chunk), dtype=torch.uint8).to(dev)))
            if solo != rec:
                raise AssertionError(f"record {i} differs from its block's solo blob")
    n10 = len(raw10)
    print(f"pipeline: {n10} bytes in six 16 MiB blocks (records {kinds10}), container "
          f"{len(blob10)} bytes equal at depth 2 and 1, every H record equals its block's "
          "solo serialize(encode_device), decompress gives the input back at both depths",
          flush=True)
    print(f"launches in the pipeline phase: {json.dumps(launches_c)}", flush=True)
    # Times after phases 5, 8 and 9's profiler windows: this phase comes
    # last so that phases 1-9 keep their order, and the profiler's cost a
    # launch (microseconds) is lost in a call that holds the host for tens
    # of milliseconds a block.  The depths take turns (1, 2, 2, 1, three
    # calls a turn): the host's times drift more than the gap between them.
    gib10 = n10 / (1 << 30)
    turns = {1: ([], []), 2: ([], [])}
    for d in (1, 2, 2, 1):
        container.PIPELINE_DEPTH = d
        for _ in range(3):
            turns[d][0].append(host_ms(lambda: pcodec.compress(raw10), reps=1))
            turns[d][1].append(host_ms(lambda: pcodec.decompress(blob10), reps=1))
    container.PIPELINE_DEPTH = depth
    depth_ms = {d: tuple(statistics.median(t) for t in ts) for d, ts in turns.items()}
    for d, (c_ms10, d_ms10) in depth_ms.items():
        print(f"pipeline depth {d} (median of 6 in turns 1, 2, 2, 1, host clock; {card}): "
              f"compress {c_ms10:.3f} ms = {gib10 / (c_ms10 / 1e3):.4f} GiB/s, decompress "
              f"{d_ms10:.3f} ms = {gib10 / (d_ms10 / 1e3):.4f} GiB/s; compress calls "
              f"{json.dumps([round(t, 3) for t in turns[d][0]])}, decompress calls "
              f"{json.dumps([round(t, 3) for t in turns[d][1]])}")
    ops10 = device_ops(lambda: pcodec.compress(raw10), reps=3)
    busy10 = sum(op_ms for _, _, op_ms in ops10)
    for name, count, op_ms in ops10:
        print(f"pipeline compress depth 2 device operation: {name} x{count:g} {op_ms:.6f} ms")
    print(f"pipeline compress depth 2 ({card}): device busy {busy10:.6f} ms = "
          f"{busy10 / depth_ms[2][0]:.4f} of the call; depth 2 / depth 1: compress "
          f"{depth_ms[2][0] / depth_ms[1][0]:.4f}, decompress "
          f"{depth_ms[2][1] / depth_ms[1][1]:.4f}", flush=True)

    # The measurement tools, each through its main(), JSON to OUT_DIR.
    tool_out = lambda name: ["--out", os.path.join(OUT_DIR, f"{name}.json")]  # noqa: E731
    quiet, seen10 = io.StringIO(), {}
    with contextlib.redirect_stdout(quiet):
        streaming = fused_launches(seen10, "bench_streaming", lambda: bench_streaming.main(
            ["--fast", *tool_out("streaming")]))
        small = fused_launches(seen10, "bench_small", lambda: bench_small.main(
            ["--reps", "16", *tool_out("results_small")]))
        ks = fused_launches(seen10, "probe_k", lambda: probe_k.main(tool_out("probe_k")))
        stages = fused_launches(seen10, "probe_encode_stages", lambda: probe_encode_stages.main(
            tool_out("probe_encode_stages")))
        pbatched = fused_launches(seen10, "probe_batched", lambda: probe_batched.main(
            ["--bs", "16,64,160", *tool_out("probe_batched")]))
    print(f"launches of carry and fold by tool: {json.dumps(seen10)}")
    tool_rows = ([streaming["streaming_shared_table"]] + streaming["batched_100KiB_curve"]
                 + [r for rows in small.values() for r in rows] + ks)
    bad = [r for r in tool_rows if not r["roundtrip_ok"]]
    if bad:
        raise AssertionError(f"tool rows that do not round-trip: {bad}")
    print(f"tool bench_streaming --fast ({card}): {json.dumps(streaming)}")
    print(f"tool bench_small --reps 16 ({card}): {json.dumps(small)}")
    print(f"tool probe_k ({card}): {json.dumps(ks)}")
    print(f"tool probe_encode_stages ({card}): {json.dumps(stages)}")
    print(f"tool probe_batched --bs 16,64,160 ({card}): {json.dumps(pbatched)}")
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)

    # 11. The benchmark entry: bench_torch.py's supervisor in a child
    # process, its one line checked; then its bodies' device operations,
    # the all-rows decode body beside the first-w-rows one.
    t11 = time.perf_counter()
    bench_py = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_torch.py")
    r11 = subprocess.run(
        [sys.executable, bench_py], capture_output=True, text=True, timeout=BENCH_SECONDS,
        env=dict(os.environ, BENCH_SUPERVISOR_BUDGET_S=str(BENCH_SECONDS)),
    )
    lines11 = r11.stdout.splitlines()
    if r11.returncode != 0 or not lines11:
        raise AssertionError(f"bench_torch.py rc {r11.returncode}: {r11.stdout[-2000:]}"
                             f"{r11.stderr[-2000:]}")
    line11 = json.loads(lines11[-1])
    d11 = line11.get("detail", {})
    want11 = {"roundtrip_ok": True, "ratio": RATIO, "ratio_payload": RATIO_PAYLOAD, "k_lanes": K}
    if line11.get("value") is None or {key: d11.get(key) for key in want11} != want11:
        raise AssertionError(f"bench_torch.py line: {lines11[-1]}")
    missing = [k for k in SINGLE_PATH + FUSED if d11["launches"][k] == 0]
    if missing:
        raise AssertionError(f"bench_torch.py never launched {missing}")
    print(f"bench_torch.py ({card}; {time.perf_counter() - t11:.1f} s with start-up): "
          f"{lines11[-1]}", flush=True)
    # The bodies in this process, on phase 4's block: the entry's encode
    # and first-w-rows decode bodies, each in turns with the same body in
    # PyTorch's own ops (the NaN test cast to u8 and added, an int64
    # `.sum()` of the bit counts and table, an int32 add on the words,
    # `sum(dtype=int32)` of the bytes, which PyTorch widens first, each
    # sum cast and added to the accumulator) and an all-rows decode body
    # (the carried 0 added to all W rows, a u8 sum, which PyTorch widens to
    # int64): the last three are comparison rows.  Then the device
    # operations of each body's step as sustained_seconds captures it;
    # the entry's steps must be exactly the codec's kernels, hist256's
    # memset, one carry and one fold.
    ct = comp.tables
    w11 = max(decode_statics(comp.meta(), s), 1)
    tabs11 = (ct["e_bound"], ct["g_rank"], ct["sorted_syms"])

    def torch_ops_encode_body(acc):
        c = codec.encode_device(data + torch.isnan(acc).to(torch.uint8))
        acc.add_((c.bit_counts.sum() + c.tables["enc_table"].sum()).to(torch.float32))

    def torch_ops_decode_body(acc):
        o = decode_lanes(comp.words[:w11] + torch.isnan(acc).to(torch.int32), *tabs11, s)
        acc.add_(o.reshape(-1)[:N].sum(dtype=torch.int32).to(torch.float32))

    def all_rows_body(acc):
        o = decode_lanes(comp.words + torch.isnan(acc).to(torch.int32), *tabs11, s)
        acc.add_(o.sum().to(torch.float32))

    enc_key, dec_key = "encode", f"decode, first {w11} rows"
    bodies = {
        enc_key: encode_body(codec, data),
        dec_key: decode_body(comp),
        "encode, PyTorch ops (comparison)": torch_ops_encode_body,
        f"decode, first {w11} rows, PyTorch ops (comparison)": torch_ops_decode_body,
        f"decode, all {w32} rows, PyTorch ops (comparison)": all_rows_body,
    }
    keys = list(bodies)
    seen11 = {}
    for key in (enc_key, dec_key):
        fused_launches(seen11, key, lambda key=key: bodies[key](fused.accumulator(dev)))
    print(f"launches of carry and fold by body, one call: {json.dumps(seen11)}")
    turns11 = {key: [] for key in keys}
    for new, old in ((keys[0], keys[2]), (keys[1], keys[3]), (keys[4], keys[4])):
        for key in (old, new, new, old) if new != old else (new, new):
            turns11[key].append(sustained_seconds(bodies[key], reps=64, tries=4) * 1e3)
    for key, times in turns11.items():
        print(f"bench body {key} ({card}): sustained ms, two readings taken in turns "
              f"(PyTorch ops, kernels, kernels, PyTorch ops): {json.dumps(times)}")
    expected11 = {enc_key: ENCODE_STEP, dec_key: DECODE_STEP}
    for key, body in bodies.items():
        step_ops(f"bench body {key} ({card})", body, dev, expected11.get(key))
    print(f"phase 11: {time.perf_counter() - t11:.1f} s", flush=True)

    # 12. The fuzz battery of tests/test_fuzz.py on the card, held against
    # the CPU path (tests/test_torch_fuzz.py holds that to the JAX
    # package); the counters cover this phase only.
    t12 = time.perf_counter()
    _cuda.reset_launches()
    fuzz = [dict(c, stride=None) for c in kernel_cases.tpu_battery()]
    fuzz += kernel_cases.hist_stride_battery()
    encode_paths = {}  # encode kernel -> the (K, S) shapes that took it
    for c in fuzz:
        raw, k12 = c["raw"], c["k"]
        label = f"fuzz case n={c['n']} K={k12} stride={c['stride']} {c['style']}"
        gcodec = TorchCodec(k12, hist_stride=c["stride"], device=dev)
        gblob = gcodec.compress(raw)
        torch.cuda.synchronize()
        if gblob != TorchCodec(k12, hist_stride=c["stride"], device="cpu").compress(raw):
            raise AssertionError(f"{label}: the card's blob differs from the CPU path's")
        if gcodec.decompress(gblob) != raw:
            raise AssertionError(f"{label}: the card does not decode its blob to the input")
        torch.cuda.synchronize()
        if raw:
            s12 = -(-len(raw) // k12)
            w12 = (s12 * TPU_MAX_CODE_LEN + 31) // 32 + 1
            path = ("encode_lanes_direct_kernel" if w12 * ENCODE_TILE_LANES * 4 > ENCODE_TILE_BYTES
                    else "encode_lanes_kernel")
            if path not in encode_paths:  # the trace must name the kernel the rule picks
                x12 = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
                for _ in range(3):  # a window may lose launches (as `kernel_ms` says)
                    names = [op for op, _, _ in device_ops(lambda: gcodec.encode_device(x12), 10)]
                    if any(f"{path}(" in op for op in names):
                        break
                else:
                    raise AssertionError(f"{label}: expected {path}, the trace has {names}")
            encode_paths.setdefault(path, []).append((k12, s12))
    # Mutated blobs of the 50,000-byte biased block at K = 256: the card
    # gives the CPU's bytes, or both raise ValueError.
    cpu12, gpu12 = TorchCodec(device="cpu"), TorchCodec(device=dev)
    mraw = kernel_cases.mutation_block()
    mblob = gpu12.compress(mraw)
    if mblob != cpu12.compress(mraw):
        raise AssertionError("the mutation block's card blob differs from the CPU path's")

    def outcome(codec12, blob12):
        try:
            return codec12.decompress(blob12)
        except ValueError as e:
            return ValueError, str(e)

    agree = {"same bytes": 0, "ValueError on both": 0}
    for at, bad in kernel_cases.byte_flips(mblob, FUZZ_FLIPS):
        got, want = outcome(gpu12, bad), outcome(cpu12, bad)
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"flip at byte {at}: the card gives {str(got)[:200]}, "
                                 f"the CPU {str(want)[:200]}")
        agree["same bytes" if isinstance(got, bytes) else "ValueError on both"] += 1
    before12 = dict(_cuda.LAUNCHES)
    for name, bad in kernel_cases.inflated_raw_sizes(mblob).items():
        for codec12 in (gpu12, cpu12):
            got = outcome(codec12, bad)
            if not (isinstance(got, tuple) and "raw size" in got[1]):
                raise AssertionError(f"raw size {name} was not refused: {str(got)[:200]}")
    torch.cuda.synchronize()
    if dict(_cuda.LAUNCHES) != before12:
        raise AssertionError("an inflated raw size launched a kernel before it was refused")
    launches_f = dict(_cuda.LAUNCHES)
    missing = [k for k in SINGLE_PATH if launches_f[k] == 0]
    if missing:
        raise AssertionError(f"the fuzz battery never launched {missing}")
    print(f"fuzz battery ({card}): {len(fuzz)} cases (36 of tests/test_fuzz.py's tpu-profile "
          f"battery, 12 of its hist_stride battery), K {sorted({c['k'] for c in fuzz})}, "
          f"n {min(c['n'] for c in fuzz)}-{max(c['n'] for c in fuzz)}: every card blob "
          f"equals the CPU path's and decodes to the input; encode kernels: "
          + "; ".join(f"{p_} {len(v)} cases, K {sorted({kk for kk, _ in v})}, S "
                      f"{min(ss for _, ss in v)}-{max(ss for _, ss in v)}"
                      for p_, v in encode_paths.items())
          + f"; {FUZZ_FLIPS} mutated blobs of the 50,000-byte block agree with the CPU "
          f"({json.dumps(agree)}); raw sizes x4, x64 and high byte 0x40 raise ValueError "
          f"before any launch; launches {json.dumps(launches_f)}; phase 12: "
          f"{time.perf_counter() - t12:.1f} s", flush=True)

    # Bounds at the shapes of `ms`: each input read once, each output
    # written once; the decode reads only the payload bits of its lanes.
    # table_build's tree is serial on one thread: for this run's n symbols,
    # 2 (n - 1) dependent picks of the merges and n - 2 dependent depth
    # steps, each at least one dependent instruction.
    n_syms = int((hist > 0).sum())
    chain_ms = (3 * n_syms - 4) * DEP_CYCLES / SM_HZ * 1e3
    bounds = {
        "hist256": bound(N // 32 + 256 * 4),
        "hist256_batch": bound(BATCH * NB + BATCH * 256 * 4),
        "table_build": max(bound(256 * 4 + TABLE_LEN * 4), (chain_ms, "operations")),
        "encode_lanes": bound(N + 256 * 4 + w32 * K * 4 + K * 4),
        "decode_lanes": bound(int(bits.sum()) / 8 + (2 * TPU_MAX_CODE_LEN + 3 + 256) * 4 + N),
        "hist256_onehot": bound(N + 256 * 4, 512 * N, MMA_OPS["bf16"]),
        "carry": bound(2 * N + 4),
        "fold": bound(N + 4),
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": (launches[name] + launches_b[name] + launches_m[name]
                         + launches_r[name] + launches_s[name] + launches_c[name]
                         + launches_f[name]),
            "max_abs_err": err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": library_ms.get(name),
        }
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
