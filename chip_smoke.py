"""Build the port's CUDA kernels and drive its main path once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):

1. Device: a CUDA device must be present; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``huffman_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) and
   prints the build time and each kernel's register and shared-memory use.
3. Kernels: each of hist256, table_build, encode_lanes and decode_lanes
   on the card, at the single-block path's shapes (16 MiB biased block,
   S = 128, K = 131072), must equal its plain PyTorch version exactly.
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
   plain versions exactly; then, with the counters zeroed just before,
   ``encode_batch`` -> ``batch_decode_statics`` -> ``decode_batch`` must
   return the 160 blocks and a small batch holding a constant block; the
   batched kernels' counters must be nonzero after.  Blocks 0, 1 and 159
   and the constant block must serialize to the CPU path's solo
   ``compress`` bytes.
5. Times: each kernel's device time per launch (torch.profiler) beside
   its wrapper call and its plain version (CUDA events around
   back-to-back calls), single-block kernels at the 16 MiB block and
   batched forms at B = 160; compress / decompress GiB/s on the 16 MiB
   block (the device path with CUDA events after warm-up and its device
   busy time, the bytes API as the median of 5 synchronised host-clock
   calls); and the batched device path at B = 1, 16 and 160 (the same,
   decode with statics precomputed).  Also hist256's full count of the
   16 MiB block, and hist256_onehot in each MMA type on it, each beside
   its plain version and ``torch.bincount`` (the library yardstick).
6. hist256_onehot (the histogram race's kernel) in each MMA type (s8,
   bf16, tf32) must equal its plain version and hist256's full count on
   three 16 MiB blocks (biased, uniform, and constant, whose one bin is
   2^24) and on a 256 MiB block, where every warp flushes its sums
   mid-loop; a length that is not a multiple of 2^19 must raise.
7. The measurement path at full width, with the launch counters zeroed
   just before: ``bench_torch_codec`` on the 16 MiB biased block (round
   trip, ratio len(blob) / n of phase 4), ``run_suite`` of the biased and
   uniform workloads at 4 MiB over the suite's rows
   (``tools.run_benchmarks.suite_codecs``, every row must round-trip),
   and ``race(16 MiB)`` (every row OK); the counters of hist256_onehot,
   hist256, table_build, encode_lanes and decode_lanes must be nonzero
   after.  It runs after phase 5's profiler windows, which leave every
   later launch costing the host more; its timings replay CUDA graphs,
   one launch per rep.

The line before the last is a JSON object of the kernels (launches
counted in phases 4, 4b and 7; ms is the kernel's device time at the
single-block shapes, hist256_batch's at B = 160, hist256_onehot's in
bf16 (the TPU's base variant) at 16 MiB; plain_ms the plain version's
call; bound_ms the least time of the same work on an H100 at its
published peaks, from the bytes moved or the tensor operations, and for
table_build, which moves 2 KiB, from its serial chain of dependent steps;
library_ms ``torch.bincount``'s call where it computes the same
function); the last is ``{"ok": true, "device": {...}}``.  Imports
neither jax nor huffman_tpu.
"""

from __future__ import annotations

import json
import sys
import time

N = 16 << 20  # the headline block
K = 131072  # default_lanes(16 MiB)
RATIO = 2.1626  # whole-blob ratio of the 16 MiB biased block
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
}
# The kernels each path must launch.
SINGLE_PATH = ("hist256", "table_build", "encode_lanes", "decode_lanes")
BATCHED_PATH = ("hist256_batch", "table_build", "encode_lanes", "decode_lanes")
MEASURE_PATH = ("hist256_onehot",) + SINGLE_PATH

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
    which bounds a kernel of a few microseconds.)  Fails unless each call
    launched it once."""
    match = match or f"{kernel}_kernel("
    hits = [e for e in _profile(fn, reps) if match in e.key]
    if len(hits) != 1 or hits[0].count != reps:
        raise AssertionError(
            f"profiler saw {[(e.key, e.count) for e in hits]}, expected {reps} x {kernel}"
        )
    return hits[0].device_time_total / reps / 1e3


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


def main() -> None:
    import numpy as np
    import torch

    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from huffman_tpu_torch import TorchCodec
    from huffman_tpu_torch.bench import render_markdown, run_suite, workloads
    from huffman_tpu_torch.bench.harness import bench_torch_codec, card_line, device_busy_ms
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
    from huffman_tpu_torch.models.torch_codec import TorchCompressed
    from huffman_tpu_torch.ops.decode_bits import (
        decode_lanes,
        decode_lanes_batch,
        decode_lanes_batch_plain,
        decode_lanes_plain,
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

    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    hists = {
        "sampled": hist,
        "fibonacci": torch.tensor(fib[::-1] + [0] * 236, dtype=torch.int32),
        "single": torch.tensor([0] * 65 + [1000] + [0] * 190, dtype=torch.int32),
        "equal": torch.full((256,), 17, dtype=torch.int32),
        "empty": torch.zeros(256, dtype=torch.int32),
    }
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
    torch.cuda.synchronize()
    print("kernels: all four single-block kernels equal their plain versions at "
          "S=128, K=131072", flush=True)

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
    torch.cuda.synchronize()
    print(f"kernels: hist256_batch and the batched table_build, encode_lanes and "
          f"decode_lanes equal their plain versions at B={BATCH}, S={bs}, K={BK}", flush=True)

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
    for key, (nbytes, enc_fn, dec_fn) in paths.items():
        gib = nbytes / (1 << 30)
        e_ms, dd_ms = path_ms[key]
        print(f"{key}: encode {e_ms:.6f} ms = {gib / (e_ms / 1e3):.4f} GiB/s "
              f"(device busy {device_busy_ms(enc_fn):.6f} ms), decode {dd_ms:.6f} ms = "
              f"{gib / (dd_ms / 1e3):.4f} GiB/s (device busy {device_busy_ms(dec_fn):.6f} ms)")
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
          f"full count on the biased, uniform and constant (bin 2^24) 16 MiB blocks and "
          f"a 256 MiB block; a length off the {CHUNK}-byte grid raises", flush=True)

    # 7. The measurement path at full width; the counters cover this
    # phase only.
    _cuda.reset_launches()
    t7 = time.perf_counter()
    row = bench_torch_codec(TorchCodec(device=dev), data_np.tobytes())
    if not row["roundtrip_ok"]:
        raise AssertionError("bench_torch_codec: the 16 MiB block does not round-trip")
    if row["ratio"] != len(blob) / N:
        raise AssertionError(f"bench_torch_codec ratio {row['ratio']} != {len(blob) / N}")
    gib = N / (1 << 30)
    e_ms, dd_ms = path_ms["device path"]
    print(f"bench_torch_codec 16 MiB: ratio {row['ratio']:.6f} (n / blob {1 / row['ratio']:.4f}), "
          f"round trip ok; sustained compress {row['compress_bps'] / (1 << 30):.4f} GiB/s, "
          f"decompress {row['decompress_bps'] / (1 << 30):.4f} GiB/s (CUDA-graph replays); "
          f"phase 5's device path by events: encode {gib / (e_ms / 1e3):.4f}, "
          f"decode {gib / (dd_ms / 1e3):.4f} GiB/s", flush=True)
    suite = run_suite(["biased", "uniform"], suite_codecs(dev), 4 << 20, reps=8)
    print(render_markdown(suite), flush=True)
    bad = [(w, r["method"], r["streams"]) for w, blk in suite.items() for r in blk["rows"]
           if not r["roundtrip_ok"]]
    if bad:
        raise AssertionError(f"suite rows that do not round-trip: {bad}")
    rows = race(N)
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
          f"({time.perf_counter() - t7:.1f} s)", flush=True)

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
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name] + launches_b[name] + launches_m[name],
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
