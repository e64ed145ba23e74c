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
   decode with statics precomputed).

The line before the last is a JSON object of the kernels (launches
counted in phases 4 and 4b; ms is the kernel's device time at the
single-block shapes, hist256_batch's at B = 160; plain_ms the plain
version's call); the last is ``{"ok": true, "device": {...}}``.  Imports
neither jax nor huffman_tpu.
"""

from __future__ import annotations

import json
import subprocess
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
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


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


def kernel_ms(fn, kernel: str, reps: int = 50) -> float:
    """Mean device milliseconds of one launch of the CUDA function
    ``<kernel>_kernel`` over ``reps`` calls of ``fn()``, from the
    profiler's device trace.  (`cuda_ms` of back-to-back calls also counts
    the host's time to enqueue each call, which bounds a kernel of a few
    microseconds.)  Fails unless each call launched it once."""
    hits = [e for e in _profile(fn, reps) if f"{kernel}_kernel(" in e.key]
    if len(hits) != 1 or hits[0].count != reps:
        raise AssertionError(
            f"profiler saw {[(e.key, e.count) for e in hits]}, expected {reps} x {kernel}"
        )
    return hits[0].device_time_total / reps / 1e3


def busy_ms(fn, reps: int = 20) -> float:
    """Mean device-busy milliseconds (kernels, memsets, copies) per call of
    ``fn()``, from the profiler's device trace."""
    return sum(e.self_device_time_total for e in _profile(fn, reps)) / reps / 1e3


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
    from huffman_tpu_torch.bench import workloads
    from huffman_tpu_torch.constants import TPU_MAX_CODE_LEN
    from huffman_tpu_torch.ops import _cuda
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
    missing = [k for k, v in launches.items() if v == 0 and k != "hist256_batch"]
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
    missing = [k for k, v in launches_b.items() if v == 0 and k != "hist256"]
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
    for key, (nbytes, enc_fn, dec_fn) in paths.items():
        gib = nbytes / (1 << 30)
        e_ms, dd_ms = path_ms[key]
        print(f"{key}: encode {e_ms:.6f} ms = {gib / (e_ms / 1e3):.4f} GiB/s "
              f"(device busy {busy_ms(enc_fn):.6f} ms), decode {dd_ms:.6f} ms = "
              f"{gib / (dd_ms / 1e3):.4f} GiB/s (device busy {busy_ms(dec_fn):.6f} ms)")
    gib = N / (1 << 30)
    print(f"bytes API (median of 5, host clock): compress {c_ms:.3f} ms = "
          f"{gib / (c_ms / 1e3):.4f} GiB/s, decompress {d_ms:.3f} ms = "
          f"{gib / (d_ms / 1e3):.4f} GiB/s; serialize {ser_ms:.3f} ms, "
          f"deserialize {des_ms:.3f} ms")

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name] + launches_b[name],
            "max_abs_err": err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
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
