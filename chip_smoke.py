"""Build the port's CUDA kernels and drive its main path once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):

1. Device: a CUDA device must be present; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``huffman_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) and
   prints the build time and each kernel's register and shared-memory use.
3. Kernels: each of hist256, table_build, encode_lanes and decode_lanes
   on the card, at the main path's shapes (16 MiB biased block, S = 128,
   K = 131072), must equal its plain PyTorch version exactly.
4. End to end: ``TorchCodec(device="cuda")`` on the 16 MiB biased block:
   encode -> serialize -> deserialize -> decode gives the input back, the
   blob equals the CPU path's blob, the ratio is 2.1626, compress /
   decompress round-trip the six benchmark workloads, and a 4 MiB block
   at K = 8192 (S = 512) gives the CPU path's blob and round-trips.  The
   kernels' launch counters, zeroed just before, must all be nonzero
   after.
5. Times: each kernel beside its plain version, and compress / decompress
   GiB/s on the 16 MiB block: the device path with CUDA events after
   warm-up, the bytes API as the median of 5 synchronised host-clock calls.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {...}}``.  Imports neither jax nor huffman_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N = 16 << 20  # the headline block
K = 131072  # default_lanes(16 MiB)
RATIO = 2.1626  # whole-blob ratio of the 16 MiB biased block

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "hist256": ("huffman_tpu_torch/csrc/hist256.cu", "huffman_tpu/ops/lookup.py:98"),
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
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
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
    import torch

    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from huffman_tpu_torch import TorchCodec
    from huffman_tpu_torch.bench import workloads
    from huffman_tpu_torch.constants import TPU_MAX_CODE_LEN
    from huffman_tpu_torch.ops import _cuda
    from huffman_tpu_torch.ops.decode_bits import decode_lanes, decode_lanes_plain
    from huffman_tpu_torch.ops.encode import encode_lanes, encode_lanes_plain
    from huffman_tpu_torch.ops.lookup import table_hist, table_hist_plain
    from huffman_tpu_torch.ops.table_build import (
        _unpack,
        build_coding_flat,
        build_coding_plain,
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
    err, ms, plain_ms = {}, {}, {}

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
    if int(_unpack(build_coding_flat(hists["fibonacci"].to(dev)))["len_count"][15]) == 0:
        raise AssertionError("the Fibonacci histogram should reach 15-bit codes")
    tables = _unpack(build_coding_flat(hist))
    enc = tables["enc_table"]

    words, bits = encode_lanes(data, enc, s, K, w32)
    pw, pb = encode_lanes_plain(data, enc, s, K, w32)
    err["encode_lanes"] = max(expect_equal("encode words", words, pw), expect_equal("encode bits", bits, pb))

    eb, gr, sy = tables["e_bound"], tables["g_rank"], tables["sorted_syms"]
    out = decode_lanes(words, eb, gr, sy, s)
    err["decode_lanes"] = expect_equal("decode", out, decode_lanes_plain(words, eb, gr, sy, s))
    expect_equal("decode vs input", out.reshape(-1), data)
    torch.cuda.synchronize()
    print("kernels: all four equal their plain versions at S=128, K=131072", flush=True)

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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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

    # 5. Times (device time per call, CUDA events, after warm-up).
    ms["hist256"] = cuda_ms(lambda: table_hist(data, 32), 50)
    plain_ms["hist256"] = cuda_ms(lambda: table_hist_plain(data, 32), 20)
    ms["table_build"] = cuda_ms(lambda: build_coding_flat(hist), 50)
    plain_ms["table_build"] = cuda_ms(lambda: build_coding_plain(hist), 5)
    ms["encode_lanes"] = cuda_ms(lambda: encode_lanes(data, enc, s, K, w32), 50)
    plain_ms["encode_lanes"] = cuda_ms(lambda: encode_lanes_plain(data, enc, s, K, w32), 5)
    ms["decode_lanes"] = cuda_ms(lambda: decode_lanes(words, eb, gr, sy, s), 50)
    plain_ms["decode_lanes"] = cuda_ms(lambda: decode_lanes_plain(words, eb, gr, sy, s), 5)
    for name in KERNELS:
        print(f"time {name}: kernel {ms[name]:.6f} ms, plain {plain_ms[name]:.6f} ms")

    comp_t = codec.deserialize(blob)
    codec.decode_device(comp_t)  # fetches and caches the block's metadata
    enc_ms = cuda_ms(lambda: codec.encode_device(data), 20)
    dec_ms = cuda_ms(lambda: codec.decode_device(comp_t), 20)
    gib = N / (1 << 30)
    print(f"device path: encode {enc_ms:.6f} ms = {gib / (enc_ms / 1e3):.4f} GiB/s, "
          f"decode {dec_ms:.6f} ms = {gib / (dec_ms / 1e3):.4f} GiB/s")
    raw = data_np.tobytes()
    c_ms = host_ms(lambda: codec.compress(raw))
    d_ms = host_ms(lambda: codec.decompress(blob))
    print(f"bytes API (median of 5, host clock): compress {c_ms:.3f} ms = "
          f"{gib / (c_ms / 1e3):.4f} GiB/s, decompress {d_ms:.3f} ms = "
          f"{gib / (d_ms / 1e3):.4f} GiB/s; serialize {host_ms(lambda: codec.serialize(comp)):.3f} ms, "
          f"deserialize {host_ms(lambda: codec.deserialize(blob)):.3f} ms")

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
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
