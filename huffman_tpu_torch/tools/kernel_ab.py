"""A/B of the table and decode kernels against another version of their
sources, in turns on one card, with the table kernel's step times and a
split of the decode kernel's time.

Usage:
  python3 -m huffman_tpu_torch.tools.kernel_ab --parent DIR [--out PATH]

DIR holds the other version's ``table_build.cu`` and ``decode_lanes.cu``,
for example the parent commit's ``huffman_tpu_torch/csrc`` unpacked by
``git archive`` into a gitignored directory such as ``checkout/``; such a
copy is not committed.  Both versions are built with the nvcc flags of
``ops._cuda`` into ``build/kernel_ab/`` and called through the same C
entry points on the same inputs, made on the card from seeds:

  table_build   the 16 MiB biased block's sampled histogram (B = 1) and
                the 160 x 100 KiB batch's histograms (B = 160)
  decode_lanes  the 16 MiB block (S = 128, K = 131072), the batch
                (S = 100, K = 1024), and the escape-heavy 16 MiB block
                (``bench.kernel_cases.escape_block``)

Both versions must equal the plain versions on every case.  Then each
case is timed in two rounds of parent, change, change, parent: device
milliseconds per launch from the profiler (mean of 50).  After them:

  phases  table_build of each version with a ``clock64()`` stamp, taken
          by thread 0 of each block, before every comment line indented
          2 or 4 spaces that opens a paragraph in the kernel's body (its
          steps): cycles per step, mean over blocks, median of 20
          launches.  The stamped copies are made and built here; they
          are not sources of the repository.
  split   the current decode_lanes with its table lookup replaced by a
          fixed 4-bit length, with every lane of a warp reading the same
          entry (no bank conflicts), and with the escape branch removed:
          device ms of each beside the kernel's.  Their outputs are wrong
          by design and are not checked.
  sweep   the current decode_lanes with one of its constants changed
          (`SWEEP`: threads a block, words loaded ahead, table bits):
          device ms of each, checked against the plain version.

Prints one line per measurement and the card's name and power limit;
``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics

import numpy as np
import torch

from .._build import BUILD_DIR, build_library
from ..bench import kernel_cases, workloads
from ..bench.harness import card_line, device_busy_ms
from ..constants import TPU_MAX_CODE_LEN as L
from ..ops import _cuda
from ..ops.decode_bits import decode_lanes_batch_plain
from ..ops.encode import encode_lanes, encode_lanes_batch
from ..ops.lookup import histogram256_batch, table_hist
from ..ops.table_build import (
    TABLE_LEN,
    _unpack,
    build_coding_device,
    build_coding_flat_batch,
    build_coding_plain_batch,
)

KERNELS = ("table_build", "decode_lanes")
ORDER = ("parent", "change", "change", "parent")
ROUNDS = 2
N, K = 16 << 20, 131072  # the single-block path's block and lanes
NB, BK, BATCH = 100 << 10, 1024, 160  # the batched path's
MAX_STAMPS, MAX_BLOCKS = 32, BATCH

# Lines of decode_lanes.cu that the split replaces.
LOOKUP = "      int entry = lut[static_cast<uint32_t>(buf >> 32) >> (32 - kLut)];"
ESCAPE = "      if (len == 0) {"
SPLIT = {
    "no table, fixed 4-bit length": (
        LOOKUP, "      int entry = 4 << 8 | static_cast<int>(buf >> 56);"),
    "one entry per warp, no bank conflicts": (
        LOOKUP, "      int entry = lut[static_cast<uint32_t>(buf >> 63)];"),
    "no escape branch": (ESCAPE, "      if (false) {"),
}


# Constants of decode_lanes.cu that the sweep sets to other values.
SWEEP = {"kThreads": (256, 1024), "kAhead": (1, 4), "kLut": (10, 12)}


def _kernel_body(src: str, name: str) -> tuple[int, int]:
    """(first, last) line index of ``<name>_kernel``'s body in ``src``:
    the line after its opening brace and the line of its closing one."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if f"{name}_kernel(" in ln)
    open_at = next(i for i in range(start, len(lines)) if lines[i].rstrip().endswith("{"))
    depth = 0
    for i in range(open_at, len(lines)):
        code = lines[i].split("//")[0]
        depth += code.count("{") - code.count("}")
        if depth == 0:
            return open_at + 1, i
    raise ValueError(f"no end to {name}_kernel")


def stamp_phases(src: str, name: str = "table_build") -> tuple[str, list[str]]:
    """``src`` with clock64() stamps in ``<name>_kernel`` and a C entry
    ``kernel_ab_stamps(dst, n)`` that copies the first n stamps (block b's
    at b * MAX_STAMPS) to host memory; and the label of each step."""
    lines = src.split("\n")
    first, last = _kernel_body(src, name)
    out, labels = lines[:first], []
    out.append(f"  long long kab_t[{MAX_STAMPS}];")
    for i in range(first, last):
        ln = lines[i]
        m = re.match(r"^( {2}| {4})// (.*)", ln)
        if m and not lines[i - 1].lstrip().startswith("//"):
            out.append(f"  if (threadIdx.x == 0) kab_t[{len(labels)}] = clock64();")
            labels.append(m.group(2)[:48])
        out.append(ln)
    if not labels or len(labels) >= MAX_STAMPS:
        raise ValueError(f"{len(labels)} steps found in {name}_kernel")
    out.append(
        f"  if (threadIdx.x == 0) {{ kab_t[{len(labels)}] = clock64(); "
        f"for (int i = 0; i <= {len(labels)}; ++i) "
        f"kab_stamps[blockIdx.x * {MAX_STAMPS} + i] = kab_t[i]; }}"
    )
    out.extend(lines[last:])
    text = "\n".join(out)
    decl = f"__device__ long long kab_stamps[{MAX_BLOCKS * MAX_STAMPS}];\n"
    text = text.replace("namespace {", decl + "namespace {", 1)
    text += (
        '\nextern "C" int kernel_ab_stamps(void* dst, int n) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, kab_stamps, n * sizeof(long long)));\n"
        "}\n"
    )
    return text, labels


def split_variants(src: str) -> dict[str, str]:
    """The decode kernel's source with one line replaced per `SPLIT` entry."""
    out = {}
    for label, (old, new) in SPLIT.items():
        if src.count(old) != 1:
            raise ValueError(f"decode_lanes.cu no longer has the line {old.strip()!r}")
        out[label] = src.replace(old, new)
    return out


def sweep_variants(src: str) -> dict[str, str]:
    """The decode kernel's source with one `SWEEP` constant changed."""
    out = {}
    for name, values in SWEEP.items():
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, src)) != 1:
            raise ValueError(f"decode_lanes.cu no longer defines {name} once")
        for v in values:
            out[f"{name}={v}"] = re.sub(pattern, f"constexpr int {name} = {v};", src)
    return out


def _build(name: str, tag: str, text: str):
    """The C entry ``<name>_launch`` of ``text`` compiled as ops._cuda
    compiles ``name``, and the library."""
    out_dir = os.path.join(BUILD_DIR, "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    built, _ = build_library(f"{tag}_{name}", _cuda._nvcc(), _cuda._FLAGS, [path], out_dir)
    lib = ctypes.CDLL(built)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = _cuda._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn, lib


def _cases(dev) -> dict:
    """name -> (kernel, launch(fn), plain output): each case's inputs."""
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    cases = {}

    def table_case(h):
        bcount = h.shape[0]
        out = torch.empty(bcount * TABLE_LEN, dtype=torch.int32, device=dev)

        def run(fn):
            _check(fn(h.data_ptr(), bcount, out.data_ptr(), stream()))
            return out

        return "table_build", run, build_coding_plain_batch(h.cpu()).to(dev)

    def decode_case(words, tables, s, w):
        bcount, pitch, k = words.shape
        eb, gr, sy = (tables[key].reshape(bcount, -1).contiguous()
                      for key in ("e_bound", "g_rank", "sorted_syms"))
        out = torch.empty((bcount, s, k), dtype=torch.uint8, device=dev)

        def run(fn):
            _check(fn(words.data_ptr(), bcount, pitch, w, k, eb.data_ptr(), gr.data_ptr(),
                      sy.data_ptr(), s, out.data_ptr(), stream()))
            return out

        return "decode_lanes", run, decode_lanes_batch_plain(words, eb, gr, sy, s, w)

    s, w32 = N // K, (N // K * L + 31) // 32 + 1
    data = torch.from_numpy(workloads.biased_u8(N, 0)).to(dev)
    hist = table_hist(data, 32)
    tables = build_coding_device(hist)
    words, _ = encode_lanes(data, tables["enc_table"], s, K, w32)
    blocks = torch.from_numpy(workloads.biased_u8(BATCH * NB, BATCH).reshape(BATCH, NB)).to(dev)
    bhist = histogram256_batch(blocks)
    btab = _unpack(build_coding_flat_batch(bhist), BATCH)
    bs = NB // BK
    bw32 = (bs * L + 31) // 32 + 1
    bwords, bbits = encode_lanes_batch(blocks, btab["enc_table"], bs, BK, bw32)
    esc = torch.from_numpy(kernel_cases.escape_block(N)).to(dev)
    etab = build_coding_device(
        torch.from_numpy(kernel_cases.fibonacci_hist().astype(np.int32)).to(dev))
    ewords, _ = encode_lanes(esc, etab["enc_table"], s, K, w32)

    cases["table_build 16 MiB"] = table_case(hist.view(1, -1))
    cases[f"table_build B={BATCH}"] = table_case(bhist)
    cases["decode_lanes 16 MiB"] = decode_case(words.view(1, w32, K), tables, s, w32)
    cases[f"decode_lanes B={BATCH}"] = decode_case(
        bwords, btab, bs, int((bbits.max() + 31) // 32))
    cases["decode_lanes escape-heavy 16 MiB"] = decode_case(ewords.view(1, w32, K), etab, s, w32)
    return cases


def _device_ms(fn) -> float:
    """`device_busy_ms` of 50 calls; the profiler now and then records no
    device activity for a window, which is retried."""
    for _ in range(3):
        ms = device_busy_ms(fn, reps=50)
        if ms > 0:
            return ms
    raise RuntimeError("the profiler recorded no device time in three windows")


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {rc}")


def _phases(fn, read, case, n_stamps: int, reps: int = 20) -> list[float]:
    _, run, _ = case
    runs = []
    for _ in range(reps):
        out = run(fn)
        torch.cuda.synchronize()
        bcount = out.numel() // TABLE_LEN
        buf = np.zeros(bcount * MAX_STAMPS, np.int64)
        _check(read(buf.ctypes.data, buf.size))
        t = buf.reshape(bcount, MAX_STAMPS)[:, :n_stamps].astype(np.float64)
        runs.append(np.diff(t, axis=1).mean(axis=0))
    return np.median(np.stack(runs), axis=0).tolist()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="directory of the other version's sources")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    sources = {
        "parent": {n: _read(os.path.join(args.parent, f"{n}.cu")) for n in KERNELS},
        "change": {n: _read(os.path.join(_cuda._CSRC, f"{n}.cu")) for n in KERNELS},
    }
    fns = {v: {n: _build(n, v, sources[v][n])[0] for n in KERNELS} for v in sources}
    cases = _cases(dev)
    for cname, (kernel, run, want) in cases.items():
        for version in sources:
            if not torch.equal(run(fns[version][kernel]), want):
                raise AssertionError(f"{version} {cname} differs from the plain version")
    print("both versions equal the plain versions on every case", flush=True)

    times = {c: {v: [] for v in sources} for c in cases}
    for _ in range(ROUNDS):
        for version in ORDER:
            for cname, (kernel, run, _) in cases.items():
                fn = fns[version][kernel]
                times[cname][version].append(_device_ms(lambda: run(fn)))
    for cname, by in times.items():
        turns = " / ".join(f"{t:.6f}" for t in _interleave(by, ROUNDS))
        ratio = statistics.mean(by["change"]) / statistics.mean(by["parent"])
        print(f"ab {cname}: parent, change, change, parent = {turns} ms "
              f"(change / parent {ratio:.3f})")

    phases = {}
    for version in sources:
        text, labels = stamp_phases(sources[version]["table_build"])
        fn, lib = _build("table_build", f"{version}_phases", text)
        read = lib.kernel_ab_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        for cname in ("table_build 16 MiB", f"table_build B={BATCH}"):
            cyc = _phases(fn, read, cases[cname], len(labels) + 1)
            phases[f"{version} {cname}"] = dict(zip(labels, cyc))
            print(f"phases {version} {cname} (cycles; total {sum(cyc):.0f}):")
            for label, c in zip(labels, cyc):
                print(f"  {c:10.1f}  {label}")

    split = {}
    decode_cases = [c for c in cases if c.startswith("decode_lanes")]
    for cname in decode_cases:
        _, run, _ = cases[cname]
        split[cname] = {"kernel": _device_ms(lambda: run(fns["change"]["decode_lanes"]))}
        for label, text in split_variants(sources["change"]["decode_lanes"]).items():
            fn, _ = _build("decode_lanes", "split_" + re.sub(r"\W+", "_", label), text)
            split[cname][label] = _device_ms(lambda: run(fn))
        print(f"split {cname}: " + ", ".join(f"{k} {v:.6f} ms" for k, v in split[cname].items()))
    sweep = {}
    for label, text in sweep_variants(sources["change"]["decode_lanes"]).items():
        fn, _ = _build("decode_lanes", "sweep_" + re.sub(r"\W+", "_", label), text)
        sweep[label] = {}
        for cname in decode_cases:
            _, run, want = cases[cname]
            if not torch.equal(run(fn), want):
                raise AssertionError(f"decode_lanes with {label} differs on {cname}")
            sweep[label][cname] = _device_ms(lambda: run(fn))
        print(f"sweep {label}: " + ", ".join(f"{c} {t:.6f} ms" for c, t in sweep[label].items()))
    print(f"card: {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "ab": times, "phases": phases, "split": split,
                       "sweep": sweep}, f, indent=1)


def _interleave(by: dict, rounds: int) -> list[float]:
    """The times in the order they were taken: ORDER, once per round."""
    taken = {v: iter(ts) for v, ts in by.items()}
    return [next(taken[v]) for _ in range(rounds) for v in ORDER]


if __name__ == "__main__":
    main()
