"""A/B of the port's redesigned kernels against another version of their
sources, in turns on one card, with the table kernel's step times and a
split and a constant sweep of the decode and encode kernels.

Usage:
  python3 -m huffman_tpu_torch.tools.kernel_ab --parent DIR [--out PATH]
      [--kernels NAME ...]

DIR holds the other version's ``table_build.cu``, ``decode_lanes.cu``,
``encode_lanes.cu``, ``hist256.cu`` and ``hist256_onehot.cu``, for example the parent commit's
``huffman_tpu_torch/csrc`` unpacked by ``git archive`` into a gitignored
directory such as ``checkout/``; such a copy is not committed.  Both
versions are built with the nvcc flags of ``ops._cuda`` into
``build/kernel_ab/`` (every build of the run at once) and called through
the same C entry points on the same inputs, made on the card from seeds:

  table_build   the 16 MiB biased block's sampled histogram (B = 1) and
                the 160 x 100 KiB batch's histograms (B = 160)
  decode_lanes  the 16 MiB block (S = 128, K = 131072), the batch
                (S = 100, K = 1024), the escape-heavy 16 MiB block
                (``bench.kernel_cases.escape_block``), the sharded
                configuration's step (B = 64 blocks of 1 MiB, S = 256,
                K = 4096), and 8 distinct 16 MiB blocks decoded in turns,
                one launch each, so that the words come from device memory
                as in block16m.device (ms a call of 8 launches); for each,
                the share of its symbols that each version's first-level
                table resolves (`first_level_share`)
  encode_lanes  the same three blocks, the escape-heavy one through the
                Fibonacci table, whose long codes nearly fill every
                lane's words, and the 16 MiB block at an address 3 bytes
                past 16-byte alignment
  hist256       the 16 MiB biased block's sampled and full counts, and
                the full count of a 1 MiB block
  hist256_onehot  the 16 MiB uniform block (the histogram race's) and the
                16 MiB biased block, in each MMA type (s8, bf16, tf32)

``--kernels`` limits the run to some of them.  Both versions must equal
the plain versions on every case.  Then each case is timed in two rounds
of parent, change, change, parent: device milliseconds per launch from
the profiler (mean of 50).  After them, for hist256_onehot, each
version's SASS (``cuobjdump -sass``): the instructions of one 64-byte
warp step of each MMA type's main loop (`sass_step_counts`); and:

  phases  table_build of each version with a ``clock64()`` stamp, taken
          by thread 0 of each block, before every comment line indented
          2 or 4 spaces that opens a paragraph in the kernel's body (its
          steps): cycles per step, mean over blocks, median of 20
          launches.  The stamped copies are made and built here; they
          are not sources of the repository.
  split   the current decode_lanes and encode_lanes, each with one line
          replaced per entry of `SPLIT` / `ENCODE_SPLIT`: device ms of
          each beside the kernel's.  Their outputs are wrong by design
          and are not checked.
  sweep   the current decode_lanes and encode_lanes with one of their
          constants changed (`SWEEP` / `ENCODE_SWEEP`): device ms of each,
          checked against the plain version.

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
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._build import BUILD_DIR, build_library
from ..bench import kernel_cases, workloads
from ..bench.harness import card_line, device_busy_ms
from ..constants import TPU_MAX_CODE_LEN as L
from ..ops import _cuda
from ..ops.decode_bits import decode_lanes_batch_plain
from ..ops.encode import encode_lanes, encode_lanes_batch, encode_lanes_batch_plain
from ..ops.hist_variants import MMA_TYPES, hist_variant_plain
from ..ops.lookup import _geometry, histogram256_batch, table_hist, table_hist_plain
from ..ops.table_build import (
    TABLE_LEN,
    _unpack,
    build_coding_device,
    build_coding_flat_batch,
    build_coding_plain_batch,
)
from .hist_experiments import race_block

KERNELS = ("table_build", "decode_lanes", "encode_lanes", "hist256", "hist256_onehot")
ORDER = ("parent", "change", "change", "parent")
ROUNDS = 2
N, K = 16 << 20, 131072  # the single-block path's block and lanes
NB, BK, BATCH = 100 << 10, 1024, 160  # the batched path's
SN, SK, SB = 1 << 20, 4096, 64  # the sharded configuration's blocks, lanes and blocks a step
TURNS = 8  # distinct 16 MiB blocks decoded in turns, as block16m.device's requests
MAX_STAMPS, MAX_BLOCKS = 32, BATCH

# Lines of decode_lanes.cu that the split replaces.
LOOKUP = '      "ld.shared.u32 %0, [a];\\n\\t}"'
INDEX = '      "shr.u32 a, %1, %4;\\n\\t"'
SECOND = "      const uint2 e = long_pair(w, base, stride, e1, ek, n2, l2, bound, gr, sy);"
REFILL = '      "setp.ge.s32 p, %5, %3;\\n\\t"'
SPLIT = {
    "no table, fixed 4-bit length": (LOOKUP, '      "mov.u32 %0, 1024;\\n\\t}"'),
    "one entry per warp, no bank conflicts": (INDEX, '      "shr.u32 a, %1, 31;\\n\\t"'),
    "no second level, a long code taken as kLut bits": (
        SECOND, "      const uint2 e = make_uint2(e1 & 0xFFF, e2 & 0xFFF);"),
    "no refill": (REFILL, '      "setp.ne.s32 p, %5, %5;\\n\\t"'),
}

# Constants of decode_lanes.cu that the sweep sets to other values.
SWEEP = {"kLut": (10, 12), "kCopies": (1, 16), "kPrefetch": (0, 6), "kMaxThreads": (512,)}

# Lines of encode_lanes.cu that its split replaces.
STORE = "        *reinterpret_cast<uint4*>(words + static_cast<size_t>(row) * k + c) = v;"
COPY = "      if (c < m + width) cp_async16(dst + r * pitch - m + c, row - m + c);"
ENCODE_LOOKUP = "        for (int j = 0; j < kGroupRows; ++j) e[j] = tab[e[j]];"
VEC_OUT = "  const bool vec_out = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;"
ENCODE_SPLIT = {
    "no word stores, only the bit counts": (STORE, "        (void)v;"),
    "no byte copies, the stages left as they are": (COPY, "      (void)dst, (void)row;"),
    "a fixed 4-bit code in place of the table lookup": (
        ENCODE_LOOKUP, "        for (int j = 0; j < kGroupRows; ++j) e[j] = (e[j] & 15) << 4 | 4;"),
    "4-byte word stores": (VEC_OUT, "  const bool vec_out = false;"),
}

# Constants of encode_lanes.cu that its sweep sets to other values.
ENCODE_SWEEP = {"kTileLanes": (64, 256), "kStageRows": (16, 64), "kGroupRows": (8, 32)}


# MMA instructions a thread issues per 64 bytes in hist256_onehot, by MMA
# type (the C entry's numbering): two n-tiles, k = 32, 16 or 8 bytes each.
ONEHOT_MMAS = {0: 4, 1: 8, 2: 16}
_SASS_FN = re.compile(r"Function : (\S*hist256_onehot_kernelILi(\d)E\S*)")
_SASS_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T\d]\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_step_counts(sass: str) -> dict:
    """{MMA type: {opcode: count, ..., "total": n}} for each hist256_onehot
    kernel in ``cuobjdump -sass`` text: the instructions of its main loop
    (the widest predicated backward branch) without the flush block that the loop
    branches over, divided by the loop's 64-byte warp steps (its MMA
    instructions over `ONEHOT_MMAS`)."""
    out = {}
    for part in re.split(r"(?=\s*Function : )", sass):
        fn = _SASS_FN.search(part)
        if not fn:
            continue
        insns, labels, pending = [], {}, []
        for line in part.splitlines():
            lab = _SASS_LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = _SASS_INSN.search(line)
            if m:
                addr = int(m.group(1), 16)
                labels.update({name: addr for name in pending})
                pending = []
                insns.append((addr, m.group(3), m.group(4), bool(m.group(2))))

        def target(ops):
            t = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", ops)
            return None if t is None else int(t.group(1), 16) if t.group(1) else labels[t.group(2)]

        branches = [(a, target(o), p) for a, op, o, p in insns if op.startswith("BRA")]
        # Unconditional backward branches return from the divergent-shuffle
        # paths placed after the kernel's end; the loop's is predicated.
        lo, hi = max(((t, a) for a, t, p in branches if p and t is not None and t < a),
                     key=lambda r: r[1] - r[0])
        body = [(a, op) for a, op, _, _ in insns if lo <= a <= hi]
        atoms = [a for a, op in body if op.startswith("ATOMS")]
        if atoms:
            skip = min(((a, t) for a, t, _ in branches
                        if lo <= a < atoms[0] and t is not None and t > atoms[-1]),
                       key=lambda r: r[1])
            body = [(a, op) for a, op in body if not skip[0] < a < skip[1]]
        counts = {}
        for _, op in body:
            base = op.split(".")[0]
            counts[base] = counts.get(base, 0) + 1
        mmas = counts.get("IMMA", 0) + counts.get("HMMA", 0)
        steps = mmas / ONEHOT_MMAS[int(fn.group(2))]
        per = {k: v / steps for k, v in sorted(counts.items(), key=lambda kv: -kv[1])}
        per["total"] = len(body) / steps
        out[("s8", "bf16", "tf32")[int(fn.group(2))]] = per
    return out


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


def split_variants(src: str, split: dict = SPLIT) -> dict[str, str]:
    """The kernel's source with one line replaced per entry of ``split``
    (label -> (line, replacement)); the decode kernel's by default."""
    out = {}
    for label, (old, new) in split.items():
        if src.count(old) != 1:
            raise ValueError(f"the source no longer has the line {old.strip()!r} once")
        out[label] = src.replace(old, new)
    return out


def sweep_variants(src: str, sweep: dict = SWEEP) -> dict[str, str]:
    """The kernel's source with one constant of ``sweep`` (name -> values)
    changed per variant; the decode kernel's by default."""
    out = {}
    for name, values in sweep.items():
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, src)) != 1:
            raise ValueError(f"the source no longer defines {name} once")
        for v in values:
            out[f"{name}={v}"] = re.sub(pattern, f"constexpr int {name} = {v};", src)
    return out


def _build_all(jobs: dict) -> dict:
    """tag -> (C entry ``<name>_launch``, library) for jobs (tag -> (name,
    source text)), compiled at once as ops._cuda compiles ``name``."""
    out_dir = os.path.join(BUILD_DIR, "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)

    def build(item):
        tag, (name, text) = item
        path = os.path.join(out_dir, f"{tag}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        return build_library(f"{tag}_{name}", _cuda._nvcc(), _cuda._FLAGS, [path], out_dir)[0]

    with ThreadPoolExecutor(min(16, len(jobs))) as pool:
        paths = dict(zip(jobs, pool.map(build, jobs.items())))
    fns = {}
    for tag, (name, _) in jobs.items():
        lib = ctypes.CDLL(paths[tag])
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _cuda.ENTRIES[name].argtypes
        fn.restype = ctypes.c_int
        fns[tag] = (fn, lib)
    return fns


def _tag(*parts: str) -> str:
    return "_".join(re.sub(r"\W+", "_", p) for p in parts)


def first_level_share(lengths, counts, lut_bits: int) -> float:
    """The share of a decode case's symbols that the kernel's first-level
    table resolves, those whose codes are at most ``lut_bits`` long: from
    each block's code lengths and symbol counts, (B, 256) or (256,)."""
    lengths = np.asarray(lengths).reshape(-1, 256)
    counts = np.asarray(counts, np.float64).reshape(-1, 256)
    return float(counts[lengths <= lut_bits].sum() / counts.sum())


def lut_bits(src: str) -> int | None:
    """The first-level table's window bits (``kLut``) of a decode_lanes
    source; None where it defines none."""
    m = re.search(r"constexpr int kLut = (\d+);", src)
    return int(m.group(1)) if m else None


def _cases(dev, kernels) -> tuple[dict, dict]:
    """name -> (kernel, launch(fn), plain output): each case's inputs; and
    for each decode case, its blocks' code lengths and symbol counts."""
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    cases, codes = {}, {}

    def table_case(h):
        bcount = h.shape[0]
        out = torch.empty(bcount * TABLE_LEN, dtype=torch.int32, device=dev)

        def run(fn):
            _check(fn(h.data_ptr(), bcount, out.data_ptr(), stream()))
            return out

        return "table_build", run, build_coding_plain_batch(h.cpu()).to(dev)

    def decode_case(name, words, tables, s, w, blocks):
        bcount, pitch, k = words.shape
        codes[name] = ((tables["enc_table"] & 15).cpu().numpy(),
                       histogram256_batch(blocks.view(bcount, -1)).cpu().numpy())
        eb, gr, sy = (tables[key].reshape(bcount, -1).contiguous()
                      for key in ("e_bound", "g_rank", "sorted_syms"))
        out = torch.empty((bcount, s, k), dtype=torch.uint8, device=dev)

        def run(fn):
            _check(fn(words.data_ptr(), bcount, pitch, w, k, eb.data_ptr(), gr.data_ptr(),
                      sy.data_ptr(), s, out.data_ptr(), stream()))
            return out

        cases[name] = "decode_lanes", run, decode_lanes_batch_plain(words, eb, gr, sy, s, w)

    def decode_turns(name, datas, s, w32):
        """Blocks decoded in turns, one launch each a call, so that each
        launch finds its words cold in L2 as a cell's request does: the
        calls and the outputs of the 16 MiB cells' traffic."""
        tabs, wds, lengths = [], [], []
        for d in datas:
            t = build_coding_device(table_hist(d, 32))
            tabs.append([t[key].contiguous() for key in ("e_bound", "g_rank", "sorted_syms")])
            wds.append(encode_lanes(d, t["enc_table"], s, K, w32)[0])
            lengths.append((t["enc_table"] & 15).cpu().numpy())
        codes[name] = np.stack(lengths), histogram256_batch(torch.stack(datas)).cpu().numpy()
        out = torch.empty((len(datas), s, K), dtype=torch.uint8, device=dev)

        def run(fn):
            for i, (wd, (eb, gr, sy)) in enumerate(zip(wds, tabs)):
                _check(fn(wd.data_ptr(), 1, w32, w32, K, eb.data_ptr(), gr.data_ptr(),
                          sy.data_ptr(), s, out[i].data_ptr(), stream()))
            return out

        want = torch.stack([
            decode_lanes_batch_plain(wd.view(1, w32, K), *(x.view(1, -1) for x in t), s, w32)[0]
            for wd, t in zip(wds, tabs)])
        cases[name] = "decode_lanes", run, want

    def encode_case(blocks, enc, s, k):
        bcount = blocks.shape[0]
        w32 = (s * L + 31) // 32 + 1
        out = torch.empty(bcount * (w32 + 1) * k, dtype=torch.int32, device=dev)
        words, bits = out[: bcount * w32 * k], out[bcount * w32 * k:]

        def run(fn):
            _check(fn(blocks.data_ptr(), enc.data_ptr(), bcount, s, k, w32, words.data_ptr(),
                      bits.data_ptr(), stream()))
            return out

        pw, pb = encode_lanes_batch_plain(blocks, enc, s, k, w32)
        return "encode_lanes", run, torch.cat([pw.reshape(-1), pb.reshape(-1)])

    def hist_case(data, stride):
        rows, row_len, pitch, last_len, bias = _geometry(data.shape[0], stride)
        out = torch.empty(256, dtype=torch.int32, device=dev)

        def run(fn):
            _check(fn(data.data_ptr(), rows, row_len, pitch, last_len, bias, out.data_ptr(),
                      stream()))
            return out

        return "hist256", run, table_hist_plain(data, stride)

    def onehot_case(data, mma):
        out = torch.empty(256, dtype=torch.int32, device=dev)

        def run(fn):
            _check(fn(data.data_ptr(), data.shape[0], MMA_TYPES.index(mma), out.data_ptr(),
                      stream()))
            return out

        return "hist256_onehot", run, hist_variant_plain(data, mma)

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

    if "table_build" in kernels:
        cases["table_build 16 MiB"] = table_case(hist.view(1, -1))
        cases[f"table_build B={BATCH}"] = table_case(bhist)
    if "decode_lanes" in kernels:
        decode_case("decode_lanes 16 MiB", words.view(1, w32, K), tables, s, w32, data)
        decode_case(f"decode_lanes B={BATCH}", bwords, btab, bs, int((bbits.max() + 31) // 32),
                    blocks)
        decode_case("decode_lanes escape-heavy 16 MiB", ewords.view(1, w32, K), etab, s, w32,
                    esc)
        # The sharded configuration's step: 64 blocks of 1 MiB at K = 4096.
        sblocks = torch.from_numpy(workloads.biased_u8(SB * SN, SB).reshape(SB, SN)).to(dev)
        stab = _unpack(build_coding_flat_batch(histogram256_batch(sblocks)), SB)
        ss = SN // SK
        swords, sbits = encode_lanes_batch(sblocks, stab["enc_table"], ss, SK,
                                           (ss * L + 31) // 32 + 1)
        decode_case(f"decode_lanes sharded B={SB}", swords, stab, ss,
                    int((sbits.max() + 31) // 32), sblocks)
        turns = [torch.from_numpy(workloads.biased_u8(N, 100 + i)).to(dev) for i in range(TURNS)]
        decode_turns(f"decode_lanes 16 MiB x {TURNS} in turns", turns, s, w32)
    if "encode_lanes" in kernels:
        cases["encode_lanes 16 MiB"] = encode_case(
            data.view(1, -1), tables["enc_table"].view(1, -1), s, K)
        cases[f"encode_lanes B={BATCH}"] = encode_case(blocks, btab["enc_table"], bs, BK)
        cases["encode_lanes escape-heavy 16 MiB"] = encode_case(
            esc.view(1, -1), etab["enc_table"].view(1, -1), s, K)
        shifted = torch.empty(N + 3, dtype=torch.uint8, device=dev)
        shifted[3:] = data
        cases["encode_lanes offset view 16 MiB"] = encode_case(
            shifted[3:].view(1, -1), tables["enc_table"].view(1, -1), s, K)
    if "hist256" in kernels:
        cases["hist256 sampled 16 MiB"] = hist_case(data, 32)
        cases["hist256 full 16 MiB"] = hist_case(data, 1)
        cases["hist256 full 1 MiB"] = hist_case(data[: 1 << 20], 1)
    if "hist256_onehot" in kernels:
        uniform = torch.from_numpy(race_block(N)).to(dev)
        for bname, blk in (("uniform", uniform), ("biased", data)):
            for mma in MMA_TYPES:
                cases[f"hist256_onehot {mma} {bname} 16 MiB"] = onehot_case(blk, mma)
    return cases, codes


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
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    kernels = [n for n in KERNELS if n in args.kernels]
    card = card_line()
    print(f"card: {card}", flush=True)
    sources = {
        "parent": {n: _read(os.path.join(args.parent, f"{n}.cu")) for n in kernels},
        "change": {n: _read(os.path.join(_cuda._CSRC, f"{n}.cu")) for n in kernels},
    }
    # Every build of the run: both versions, the stamped table builds, and
    # the split and sweep variants of the current decode and encode.
    jobs = {_tag(v, n): (n, sources[v][n]) for v in sources for n in kernels}
    labels = {}
    if "table_build" in kernels:
        for version in sources:
            text, labels[version] = stamp_phases(sources[version]["table_build"])
            jobs[_tag(version, "phases")] = ("table_build", text)
    variants = {}  # kernel -> kind -> label -> tag
    for kernel, split, sweep in (("decode_lanes", SPLIT, SWEEP),
                                 ("encode_lanes", ENCODE_SPLIT, ENCODE_SWEEP)):
        if kernel not in kernels:
            continue
        src = sources["change"][kernel]
        for kind, texts in (("split", split_variants(src, split)),
                            ("sweep", sweep_variants(src, sweep))):
            for label, text in texts.items():
                tag = _tag(kind, kernel, label)
                jobs[tag] = (kernel, text)
                variants.setdefault(kernel, {}).setdefault(kind, {})[label] = tag
    built = _build_all(jobs)
    print(f"built {len(jobs)} libraries", flush=True)
    fns = {v: {n: built[_tag(v, n)][0] for n in kernels} for v in sources}
    cases, codes = _cases(dev, kernels)
    shares = {}
    for version in sources:
        bits = lut_bits(sources[version].get("decode_lanes", ""))
        if bits is None or not codes:
            continue
        shares[version] = {c: first_level_share(*codes[c], bits) for c in codes}
        print(f"first level {version} (kLut = {bits}), share of symbols: "
              + ", ".join(f"{c} {v:.6f}" for c, v in shares[version].items()), flush=True)
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
              f"(change / parent {ratio:.3f})", flush=True)

    sass = {}
    if "hist256_onehot" in kernels:
        tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        for version in sources:
            lib = built[_tag(version, "hist256_onehot")][1]._name
            text = subprocess.run([tool, "-sass", lib], check=True, capture_output=True,
                                  text=True).stdout
            sass[version] = sass_step_counts(text)
            for mma, c in sass[version].items():
                ops = ", ".join(f"{k} {v:g}" for k, v in c.items() if k != "total")
                print(f"sass {version} hist256_onehot {mma}: {c['total']:g} instructions "
                      f"a 64-byte warp step ({ops})", flush=True)

    phases = {}
    for version in labels:
        fn, lib = built[_tag(version, "phases")]
        read = lib.kernel_ab_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        for cname in ("table_build 16 MiB", f"table_build B={BATCH}"):
            cyc = _phases(fn, read, cases[cname], len(labels[version]) + 1)
            phases[f"{version} {cname}"] = dict(zip(labels[version], cyc))
            print(f"phases {version} {cname} (cycles; total {sum(cyc):.0f}):")
            for label, c in zip(labels[version], cyc):
                print(f"  {c:10.1f}  {label}")

    split, sweep = {}, {}
    for kernel, kinds in variants.items():
        kcases = [c for c in cases if c.startswith(kernel)]
        for cname in kcases:
            _, run, _ = cases[cname]
            split[cname] = {"kernel": _device_ms(lambda: run(fns["change"][kernel]))}
            for label, tag in kinds["split"].items():
                fn = built[tag][0]
                split[cname][label] = _device_ms(lambda: run(fn))
            print(f"split {cname}: " + ", ".join(f"{k} {v:.6f} ms" for k, v in split[cname].items()),
                  flush=True)
        for label, tag in kinds["sweep"].items():
            fn = built[tag][0]
            key = f"{kernel} {label}"
            sweep[key] = {}
            for cname in kcases:
                _, run, want = cases[cname]
                if not torch.equal(run(fn), want):
                    raise AssertionError(f"{kernel} with {label} differs on {cname}")
                sweep[key][cname] = _device_ms(lambda: run(fn))
            print(f"sweep {key}: " + ", ".join(f"{c} {t:.6f} ms" for c, t in sweep[key].items()),
                  flush=True)
    print(f"card: {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "ab": times, "phases": phases, "split": split,
                       "sweep": sweep, "sass": sass, "first_level_share": shares}, f, indent=1)


def _interleave(by: dict, rounds: int) -> list[float]:
    """The times in the order they were taken: ORDER, once per round."""
    taken = {v: iter(ts) for v, ts in by.items()}
    return [next(taken[v]) for _ in range(rounds) for v in ORDER]


if __name__ == "__main__":
    main()
