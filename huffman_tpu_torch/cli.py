"""Command-line tool: compress and decompress files with the port, the
counterpart of ``huffman_tpu/cli.py`` (the same subcommands, profiles,
files, output lines and exit codes).

Usage:
  python -m huffman_tpu_torch.cli compress   IN OUT [--profile tpu|ref|native] [--k K]
  python -m huffman_tpu_torch.cli decompress IN OUT [--profile tpu|ref|native] [--k K]
  python -m huffman_tpu_torch.cli roundtrip  IN      [--profile tpu|ref|native] [--k K]
  (each also takes --block BYTES and --device DEVICE)

Profiles: ``tpu`` — `TorchCodec`, files in the block container (HTPC
of HTP3 blocks of --block bytes, default 16 MiB, incompressible blocks
stored); ``ref`` — the reference-compatible K-stream blob of
`TorchRefCodec` (K = --k, default 32; the format has no container);
``native`` — the same ref format through the host library's threaded
pipeline (a container of ref records), no device needed; where the
host library cannot be built, the ``native`` profile writes and reads a
bare ref blob through the numpy oracle, as ``huffman_tpu.cli`` does.
--device (default cuda) is where the tpu and ref profiles run; ``cpu``
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from . import container, native
from .models.torch_codec import TorchCodec
from .models.torch_ref_codec import TorchRefCodec


def _codec(profile: str, k: int | None, device: str):
    if profile == "tpu":
        return TorchCodec(k, device=device)
    if profile == "ref":
        return TorchRefCodec(k or 32, device=device)
    if profile == "native":
        return native.NativeCodec(k or 32)
    raise SystemExit(f"unknown profile {profile!r} (use tpu|ref|native)")


def compress_file(
    inp: str, out: str, profile: str, k: int | None, block: int, device: str = "cuda"
) -> dict:
    t0 = time.perf_counter()
    if profile == "native":
        try:
            n_out = native.compress_file(inp, out, k=k or 32, block=block)
            return {"in": os.path.getsize(inp), "out": n_out, "seconds": time.perf_counter() - t0}
        except RuntimeError:
            pass  # no host library: a bare ref blob through the bytes codec below
    codec = _codec(profile, k, device)
    with open(inp, "rb") as fi:
        raw = fi.read()
    if profile == "tpu":
        codec.block_bytes = block
        blob = container.compress_blocks(raw, codec, block)
    else:
        blob = codec.compress(raw)
    with open(out, "wb") as fo:
        fo.write(blob)
    return {"in": len(raw), "out": len(blob), "seconds": time.perf_counter() - t0}


def decompress_file(
    inp: str, out: str, profile: str, k: int | None, device: str = "cuda"
) -> dict:
    t0 = time.perf_counter()
    with open(inp, "rb") as fi:
        blob = fi.read()
    if profile == "native" and blob[:4] == container.MAGIC:
        # The pipeline's container; else a bare ref blob, decoded below.
        try:
            n_out = native.decompress_file(inp, out)
        except RuntimeError:
            # No host library: the container's 'R' and 'S' records through
            # the numpy oracle.
            raw = container.decompress_blocks(blob, None)
            with open(out, "wb") as fo:
                fo.write(raw)
            n_out = len(raw)
        return {"in": len(blob), "out": n_out, "seconds": time.perf_counter() - t0}
    codec = _codec(profile, k, device)
    if profile == "tpu":
        try:
            raw = container.decompress_blocks(blob, codec)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    else:
        raw = codec.decompress(blob)
    with open(out, "wb") as fo:
        fo.write(raw)
    return {"in": len(blob), "out": len(raw), "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="huffman_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("compress", "decompress", "roundtrip"):
        p = sub.add_parser(name)
        p.add_argument("input")
        if name != "roundtrip":
            p.add_argument("output")
        p.add_argument("--profile", default="tpu", choices=("tpu", "ref", "native"))
        p.add_argument("--k", type=int, default=None)
        p.add_argument("--block", type=int, default=16 << 20)
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.cmd == "compress":
        r = compress_file(args.input, args.output, args.profile, args.k, args.block, args.device)
        mbs = r["in"] / max(r["seconds"], 1e-9) / (1 << 20)
        print(
            f"{r['in']} -> {r['out']} bytes "
            f"(ratio {r['in'] / max(r['out'], 1):.3f}) in {r['seconds']:.3f}s "
            f"[{mbs:.1f} MiB/s incl. host framing]"
        )
    elif args.cmd == "decompress":
        r = decompress_file(args.input, args.output, args.profile, args.k, args.device)
        mbs = r["out"] / max(r["seconds"], 1e-9) / (1 << 20)
        print(
            f"{r['in']} -> {r['out']} bytes in {r['seconds']:.3f}s "
            f"[{mbs:.1f} MiB/s incl. host framing]"
        )
    else:  # roundtrip
        with tempfile.TemporaryDirectory() as td:
            cpath = os.path.join(td, "c")
            dpath = os.path.join(td, "d")
            rc = compress_file(args.input, cpath, args.profile, args.k, args.block, args.device)
            rd = decompress_file(cpath, dpath, args.profile, args.k, args.device)
            with open(args.input, "rb") as f1, open(dpath, "rb") as f2:
                ok = f1.read() == f2.read()
            print(
                f"roundtrip {'OK' if ok else 'MISMATCH'}: "
                f"{rc['in']} -> {rc['out']} -> {rd['out']} bytes "
                f"(ratio {rc['in'] / max(rc['out'], 1):.3f})"
            )
            if not ok:
                sys.exit(1)


if __name__ == "__main__":
    main()
