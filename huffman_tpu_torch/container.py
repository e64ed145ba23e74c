"""Block container (HTPC) and stored-block fallback, the same bytes as
``huffman_tpu/container.py``.

Layout (little-endian):

    u32 magic 'HTPC' | u32 block_size | u64 total_raw
    repeat:
      u32 rec_len | u32 raw_len | u8 kind | u16 extra | pad1
      u8  rec[rec_len]

Kinds: 'H' an HTP3 blob, 'S' stored raw bytes, 'R' a ref-profile blob
whose stream count is the u16 extra (written by the native pipeline), 'C'
the trailer, the crc32 of the whole raw content.  Inputs larger than one
block are split into blocks, the last padded to the block size when
there are several (its pad is trimmed on decode); a block whose blob is
not at least 8 bytes smaller than the raw bytes is stored.

A device codec's blocks are pipelined, ``PIPELINE_DEPTH`` in flight, as
the JAX package's container pipelines them: block i+1's upload and
kernels are queued before block i is read back and serialized (or, on
decode, before block i's output is read).  Every copy between the host
and the card goes through `staging`, whose events let the host wait for
block i alone; a blocking ``.cpu()`` would also wait for block i+1.

`record` makes that choice for every writer of HTP3 blocks
(`compress_blocks`, the single block of ``TorchCodec.compress`` and
``parallel.ShardedCodec.compress``) and counts it in `STORED`; while the
recorder of host spans (`tracing`) is on, each stored record is the span
``compress.stored``.
"""

from __future__ import annotations

import struct
import zlib

from . import native, tracing
from .staging import HostCopy

MAGIC = b"HTPC"
KIND_HUFF = 0x48  # 'H'
KIND_STORED = 0x53  # 'S'
KIND_REF = 0x52  # 'R'
KIND_CRC = 0x43  # 'C'

DEFAULT_BLOCK = 16 << 20

#: The stored fallback, as `record` chose it: ``blocks``, the non-empty
#: blocks it weighed; ``records``, those it stored raw; ``encoded_bytes``,
#: their raw bytes, each encoded and serialized before the blob lost to
#: the raw bytes.  Always on; `reset_stored`.
STORED = {"blocks": 0, "records": 0, "encoded_bytes": 0}


def reset_stored() -> None:
    """Zero `STORED`."""
    for key in STORED:
        STORED[key] = 0


def record(raw: bytes, pos: int, raw_len: int, blob: bytes) -> tuple[int, int, bytes]:
    """The record of the block ``raw[pos : pos + raw_len]`` whose HTP3 blob
    is ``blob``: the blob, or the raw bytes where the blob is not at least
    8 bytes smaller; counted in `STORED`."""
    if not raw_len:
        return (KIND_HUFF, 0, blob)
    STORED["blocks"] += 1
    if len(blob) < raw_len + 8:
        return (KIND_HUFF, raw_len, blob)
    with tracing.span("compress.stored"):
        STORED["records"] += 1
        STORED["encoded_bytes"] += raw_len
        return (KIND_STORED, raw_len, raw[pos : pos + raw_len])


def pack(records: list[tuple[int, int, bytes]], block_size: int) -> bytes:
    """records: (kind, raw_len, payload)."""
    out = bytearray(MAGIC + struct.pack("<IQ", block_size, sum(r[1] for r in records)))
    for kind, raw_len, payload in records:
        out += struct.pack("<IIB3x", len(payload), raw_len, kind)
        out += payload
    return bytes(out)


#: Device blocks kept in flight by the block pipelines below: 2 = double
#: buffering, block i+1's device work and copies run while block i is
#: serialized on the host.  Each 16 MiB block in flight holds ~48 MiB on
#: the card (its bytes and its (W, K) words) and ~32 MiB of pinned host
#: memory for its words.
PIPELINE_DEPTH = 2


def _chunks(raw: bytes, block_size: int):
    """(pos, raw_len, chunk) per block; one empty block for empty input."""
    n = len(raw)
    if n == 0:
        yield 0, 0, b""
        return
    for pos in range(0, n, block_size):
        chunk = raw[pos : pos + block_size]
        raw_len = len(chunk)
        if raw_len < block_size and n > block_size:
            chunk += b"\0" * (block_size - raw_len)
        yield pos, raw_len, chunk


def compress_blocks(raw: bytes, codec, block_size: int = DEFAULT_BLOCK) -> bytes:
    """Split, pad to uniform, compress each block with stored fallback,
    and append the crc trailer.

    A codec with ``encode_device`` and ``serialize`` is pipelined: block
    i+1 is uploaded, encoded and staged for its copy back
    (``TorchCompressed.stage``) before block i is serialized, with at most
    `PIPELINE_DEPTH` blocks in flight.  Any other codec compresses block
    by block through ``_compress_blob`` (or ``compress``)."""
    records = []
    enc = getattr(codec, "encode_device", None)
    ser = getattr(codec, "serialize", None)
    piped = enc is not None and ser is not None

    def finish(pos, raw_len, comp_or_blob):
        records.append(record(raw, pos, raw_len, ser(comp_or_blob) if piped else comp_or_blob))

    if piped:
        pending = []  # (pos, raw_len, staged block), oldest first
        for pos, raw_len, chunk in _chunks(raw, block_size):
            if raw_len:
                pending.append((pos, raw_len, enc(codec.upload(chunk)).stage()))
            else:
                records.append((KIND_HUFF, 0, b""))
            while len(pending) >= PIPELINE_DEPTH:
                finish(*pending.pop(0))
        while pending:
            finish(*pending.pop(0))
    else:
        one = getattr(codec, "_compress_blob", codec.compress)
        for pos, raw_len, chunk in _chunks(raw, block_size):
            finish(pos, raw_len, one(chunk) if raw_len else b"")
    records.append(crc_record(raw))
    return pack(records, block_size)


def crc_record(raw: bytes) -> tuple[int, int, bytes]:
    """The integrity trailer: the crc32 of the whole raw content."""
    return (KIND_CRC, 0, struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF))


def check_crc(records, out: bytes) -> None:
    """Check the 'C' trailer, where there is one, against the decoded
    ``out``; raises ValueError on a mismatch."""
    for kind, _kx, _rl, rec in records:
        if kind == KIND_CRC and len(rec) == 4:
            want = struct.unpack("<I", rec)[0]
            got = zlib.crc32(out) & 0xFFFFFFFF
            if got != want:
                raise ValueError(
                    f"container crc mismatch: content crc {got:#010x} != "
                    f"stored {want:#010x} (corrupt payload)"
                )


def parse_records(data: bytes):
    """(block_size, total_raw, [(kind, extra, raw_len, payload)])."""
    buf = memoryview(data)
    if len(buf) < 16 or bytes(buf[:4]) != MAGIC:
        raise ValueError("not a huffman_tpu container (bad magic)")
    block_size, total_raw = struct.unpack_from("<IQ", buf, 4)
    pos = 16
    records = []
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError("truncated container (record header)")
        rec_len, raw_len, kind, kx = struct.unpack_from("<IIBHx", buf, pos)
        pos += 12
        if pos + rec_len > len(buf):
            raise ValueError("truncated container (record payload)")
        records.append((kind, kx, raw_len, bytes(buf[pos : pos + rec_len])))
        pos += rec_len
    return block_size, total_raw, records


def decode_record(kind: int, kx: int, raw_len: int, rec: bytes, codec) -> bytes:
    """The raw bytes of one record ('H' records through ``codec``, which
    may be None for a container of 'R' and 'S' records)."""
    if kind == KIND_STORED:
        if len(rec) != raw_len:
            raise ValueError("stored record length mismatch")
        return rec
    if kind == KIND_CRC or raw_len == 0:
        return b""
    if kind == KIND_HUFF:
        if codec is None:
            raise ValueError("container holds tpu-profile records; a device codec is required")
        return codec.decompress(rec)[:raw_len]
    if kind == KIND_REF:
        if not (1 <= kx <= 0xFFFF):
            raise ValueError("ref record missing stream count")
        return native.decompress(rec, kx, raw_len)[:raw_len]
    raise ValueError(f"unknown record kind {kind:#x}")


def decompress_blocks(data: bytes, codec) -> bytes:
    """Inverse of `compress_blocks`; checks the total size and the crc
    trailer when there is one.

    With a codec that has ``decode_device`` and ``deserialize``, each 'H'
    record is parsed, uploaded and its decode queued up to
    `PIPELINE_DEPTH` ahead of reading the oldest output back; a record of
    another kind first flushes the blocks in flight, so bytes stay in
    record order."""
    _, total_raw, records = parse_records(data)
    dec = getattr(codec, "decode_device", None) if codec is not None else None
    des = getattr(codec, "deserialize", None) if codec is not None else None
    out = []
    if dec is not None and des is not None:
        live = []  # (queued host copy of a block's output, raw_len), oldest first

        def flush_one():
            host, raw_len = live.pop(0)
            out.append(host.wait()[0][:raw_len].tobytes())

        for kind, kx, raw_len, rec in records:
            if kind == KIND_HUFF and raw_len:
                live.append((HostCopy(dec(des(rec))), raw_len))
                while len(live) >= PIPELINE_DEPTH:
                    flush_one()
            else:
                while live:
                    flush_one()
                out.append(decode_record(kind, kx, raw_len, rec, codec))
        while live:
            flush_one()
    else:
        out = [decode_record(kind, kx, raw_len, rec, codec) for kind, kx, raw_len, rec in records]
    result = b"".join(out)
    if len(result) != total_raw:
        raise ValueError(f"container truncated: decoded {len(result)} of {total_raw} bytes")
    check_crc(records, result)
    return result
