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
"""

from __future__ import annotations

import struct
import zlib

from . import native

MAGIC = b"HTPC"
KIND_HUFF = 0x48  # 'H'
KIND_STORED = 0x53  # 'S'
KIND_REF = 0x52  # 'R'
KIND_CRC = 0x43  # 'C'

DEFAULT_BLOCK = 16 << 20


def pack(records: list[tuple[int, int, bytes]], block_size: int) -> bytes:
    """records: (kind, raw_len, payload)."""
    out = bytearray(MAGIC + struct.pack("<IQ", block_size, sum(r[1] for r in records)))
    for kind, raw_len, payload in records:
        out += struct.pack("<IIB3x", len(payload), raw_len, kind)
        out += payload
    return bytes(out)


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
    """Each block through ``codec._compress_blob``, with stored fallback
    and the crc trailer."""
    records = []
    for pos, raw_len, chunk in _chunks(raw, block_size):
        blob = codec._compress_blob(chunk) if raw_len else b""
        if raw_len and len(blob) >= raw_len + 8:
            records.append((KIND_STORED, raw_len, raw[pos : pos + raw_len]))
        else:
            records.append((KIND_HUFF, raw_len, blob))
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
    trailer when there is one."""
    _, total_raw, records = parse_records(data)
    out = b"".join(decode_record(kind, kx, rl, rec, codec) for kind, kx, rl, rec in records)
    if len(out) != total_raw:
        raise ValueError(f"container truncated: decoded {len(out)} of {total_raw} bytes")
    check_crc(records, out)
    return out
