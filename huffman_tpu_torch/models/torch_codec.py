"""The ``tpu``-profile codec in PyTorch: large-K lane-transposed payload,
HTP3 blobs byte-identical to ``huffman_tpu.models.tpu_codec.TpuCodec``.

Compress: pad the block to ``s*k`` bytes, histogram (a strided 1-in-32
row sample at 4 MiB and up), build the canonical table, encode the k
lanes (byte ``i`` goes to lane ``i % k``) into a (w32, k) matrix of u32
words.  Decompress: decode ``s`` symbols per lane and flatten.  The
batched device API (`TorchCodec.encode_batch` / `decode_batch`) does the
same for B equal-size blocks at once, each with its own table built from
every byte.  On CUDA tensors each step is one hand-written kernel
(``ops/``) for the whole batch, and every C call goes through
`ops._cuda.launch`: a compress whose table comes from its own bytes
queues its three kernels by one C call (`ops.encode_chain`), and a
block's decode is one C call after one pass of checks
(`ops.decode_bits.decode_block`, the one route of a single block on a
card); on CPU tensors their plain PyTorch versions run.

The serialized layout is the one documented at the top of
``huffman_tpu/models/tpu_codec.py`` (compact, huff-counts and legacy
payloads).  Three deliberate differences from that writer and parser,
none of which changes any blob it writes or reads back:

* the entropy-coded counts blob is built only when ``counts`` is
  ``"auto"`` or ``"huff"``;
* a bit-count delta wider than 24 bits, which the parser rejects, raises
  ``ValueError`` in `serialize` instead of producing an unreadable blob;
* `deserialize` raises ``ValueError`` for a raw size that needs more
  symbols a lane than the longest lane's bits hold at the shortest code
  length; there the JAX package's decode raises ``TypeError`` (or, near
  the bound, returns bytes from the zeros past the lanes' words).

While the recorder of host spans (`tracing`) is on, each device-API
method, the batched statics copy, `TorchCodec.upload`, `serialize` (its
wait for the block's copies, the lane-byte transpose, the count encoding
and bit pack) and `deserialize` (the count decoding and bit unpack, the
upload of words and tables) is a span.  A block that `compress` stores
raw is counted in ``container.STORED`` and spanned ``compress.stored``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from .. import coding, container, native, tracing
from ..constants import NUM_SYMBOLS
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from ..ops import _cuda
from ..ops.decode_bits import (
    decode_block,
    decode_lanes,
    decode_lanes_batch,
    decode_tables_bitserial,
)
from ..ops.encode import encode_lanes
from ..ops.encode_chain import encode_block, encode_pages
from ..ops.lookup import histogram256
from ..ops.table_build import build_coding_device
from ..staging import HostCopy, PinnedRing

MAGIC = 0x48545033  # 'HTP3'
#: Header flag (top byte of the len_mask word): compact bit counts and a
#: bit-granular payload.  Bit 24 is the legacy wide-counts flag.
FLAG_COMPACT = 1 << 25
#: With FLAG_COMPACT: the count deltas ride as a ref-profile blob plus
#: raw escapes.
FLAG_HUFF_COUNTS = 1 << 26
#: Stream count of the embedded counts blob.
_HUFF_COUNTS_STREAMS = 8
#: The parser's limit on the bit-count delta width.
_MAX_DELTA_WIDTH = 24

#: Blocks of at least this many bytes pick their table from a sample of
#: every 32nd 512-byte row (`ops.lookup.table_hist`).
_HIST_SAMPLE_MIN = 4 << 20
_HIST_SAMPLE_STRIDE = 32


def _pack_lane_bits(lane_bytes: np.ndarray, bits: np.ndarray) -> bytes:
    """NumPy form of `native.pack_lane_bits`: lane k's first ``bits[k]``
    bits (MSB-first) of each row, concatenated with no byte rounding."""
    k, nb = lane_bytes.shape
    bits = bits.astype(np.int64)
    off = np.zeros(k, np.int64)
    np.cumsum(bits[:-1], out=off[1:])
    total = int(off[-1] + bits[-1]) if k else 0
    if total == 0:
        return b""
    # Zero every bit past bits_k, then shift each lane right by its output
    # bit phase; the bytes a lane owns alone tile the output in order and
    # the shared boundary bytes are OR-ed on top.
    nbytes = (bits + 7) >> 3
    rem = (bits & 7).astype(np.uint16)
    j = np.arange(nb, dtype=np.int64)[None, :]
    b = np.where(j < nbytes[:, None], lane_bytes, 0).astype(np.uint16)
    tail_mask = ((0xFF00 >> rem) & 0xFF).astype(np.uint16)
    b[np.arange(k), np.maximum(nbytes - 1, 0)] &= np.where(rem > 0, tail_mask, 0xFF)
    s = (off & 7).astype(np.uint16)
    start = off >> 3
    zlen = np.where(bits > 0, (bits + s + 7) >> 3, 0)
    bp = np.zeros((k, nb + 2), np.uint16)
    bp[:, 1 : nb + 1] = b
    z = (((bp[:, :-1] << 8) | bp[:, 1:]) >> s[:, None]).astype(np.uint8)
    jz = np.arange(nb + 1, dtype=np.int64)[None, :]
    shared = (s > 0) & (bits > 0)
    out = z[(jz >= shared[:, None]) & (jz < zlen[:, None])]
    np.bitwise_or.at(out, start[shared], z[shared, 0])
    return out.tobytes()


def _unpack_lane_bits(stream: np.ndarray, bits: np.ndarray, nb_out: int) -> np.ndarray:
    """NumPy form of `native.unpack_lane_bits`: (k, nb_out) uint8 rows,
    zero past each lane's bits."""
    k = bits.shape[0]
    bits = bits.astype(np.int64)
    off = np.zeros(k, np.int64)
    np.cumsum(bits[:-1], out=off[1:])
    s = (off & 7).astype(np.uint16)
    start = off >> 3
    nbytes = (bits + 7) >> 3
    cols = int(nbytes.max(initial=0)) + 1
    padded = np.zeros(int(start.max(initial=0)) + cols + 1, np.uint8)
    padded[: stream.shape[0]] = stream[: padded.shape[0]]
    z = padded[start[:, None] + np.arange(cols, dtype=np.int64)[None, :]].astype(np.uint16)
    grid = ((((z[:, :-1] << 8) | z[:, 1:]) >> (8 - s)[:, None]) & 0xFF).astype(np.uint8)
    lane_bytes = np.zeros((k, nb_out), np.uint8)
    valid = np.arange(cols - 1, dtype=np.int64)[None, :] < nbytes[:, None]
    lane_bytes[:, : cols - 1] = np.where(valid, grid, 0)
    rem = (bits & 7).astype(np.uint16)
    tail_mask = ((0xFF00 >> rem) & 0xFF).astype(np.uint8)
    last = np.minimum(np.maximum(nbytes - 1, 0), nb_out - 1)
    lane_bytes[np.arange(k), last] &= np.where(
        (rem > 0) & (bits > 0), tail_mask, 0xFF
    ).astype(np.uint8)
    return lane_bytes


def default_lanes(n: int) -> int:
    """Lane count: ~128 bytes per lane, a power of two in [8, 2**17], and
    at least 1024 from 64 KiB up.  Fixes K and so the blob's bytes."""
    if n <= 0:
        return 8
    k = 1 << max(3, min(17, (-(-n // 128)).bit_length() - 1))
    if k < 1024 and n >= 64 << 10:
        k = 1024
    return k


def decode_statics(m: dict, s: int) -> int:
    """The scan word count w of a block's decode, from its `meta` and
    its ``s`` symbols a lane, as ``TpuCodec``'s ``decode_statics``
    derives it: the words its longest lane fills, rounded up to an even
    count and capped at the encode's W.  Of the statics that function
    returns, only w changes what the card's decode reads (its first w
    rows of words); the others shape the TPU kernel alone."""
    w = (m["max_bits"] + 31) // 32
    return min(-(-w // 2) * 2, (s * MAX_CODE_LEN + 31) // 32 + 1)


@dataclasses.dataclass
class TorchCompressed:
    """A compressed block in device memory."""

    words: torch.Tensor  # (W, K) int32: u32 lane words, word w of lane k at [w, k]
    bit_counts: torch.Tensor  # (K,) int32
    raw_size: int
    k: int
    tables: dict  # coding tensors (ops.table_build.build_coding_device keys)
    _meta: dict | None = None
    _host: HostCopy | None = None  # once staged: packed metadata, bit counts, words

    def _packed_meta(self) -> torch.Tensor:
        t = self.tables
        return torch.cat(
            [
                self.bit_counts.max().view(1).to(torch.int32),
                t["num_syms"].view(1).to(torch.int32),
                t["len_count"].to(torch.int32),
                t["sorted_syms"].to(torch.int32),
            ]
        )

    def stage(self) -> TorchCompressed:
        """Queue the copies of the block's metadata, bit counts and words
        to pinned host memory, with an event after them (`staging`), and
        return the block.  The block pipeline calls it right after the
        block's kernels, before the next block's are queued, so `meta` and
        `TorchCodec.serialize` then wait for this block alone."""
        if self._host is None:
            self._host = HostCopy(self._packed_meta(), self.bit_counts, self.words)
        return self

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(bit counts (K,), words (W, K)) int32 on the host, staged
        first if they were not."""
        _, bits, words = self.stage()._host.wait()
        return bits, words

    def meta(self) -> dict:
        """Host metadata (max_bits, l_min, num_syms, len_count,
        sorted_syms), cached: from the staged copy, or else fetched alone
        in one device-to-host copy."""
        if self._meta is None:
            packed = (self._host or HostCopy(self._packed_meta())).wait()[0]
            lc = packed[2 : 2 + MAX_CODE_LEN + 1]
            nz = np.nonzero(lc[1:])[0]
            self._meta = {
                "max_bits": int(packed[0]),
                "l_min": int(nz[0]) + 1 if len(nz) else 1,
                "num_syms": int(packed[1]),
                "len_count": lc,
                "sorted_syms": packed[2 + MAX_CODE_LEN + 1 :],
            }
        return self._meta

    @property
    def coding(self) -> coding.CanonicalCoding:
        """The block's coding on the host, codes left-aligned in 15 bits
        (from `meta`)."""
        m = self.meta()
        num_syms = m["num_syms"]
        sorted_syms = m["sorted_syms"][:num_syms].astype(np.uint8)
        len_count = m["len_count"].astype(np.uint16)
        code_bits, code_lens = coding.assign_canonical_codes(
            len_count, sorted_syms, MAX_CODE_LEN
        )
        return coding.CanonicalCoding(
            code_bits=code_bits,
            code_lens=code_lens,
            sorted_syms=sorted_syms,
            len_count=len_count,
            len_mask=sum(1 << ln for ln in range(MAX_CODE_LEN + 1) if len_count[ln]),
            num_syms=num_syms,
            max_len=MAX_CODE_LEN,
        )


def _empty_tables(device) -> dict:
    z = lambda n: torch.zeros(n, dtype=torch.int32, device=device)  # noqa: E731
    return {
        "e_bound": z(MAX_CODE_LEN + 2),
        "g_rank": z(MAX_CODE_LEN + 1),
        "sorted_syms": z(NUM_SYMBOLS),
        "len_count": z(MAX_CODE_LEN + 1),
        "num_syms": torch.zeros((), dtype=torch.int32, device=device),
    }


class TorchCodec:
    """Large-K transposed-payload codec on one device."""

    #: Inputs above this go through the block container.
    block_bytes = 16 << 20

    def __init__(
        self, k: int | None = None, hist_stride: int | None = None, *, device
    ):
        """Args:
          k: lane count (None: `default_lanes` of the block size).
          hist_stride: table histogram sampling; None counts every byte
            below 4 MiB and every 32nd 512-byte row (+1 per bin) above.
          device: where blocks are encoded and decoded ("cpu", "cuda",
            "cuda:1", ...).
        """
        self.k = k
        self.hist_stride = hist_stride
        self.device = torch.device(device)
        # Host buffers of the uploads (`upload`, `deserialize`), one for
        # each block the container keeps in flight.
        self._uploads = PinnedRing(self.device, container.PIPELINE_DEPTH)

    def _hist_stride(self, n: int) -> int:
        if self.hist_stride is not None:
            return max(1, int(self.hist_stride))
        return _HIST_SAMPLE_STRIDE if n >= _HIST_SAMPLE_MIN else 1

    def _lanes(self, n: int) -> int:
        return self.k if self.k is not None else default_lanes(n)

    @property
    def name(self) -> str:
        return f"Torch<{self.k if self.k is not None else 'auto'}>"

    # ---------- device API ----------

    def upload(self, raw: bytes) -> torch.Tensor:
        """``raw`` as a (n,) uint8 tensor on the codec's device, copied
        through a pinned host buffer: on a card the copy is queued and the
        call returns without waiting for the stream."""
        with tracing.span("device_api.upload"):
            return self._uploads.upload(
                len(raw), lambda buf: np.copyto(buf, np.frombuffer(raw, dtype=np.uint8))
            )

    def build_tables(self, sample: torch.Tensor, full_alphabet: bool = True) -> dict:
        """A shared coding from sample bytes, for `encode_device(tables=)`.
        With ``full_alphabet`` every byte value gets a code."""
        hist = histogram256(sample.reshape(-1))
        return build_coding_device(hist + 1 if full_alphabet else hist)

    def encode_device(
        self, data: torch.Tensor, tables: dict | None = None
    ) -> TorchCompressed:
        """Compress a (n,) uint8 tensor on its device; the result stays there."""
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ValueError("expected a (n,) uint8 tensor")
        with tracing.span("device_api.encode_device"):
            n = int(data.shape[0])
            k = self._lanes(n)
            dev = data.device
            if n == 0:
                return TorchCompressed(
                    words=torch.zeros((1, k), dtype=torch.int32, device=dev),
                    bit_counts=torch.zeros(k, dtype=torch.int32, device=dev),
                    raw_size=0,
                    k=k,
                    tables=_empty_tables(dev),
                )
            s = -(-n // k)
            w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
            # A zero-width pad still copies the block: pad only a partial row.
            padded = data if s * k == n else torch.nn.functional.pad(data, (0, s * k - n))
            if tables is None:
                words, bit_counts, tables = encode_block(
                    padded, self._hist_stride(n), s, k, w32
                )
            else:
                words, bit_counts = encode_lanes(padded, tables["enc_table"], s, k, w32)
            return TorchCompressed(
                words=words, bit_counts=bit_counts, raw_size=n, k=k, tables=tables
            )

    def decode_device(self, comp: TorchCompressed) -> torch.Tensor:
        """Decompress to a (raw_size,) uint8 tensor on the block's device.
        The first call fetches the block's metadata (one copy, cached).

        A block on a card (its words or its tables there) takes
        `decode_block`: one pass of checks, one allocation, one C call; a
        malformed one raises ValueError before it.  Each call on a card
        counts in `_cuda.DECODE_PATHS`: "prepared" for that path,
        "checked" for an empty or one-symbol block."""
        with tracing.span("device_api.decode_device"):
            n, k, words = comp.raw_size, comp.k, comp.words
            m = comp.meta() if n else None
            if n == 0 or m["num_syms"] <= 1:
                if words.is_cuda:
                    _cuda.DECODE_PATHS["checked"] += 1
                if n == 0:
                    return torch.zeros(0, dtype=torch.uint8, device=words.device)
                sym = int(m["sorted_syms"][0]) if m["num_syms"] else 0
                return torch.full((n,), sym, dtype=torch.uint8, device=words.device)
            t = comp.tables
            e_bound, s = t["e_bound"], -(-n // k)
            if words.is_cuda or e_bound.is_cuda:
                out = decode_block(words, e_bound, t["g_rank"], t["sorted_syms"], k, s, n)
                _cuda.DECODE_PATHS["prepared"] += 1
                return out
            out = decode_lanes(words, e_bound, t["g_rank"], t["sorted_syms"], s)
            return out.reshape(-1)[:n]

    # ---------- batched device API ----------

    def encode_batch(self, blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """Compress B equal-size blocks at once, one table each.

        Args:
          blocks: (B, n_block) uint8, n_block a multiple of the lane count.
        Returns:
          (words (B, W, K) int32, bit_counts (B, K) int32, tables dict of
          the `build_coding_device` keys with a leading B), on the blocks'
          device; feed them to `decode_batch`.  Every byte is counted for
          the table (no row sample at any block size).
        """
        if blocks.dtype != torch.uint8 or blocks.dim() != 2 or 0 in blocks.shape:
            raise ValueError("expected a non-empty (B, n_block) uint8 tensor")
        with tracing.span("device_api.encode_batch"):
            nb = blocks.shape[1]
            k = self._lanes(nb)
            s = -(-nb // k)
            if s * k != nb:
                raise ValueError(f"block size {nb} is not a multiple of the lane count {k}")
            w32 = (s * MAX_CODE_LEN + 31) // 32 + 1
            return encode_pages(blocks, s, k, w32)

    def batch_decode_statics(
        self, words: torch.Tensor, bit_counts: torch.Tensor, tables: dict, n_block: int
    ) -> tuple[int, int, int]:
        """Host decode statics (group, w, blk) of a batch, derived as
        ``TpuCodec.batch_decode_statics`` derives them: the staging group
        from the batch's shortest code, w the words any lane needs rounded
        up to a multiple of 4 (at most W, at least 1), and blk 0 (the card
        has no grid-block choice).  One device-to-host copy; compute once
        and pass to repeated `decode_batch` calls.  Of the three, only w
        changes what `decode_batch` reads."""
        bcount, n_words, _ = words.shape
        with tracing.span("device_api.statics"):
            packed = torch.cat(
                [
                    bit_counts.max().view(1).to(torch.int32),
                    tables["len_count"].reshape(-1).to(torch.int32),
                ]
            ).cpu().numpy()
            nz = packed[1:].reshape(bcount, MAX_CODE_LEN + 1)[:, 1:] > 0
            l_min = min(int(np.argmax(row)) + 1 if row.any() else 1 for row in nz)
        group = max(g for g in (1, 2, 3, 4, 6, 8) if g <= max(1, l_min))
        w = (int(packed[0]) + 31) // 32
        w = max(min(-(-w // 4) * 4, n_words), 1)
        return group, w, 0

    def decode_batch(
        self,
        words: torch.Tensor,
        bit_counts: torch.Tensor,
        tables: dict,
        n_block: int,
        statics: tuple | None = None,
    ) -> torch.Tensor:
        """Inverse of `encode_batch`: (B, S, K) uint8 with S = n_block / K;
        block b is ``out[b].reshape(-1)`` (the strided lane map).
        ``statics`` from `batch_decode_statics` saves its host copy."""
        with tracing.span("device_api.decode_batch"):
            k = words.shape[2]
            if statics is None:
                statics = self.batch_decode_statics(words, bit_counts, tables, n_block)
            _, w, _ = statics
            return decode_lanes_batch(
                words, tables["e_bound"], tables["g_rank"], tables["sorted_syms"],
                -(-n_block // k), w,
            )

    # ---------- bytes API ----------

    def _compress_blob(self, raw: bytes) -> bytes:
        return self.serialize(self.encode_device(self.upload(raw)))

    def compress(self, raw: bytes) -> bytes:
        n = len(raw)
        if n > self.block_bytes:
            return container.compress_blocks(raw, self, self.block_bytes)
        rec = container.record(raw, 0, n, self._compress_blob(raw))
        if rec[0] == container.KIND_STORED:
            # Incompressible: a stored record.
            return container.pack([rec], self.block_bytes)
        return rec[2]

    def decompress(self, blob: bytes) -> bytes:
        if blob[:4] == container.MAGIC:
            return container.decompress_blocks(blob, self)
        return HostCopy(self.decode_device(self.deserialize(blob))).wait()[0].tobytes()

    # ---------- serialization ----------

    def serialize(
        self, comp: TorchCompressed, *, compact: bool = True, counts: str = "auto"
    ) -> bytes:
        """HTP3 bytes of a block.  ``compact=False`` writes the legacy
        layout; ``counts`` pins the compact count encoding: "auto" (the
        smaller of the two), "flat" or "huff"."""
        if counts not in ("auto", "flat", "huff"):
            raise ValueError(f"unknown counts encoding {counts!r}")
        with tracing.span("serialize"):
            return self._serialize(comp, compact, counts)

    def _serialize(self, comp: TorchCompressed, compact: bool, counts: str) -> bytes:
        with tracing.span("serialize.wait"):
            bits, words = comp.host_arrays()  # waits for this block's copies alone
        bits = bits.astype(np.int64)
        m = comp.meta()
        k = comp.k
        num_syms = m["num_syms"]
        len_count = m["len_count"]
        len_mask = sum(1 << ln for ln in range(MAX_CODE_LEN + 1) if len_count[ln])
        wide = (not compact) and bool(bits.max(initial=0) >= (1 << 16))
        flags = (int(wide) << 24) | (FLAG_COMPACT if compact else 0)
        out = bytearray(struct.pack("<IIII", MAGIC, comp.raw_size, k, len_mask | flags))
        out += bytes(int(c) & 0xFF for c in len_count if c)
        out += m["sorted_syms"][:num_syms].astype(np.uint8).tobytes()
        if num_syms <= 1:
            # Zero-length codes: bit counts and payload are implicit.
            return bytes(out)

        with tracing.span("serialize.transpose"):
            words = words.view(np.uint32)  # (W, K) lane words
            w = words.shape[0]
            lane_bytes = (
                np.ascontiguousarray(words.T).astype(">u4").view(np.uint8).reshape(k, 4 * w)
            )
        with tracing.span("serialize.pack"):
            if not compact:
                while len(out) % 2:
                    out.append(0)
                out += bits.astype("<u4" if wide else "<u2").tobytes()
                nbytes = (bits + 7) // 8
                mask = np.arange(4 * w, dtype=np.int64)[None, :] < nbytes[:, None]
                out += lane_bytes[mask].tobytes()
                return bytes(out)

            # Bit counts as base + fixed-width deltas, or (flag bit 26) the
            # delta bytes min(delta, 255) as a ref-profile blob plus raw
            # width-bit escapes, whichever is smaller under "auto".
            base = int(bits.min())
            deltas = bits - base
            width = int(deltas.max(initial=0)).bit_length()
            if width > _MAX_DELTA_WIDTH:
                raise ValueError(
                    f"bit-count delta width {width} exceeds {_MAX_DELTA_WIDTH}: "
                    "use fewer lanes or smaller blocks"
                )
            use_huff = False
            if counts != "flat":
                cblob = native.compress(
                    np.minimum(deltas, 255).astype(np.uint8).tobytes(), _HUFF_COUNTS_STREAMS
                )
                esc = deltas[deltas >= 255]
                esc_bytes = b""
                if len(esc) and width:
                    ebits = ((esc[:, None] >> np.arange(width - 1, -1, -1)) & 1).astype(np.uint8)
                    esc_bytes = np.packbits(ebits.reshape(-1)).tobytes()
                use_huff = counts == "huff" or 9 + len(cblob) + len(esc_bytes) < 5 + (
                    k * width + 7
                ) // 8
            if use_huff:
                struct.pack_into("<I", out, 12, len_mask | flags | FLAG_HUFF_COUNTS)
                out += struct.pack("<IBI", base, width, len(cblob))
                out += cblob
                out += esc_bytes
            else:
                out += struct.pack("<IB", base, width)
                if width:
                    dbits = ((deltas[:, None] >> np.arange(width - 1, -1, -1)) & 1).astype(np.uint8)
                    out += np.packbits(dbits.reshape(-1)).tobytes()
            out += native.pack_lane_bits(lane_bytes, bits)
        return bytes(out)

    def deserialize(self, blob: bytes) -> TorchCompressed:
        """Parse an HTP3 blob onto the codec's device.  Every structural
        field is checked; corrupt input raises ValueError."""
        with tracing.span("deserialize"):
            return self._deserialize(blob)

    def _deserialize(self, blob: bytes) -> TorchCompressed:
        buf = memoryview(blob)
        if len(buf) < 16:
            raise ValueError("blob too short for header")
        magic, raw_size, k, len_mask = struct.unpack_from("<IIII", buf, 0)
        if magic != MAGIC:
            raise ValueError("not a tpu-profile blob (bad magic)")
        flags = len_mask >> 24
        wide, compact, huff_counts = bool(flags & 1), bool(flags & 2), bool(flags & 4)
        if flags >> 3:
            raise ValueError(f"unknown header flags 0x{flags:02x}")
        if huff_counts and not compact:
            raise ValueError("huff-counts flag requires the compact layout")
        len_mask &= (1 << 24) - 1
        if not (1 <= k <= 1 << 22):
            raise ValueError(f"implausible lane count {k}")
        if len_mask >> (MAX_CODE_LEN + 1):
            raise ValueError("len_mask has lengths beyond MAX_CODE_LEN")
        pos = 16
        len_count = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
        one_size = bin(len_mask).count("1") == 1
        for ln in range(MAX_CODE_LEN + 1):
            if len_mask & (1 << ln):
                if pos >= len(buf):
                    raise ValueError("truncated length counts")
                c = buf[pos]
                pos += 1
                if c == 0 and not one_size:
                    raise ValueError("zero count for flagged length")
                len_count[ln] = 256 if c == 0 else c
        num_syms = int(len_count.sum())
        if num_syms > 256:
            raise ValueError(f"{num_syms} symbols > 256")
        if num_syms > 1:
            kraft = int((len_count << (MAX_CODE_LEN - np.arange(MAX_CODE_LEN + 1))).sum())
            if kraft != 1 << MAX_CODE_LEN:
                raise ValueError("length counts violate Kraft equality")
        if pos + num_syms > len(buf):
            raise ValueError("truncated symbol table")
        sorted_syms = np.frombuffer(buf[pos : pos + num_syms], dtype=np.uint8).copy()
        pos += num_syms
        if num_syms <= 1:
            return self._finish_deserialize(
                raw_size, k, len_count, sorted_syms, np.zeros(k, np.int64),
                np.zeros((k, 4), np.uint8),
            )
        with tracing.span("deserialize.unpack"):
            if huff_counts:
                if pos + 9 > len(buf):
                    raise ValueError("truncated huff-count header")
                base, width, clen = struct.unpack_from("<IBI", buf, pos)
                pos += 9
                if width > _MAX_DELTA_WIDTH:
                    raise ValueError(f"implausible bit-count delta width {width}")
                if clen > len(buf) - pos:
                    raise ValueError("truncated huff-count blob")
                d8 = np.frombuffer(
                    native.decompress(bytes(buf[pos : pos + clen]), _HUFF_COUNTS_STREAMS, k),
                    dtype=np.uint8,
                )
                pos += clen
                if len(d8) != k:
                    raise ValueError(f"huff-count blob decodes to {len(d8)} deltas, expected {k}")
                deltas = d8.astype(np.int64)
                n_esc = int((d8 == 255).sum())
                if n_esc:
                    if width < 8:
                        raise ValueError("escaped deltas need width >= 8")
                    nb = (n_esc * width + 7) // 8
                    if pos + nb > len(buf):
                        raise ValueError("truncated escape deltas")
                    e = np.unpackbits(
                        np.frombuffer(buf[pos : pos + nb], dtype=np.uint8), count=n_esc * width
                    )
                    deltas[d8 == 255] = (
                        e.reshape(n_esc, width).astype(np.int64) << np.arange(width - 1, -1, -1)
                    ).sum(axis=1)
                    pos += nb
                bits = base + deltas
            elif compact:
                if pos + 5 > len(buf):
                    raise ValueError("truncated compact bit counts")
                base, width = struct.unpack_from("<IB", buf, pos)
                pos += 5
                if width > _MAX_DELTA_WIDTH:
                    raise ValueError(f"implausible bit-count delta width {width}")
                bits = np.full(k, base, dtype=np.int64)
                if width:
                    nb = (k * width + 7) // 8
                    if pos + nb > len(buf):
                        raise ValueError("truncated bit-count deltas")
                    d = np.unpackbits(
                        np.frombuffer(buf[pos : pos + nb], dtype=np.uint8), count=k * width
                    )
                    bits += (
                        d.reshape(k, width).astype(np.int64) << np.arange(width - 1, -1, -1)
                    ).sum(axis=1)
                    pos += nb
            else:
                pos = (pos + 1) & ~1
                cw = 4 if wide else 2
                if pos + cw * k > len(buf):
                    raise ValueError("truncated bit counts")
                bits = np.frombuffer(
                    buf[pos : pos + cw * k], dtype="<u4" if wide else "<u2"
                ).astype(np.int64)
                pos += cw * k

            s = -(-raw_size // k) if raw_size else 0
            max_bits = int(bits.max(initial=0))
            if max_bits > max(s, 1) * MAX_CODE_LEN:
                raise ValueError("per-lane bit count exceeds slice capacity")
            # Every lane holds s codes of at least l_min bits (a partial last
            # row is padded), so the longest lane has at least s * l_min bits.
            # A raw size past that would decode rows of the zeros past the words.
            l_min = int(np.flatnonzero(len_count[1:])[0]) + 1
            if s * l_min > max_bits:
                raise ValueError(
                    f"raw size {raw_size} needs {s} symbols a lane, more than "
                    f"{max_bits} bits of {l_min}-bit or longer codes hold"
                )
            wmax = max((max_bits + 31) // 32, 1)
            if compact:
                if int(bits.sum()) > (len(buf) - pos) * 8:
                    raise ValueError("payload shorter than bit counts imply")
                stream = np.frombuffer(buf[pos:], dtype=np.uint8)
                lane_bytes = native.unpack_lane_bits(stream, bits, 4 * wmax)
            else:
                flat = np.frombuffer(buf[pos:], dtype=np.uint8)
                nbytes = (bits + 7) // 8
                if int(nbytes.sum()) > len(flat):
                    raise ValueError("payload shorter than bit counts imply")
                lane_bytes = np.zeros((k, 4 * wmax), dtype=np.uint8)
                mask = np.arange(4 * wmax, dtype=np.int64)[None, :] < nbytes[:, None]
                lane_bytes[mask] = flat[: int(nbytes.sum())]
        return self._finish_deserialize(
            raw_size, k, len_count, sorted_syms, bits, lane_bytes
        )

    def _finish_deserialize(
        self, raw_size, k, len_count, sorted_syms, bits, lane_bytes
    ) -> TorchCompressed:
        with tracing.span("deserialize.upload"):
            num_syms = len(sorted_syms)
            wmax = lane_bytes.shape[1] // 4
            t = decode_tables_bitserial(len_count, sorted_syms)
            # One upload of int32s: the (W, K) words, byte-swapped and
            # transposed straight into the staging buffer, then the bit counts
            # and the tables.
            parts = [bits, t["e_bound"], t["g_rank"], t["syms"], len_count, [num_syms]]
            offs = np.cumsum([0, wmax * k] + [len(p) for p in parts])

            def fill(buf):
                i32 = buf.view(np.int32)
                np.copyto(i32[: wmax * k].view(np.uint32).reshape(wmax, k), lane_bytes.view(">u4").T)
                for p, lo, hi in zip(parts, offs[1:], offs[2:]):
                    i32[lo:hi] = p

            flat = self._uploads.upload(int(offs[-1]) * 4, fill).view(torch.int32)
            piece = [flat[lo:hi] for lo, hi in zip(offs[:-1], offs[1:])]
            tables = {
                "e_bound": piece[2],
                "g_rank": piece[3],
                "sorted_syms": piece[4],
                "len_count": piece[5],
                "num_syms": piece[6][0],
            }
            meta = {
                "max_bits": int(bits.max()) if k else 0,
                "l_min": t["l_min"],
                "num_syms": num_syms,
                "len_count": len_count.astype(np.int32),
                "sorted_syms": t["syms"],
            }
            return TorchCompressed(
                words=piece[0].view(wmax, k),
                bit_counts=piece[1],
                raw_size=raw_size,
                k=k,
                tables=tables,
                _meta=meta,
            )
