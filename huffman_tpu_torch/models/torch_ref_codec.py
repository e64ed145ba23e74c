"""The ``ref`` profile in PyTorch: the reference's K-stream wire format
(one shared 12-bit table, one backward stream region per slice,
cumulative end offsets), blobs byte-identical to
``huffman_tpu.models.jax_codec.JaxCodec``, ``golden`` and ``native``.

Slice i of the input is lane i; the first ``n % k`` slices take one byte
more (`format.slice_sizes`).  On a CUDA device every per-byte step runs
there (`encode_device` / `decode_device`, between the bytes API's copies):

* compress: one copy of the bytes to the device; their 256-bin count
  (``hist256``); the table on the host (`coding.make_canonical_coding`,
  as in the JAX codec); the (s, k) lane-major layout from two transposed
  views of the bytes; ``encode_lanes`` with each lane's row count; the
  backward regions as one masked select over the lanes' forward stream
  bytes, lanes in reverse order, then a flip; one copy of the payload
  back.
* decompress: the header on the host; one copy of the payload to the
  device; the forward (W, k) lane words by the inverse masked scatter;
  ``decode_lanes`` with the canonical-boundary constants of the coding;
  slice order from two transposed views; one copy back.

Inputs with n = 0, n < 4k or n > 4096k (too short for the device, or
slices so long that k lanes leave the card idle) go through the host
library (`native`) both ways, as the JAX codec sends them; no other
branch leaves the device.  On the CPU the kernels' plain versions run.

`COUNTS` keeps, for each side of the device path (``compress``: each
`encode_device` call and the copy back of its payload; ``decompress``:
each `decode_device` call and the copy back of its bytes), its
``calls``, its ``waits`` (sites where the host blocks on the device: a
``.cpu()``, or a boolean-mask select or ``index_put``, which syncs for
its element count) and, on the compress side, ``table_ns``, the host
nanoseconds of the 12-bit table build.  The host library's calls count
nothing.  The counters are always on.  Under the span recorder
(`tracing`), ``ref.compress`` and ``ref.decompress`` split into the
stages the methods name.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import coding, format as fmt, native, tracing
from ..constants import MAX_CODE_LEN, STREAM_SLOP
from ..ops import tables
from ..ops.decode_bits import decode_lanes, decode_tables_bitserial
from ..ops.encode import encode_lanes
from ..ops.lookup import histogram256

#: Per side of the device path: calls, host waits on the device, and
#: (compress) the table build's host ns.  Read by the benchmark;
#: `reset_counts`.
COUNTS = {m: {"calls": 0, "waits": 0, "table_ns": 0} for m in ("compress", "decompress")}


def reset_counts() -> None:
    """Zero `COUNTS`."""
    for c in COUNTS.values():
        for key in c:
            c[key] = 0


def device_path(n: int, k: int) -> bool:
    """Whether a block of n bytes at k streams takes the device (else
    the host library)."""
    return 4 * k <= n <= 4096 * k


def lane_layout(data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (s, k) lane-major matrix of a (n,) uint8 tensor, slice i of
    `format.slice_sizes` in column i (a zero row below the short slices
    when n % k > 0), and the slice sizes as (k,) int32: two transposed
    views of the bytes, no index tensor."""
    n = data.shape[0]
    b, r = divmod(n, k)
    s = b + (r > 0)
    lanes = torch.empty((s, k), dtype=torch.uint8, device=data.device)
    if r:
        lanes[:, :r] = data[: r * (b + 1)].view(r, b + 1).t()
        lanes[b, r:] = 0
    lanes[:b, r:] = data[r * (b + 1) :].view(k - r, b).t()
    sizes = torch.full((k,), b, dtype=torch.int32, device=data.device)
    sizes[:r] += 1
    return lanes, sizes


def slice_order(out: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bytes in slice order from the (s, k) lane-major matrix."""
    k = out.shape[1]
    b, r = divmod(n, k)
    return torch.cat([out[:, :r].t().reshape(-1), out[:b, r:].t().reshape(-1)])


class TorchRefCodec:
    """K-stream ``ref``-profile codec on one device."""

    def __init__(self, k: int, *, device):
        """Args:
          k: the stream count, which the blob does not record.
          device: where the per-byte steps run ("cpu", "cuda", ...).
        """
        self.k = k
        self.device = torch.device(device)

    @property
    def name(self) -> str:
        return f"Torch<{self.k}>"

    def encode_device(self, data: torch.Tensor) -> tuple[bytes, torch.Tensor]:
        """The blob of a (n,) uint8 tensor, 4k <= n <= 4096k, as its header
        and its payload, which stays on the tensor's device."""
        n, k = int(data.shape[0]), self.k
        if data.dtype != torch.uint8 or data.dim() != 1 or not device_path(n, k):
            raise ValueError(f"expected a (n,) uint8 tensor, {4 * k} <= n <= {4096 * k}")
        dev = data.device
        c = COUNTS["compress"]
        c["calls"] += 1
        with tracing.span("ref.compress.hist"):
            hist = histogram256(data).cpu().numpy()
            c["waits"] += 1
        with tracing.span("ref.compress.table"):
            t0 = time.perf_counter_ns()
            cc = coding.make_canonical_coding(hist)
            enc = torch.from_numpy(tables.pack_encode_table(cc).astype(np.int32))
            c["table_ns"] += time.perf_counter_ns() - t0
        with tracing.span("ref.compress.encode"):
            lanes, sizes = lane_layout(data, k)
            s = lanes.shape[0]
            # Two rows past the longest lane's words, so every lane's bytes
            # reach past its 8 slop bytes.
            w32 = (s * MAX_CODE_LEN + 31) // 32 + 2
            words, bits = encode_lanes(lanes.view(-1), enc.to(dev), s, k, w32, lane_rows=sizes)
            bits_np = bits.cpu().numpy().astype(np.int64)
            c["waits"] += 1
        with tracing.span("ref.compress.regions"):
            end_offsets = np.cumsum(fmt.stream_region_sizes(bits_np))
            header = fmt.write_header(n, cc.len_count, cc.len_mask, cc.sorted_syms, end_offsets)

            # Read backward, the payload is the lanes in reverse order, each
            # lane's forward stream bytes and then its zero slop.  The lanes'
            # bytes: each u32 word's bytes big-endian, zero past the stream.
            width = (int(bits_np.max()) + 7) // 8 + STREAM_SLOP
            rev = words.t().flip(0).contiguous().view(torch.uint8).view(k, w32, 4).flip(2)
            rev = rev.reshape(k, 4 * w32)[:, :width]
            region = ((bits.flip(0) + 7) // 8 + STREAM_SLOP).unsqueeze(1)
            keep = torch.arange(width, device=dev) < region
            payload = rev[keep].flip(0)
            c["waits"] += 1
        return header, payload

    def decode_device(self, h: fmt.ParsedHeader, payload: torch.Tensor) -> torch.Tensor:
        """The raw bytes of a parsed blob of at least two symbols whose
        size takes the device path, from its payload as a (m,) uint8
        tensor: (raw_size,) uint8 on the payload's device."""
        n, k = h.raw_size, self.k
        if h.num_syms < 2 or not device_path(n, k):
            raise ValueError("the blob does not take the device path")
        dev = payload.device
        c = COUNTS["decompress"]
        c["calls"] += 1
        with tracing.span("ref.decompress.scatter"):
            region = np.diff(h.end_offsets, prepend=0)
            w = max(-(-(int(region.max()) - STREAM_SLOP) // 4), 1)
            width = max(int(region.max()), 4 * w)
            # The inverse of encode_device's select, lanes in reverse order;
            # then each lane's slop (the region's low bytes, never read) zeroed.
            region_rev = torch.from_numpy(region[::-1].copy()).to(dev).unsqueeze(1)
            cols = torch.arange(width, device=dev)
            rev = torch.zeros((k, width), dtype=torch.uint8, device=dev)
            rev[cols < region_rev] = payload.flip(0)
            c["waits"] += 1
            fwd = torch.where(cols[: 4 * w] < region_rev - STREAM_SLOP, rev[:, : 4 * w], 0)
            words = fwd.flip(0).view(k, w, 4).flip(2).contiguous().view(torch.int32)
            words = words.view(k, w).t().contiguous()
        with tracing.span("ref.decompress.tables"):
            t = decode_tables_bitserial(h.len_count, h.sorted_syms)
            e_bound, g_rank, syms = (
                torch.from_numpy(t[key].astype(np.int32)).to(dev)
                for key in ("e_bound", "g_rank", "syms")
            )
        with tracing.span("ref.decompress.decode"):
            out = decode_lanes(words, e_bound, g_rank, syms, -(-n // k))
        with tracing.span("ref.decompress.order"):
            return slice_order(out, n)

    def compress(self, raw: bytes) -> bytes:
        if not device_path(len(raw), self.k):
            return native.compress(raw, self.k)
        with tracing.span("ref.compress"):
            with tracing.span("ref.compress.upload"):
                data = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy()).to(self.device)
            header, payload = self.encode_device(data)
            with tracing.span("ref.compress.download"):
                blob = header + payload.cpu().numpy().tobytes()
                COUNTS["compress"]["waits"] += 1
            return blob

    def decompress(self, blob: bytes) -> bytes:
        k = self.k
        with tracing.span("ref.decompress"):
            with tracing.span("ref.decompress.parse"):
                h = fmt.parse_header(blob, k)
            n = h.raw_size
            if n == 0:
                return b""
            if not device_path(n, k):
                return native.decompress(bytes(blob), k, n)
            if h.num_syms <= 1:
                sym = int(h.sorted_syms[0]) if h.num_syms else 0
                return bytes([sym]) * n
            with tracing.span("ref.decompress.upload"):
                payload = torch.from_numpy(np.frombuffer(h.payload, dtype=np.uint8).copy())
                payload = payload.to(self.device)
            out = self.decode_device(h, payload)
            with tracing.span("ref.decompress.download"):
                raw = out.cpu().numpy().tobytes()
                COUNTS["decompress"]["waits"] += 1
            return raw
