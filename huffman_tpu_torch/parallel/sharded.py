"""Data/stream-parallel block codec over ``torch.distributed``.

Counterpart: ``huffman_tpu/parallel/sharded.py``, which runs one
``shard_map`` program over a ('data', 'stream') mesh of devices.  Here
the same step runs as SPMD, one process a rank, each on its own shard:

* ``data`` axis: independent blocks.  Data rank d owns a contiguous run
  of the (padded) blocks, as ``P('data', ...)`` splits them.
* ``stream`` axis: the K lanes of one block split over ranks.  Stream
  rank c owns lanes ``[c*k_local, (c+1)*k_local)``; its (B, s*k_local)
  bytes are the global strided subset that `ShardedCodec._permute_in`
  gives it, so its local lane streams equal the single-device lane map
  and the blobs are standard HTP3 blocks.  All shards of a block share
  one table: the (B, 256) histograms are all-reduced over ``stream``
  (exact counts, no sample, no +1) and every shard builds the same table.

A rank's step is one launch each of the batched kernels: hist256_batch,
table_build, encode_lanes and (to decode) decode_lanes (``ops/``).  Ranks
are laid out host-major, rank r at ``divmod(r, stream)``.  In a process
with no process group `make_mesh` gives a `LocalMesh` of one rank, and
the step runs with no collective.  On a card the codec selects its
device around each step: the kernels launch on the current device.

`COUNTS` keeps, for each of `ShardedCodec`'s ``compress``, ``decompress``
and ``roundtrip``, its ``calls``, the ``collectives`` they made on this
rank (each ``all_reduce``, ``all_gather`` and ``all_gather_object``; an
axis of size 1 makes none) and the ``gathered_bytes`` those delivered
here (a tensor collective's output bytes; an object gather's record
bytes).  The counters are always on.  Under the span recorder
(`tracing`), ``sharded.compress`` and ``sharded.decompress`` split into
the stages their methods name.
"""

from __future__ import annotations

import contextlib
import functools
import struct

import numpy as np
import torch
import torch.distributed as dist

from .. import container, tracing
from ..constants import TPU_MAX_CODE_LEN as MAX_CODE_LEN
from ..models.torch_codec import MAGIC, TorchCodec, TorchCompressed
from ..ops.decode_bits import decode_lanes_batch
from ..ops.encode import encode_lanes_batch
from ..ops.lookup import histogram256_batch
from ..ops.table_build import build_coding_device_batch

AXES = ("data", "stream")

#: Per `ShardedCodec` method: calls, collectives made on this rank, and
#: the bytes they delivered to it.  Read by the benchmark; `reset_counts`.
COUNTS = {m: {"calls": 0, "collectives": 0, "gathered_bytes": 0}
          for m in ("compress", "decompress", "roundtrip")}
#: The method whose collectives are being counted, or None (a step
#: function called on its own counts nothing).
_method: str | None = None


def reset_counts() -> None:
    """Zero `COUNTS`."""
    for c in COUNTS.values():
        for key in c:
            c[key] = 0


def _count(nbytes: int) -> None:
    """One collective that delivered ``nbytes`` to this rank."""
    if _method is not None:
        c = COUNTS[_method]
        c["collectives"] += 1
        c["gathered_bytes"] += nbytes


def _counted(method):
    """Count a call of a `ShardedCodec` method and the collectives it makes."""
    name = method.__name__

    @functools.wraps(method)
    def counted(self, *args, **kwargs):
        global _method
        COUNTS[name]["calls"] += 1
        outer, _method = _method, name
        try:
            return method(self, *args, **kwargs)
        finally:
            _method = outer

    return counted


class LocalMesh:
    """The mesh of a process with no process group: one rank at (0, 0),
    both axes of size 1, so no step makes a collective.  Answers the part
    of ``DeviceMesh`` that this module reads."""

    mesh_dim_names = AXES

    def size(self, mesh_dim: int | None = None) -> int:
        return 1

    def get_coordinate(self) -> list[int]:
        return [0, 0]


def make_mesh(stream: int = 1):
    """Mesh over every rank of the process group: ``data`` x ``stream``,
    rank r at ``(r // stream, r % stream)``.

    ``stream`` divides the world size; the rest goes to ``data``.  With
    no process group the world is this process: a `LocalMesh`.  The
    ``DeviceMesh`` is a "cuda" mesh where the group has an nccl backend,
    else a "cpu" one (gloo takes CUDA tensors as well).  Every rank must
    call it, as every rank makes each collective.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if stream < 1 or world % stream:
        raise ValueError(f"stream {stream} does not divide the world size {world}")
    if not dist.is_initialized():
        return LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    ranks = torch.arange(world).view(world // stream, stream)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """{'data': D, 'stream': C} of a mesh."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``t`` of every rank along mesh ``axis``, in coordinate order,
    joined on tensor dim ``dim``."""
    n = mesh_shape(mesh)[axis]
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    _count(n * t.numel() * t.element_size())
    return torch.cat(parts, dim=dim)


def _payload_bytes(x) -> int:
    """Bytes of the byte strings inside gathered objects."""
    if isinstance(x, (bytes, bytearray)):
        return len(x)
    if isinstance(x, (list, tuple)):
        return sum(_payload_bytes(y) for y in x)
    return 0


def _gather_objects(obj, mesh) -> list:
    """``obj`` of every rank of the mesh, in rank order."""
    out = [obj]
    for axis in ("stream", "data"):
        n = mesh_shape(mesh)[axis]
        if n > 1:
            got = [None] * n
            dist.all_gather_object(got, out, group=mesh.get_group(axis))
            _count(_payload_bytes(got))
            out = [x for part in got for x in part]
    return out


def _k_local(mesh, k: int) -> int:
    n = mesh_shape(mesh)["stream"]
    if k % n:
        raise ValueError(f"k={k} is not a multiple of the stream axis {n}")
    return k // n


def _encode_shard(blocks: torch.Tensor, mesh, k_local: int, s: int, w32: int):
    """One rank's (B, s*k_local) shard -> (words (B, w32, k_local),
    bit_counts (B, k_local), tables) with the table of the whole block:
    the shards' exact histograms summed over 'stream' (the distributed
    form of the reference's histogram merge, huffman.cpp:762-766)."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != s * k_local:
        raise ValueError(f"expected a (B, {s * k_local}) uint8 shard, got {tuple(blocks.shape)}")
    hist = histogram256_batch(blocks)
    if mesh_shape(mesh)["stream"] > 1:
        dist.all_reduce(hist, group=mesh.get_group("stream"))
        _count(hist.numel() * hist.element_size())
    tables = build_coding_device_batch(hist)
    words, bits = encode_lanes_batch(blocks, tables["enc_table"], s, k_local, w32)
    return words, bits, tables


def sharded_encode(data: torch.Tensor, *, mesh, k: int, s: int, w32: int):
    """This rank's compress step.

    Args:
      data: (B_local, s*k_local) uint8, this rank's shard (see the module).
      mesh: the ('data', 'stream') mesh; k % its stream size == 0.
      k: lanes of a whole block; s: bytes a lane.
      w32: payload words a lane, >= (s*15 + 31)//32 + 1 for any data.
    Returns:
      (words (B_local, w32, k_local) int32, bit_counts (B_local, k_local),
      len_count (B_local, 16), sorted_syms (B_local, 256), num_syms
      (B_local,)); the tables are the same on every stream rank.
    """
    words, bits, t = _encode_shard(data, mesh, _k_local(mesh, k), s, w32)
    return words, bits, t["len_count"], t["sorted_syms"], t["num_syms"]


def sharded_decode(
    words: torch.Tensor,
    e_bound: torch.Tensor,
    g_rank: torch.Tensor,
    syms: torch.Tensor,
    *,
    mesh,
    k: int,
    s: int,
    w: int,
) -> torch.Tensor:
    """This rank's decompress step: blocks over 'data', lanes over
    'stream'; no collective.

    Args:
      words: (B_local, W, k_local) int32 u32 patterns, of which the first
        ``w`` rows are read.
      e_bound/g_rank/syms: (B_local, 17/16/256) int32 decode constants,
        the same on every stream rank.
    Returns:
      (B_local, s*k_local) uint8 shard-local strided bytes.
    """
    k_local = _k_local(mesh, k)
    if words.dim() != 3 or words.shape[2] != k_local:
        raise ValueError(f"expected (B, W, {k_local}) words, got {tuple(words.shape)}")
    out = decode_lanes_batch(words, e_bound, g_rank, syms, s, max(w, 1))
    return out.reshape(words.shape[0], s * k_local)


def sharded_roundtrip(data: torch.Tensor, *, mesh, k: int, s: int, w32: int):
    """This rank's compress + decompress step.

    Args: as `sharded_encode`.
    Returns:
      (decoded (B_local, s*k_local) uint8, equal to ``data``; bit_counts
      (B_local, k_local) int32, exact compressed bits a lane; words
      (B_local, w32, k_local) int32).
    """
    k_local = _k_local(mesh, k)
    words, bits, t = _encode_shard(data, mesh, k_local, s, w32)
    out = decode_lanes_batch(words, t["e_bound"], t["g_rank"], t["sorted_syms"], s, w32)
    return out.reshape(data.shape[0], s * k_local), bits, words


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _huff_shape(rec: bytes) -> tuple[int, int, int] | None:
    """(raw_size, k, num_syms) from an HTP3 header, or None where the
    header is malformed (the single-block path then raises the parser's
    error)."""
    if len(rec) < 16:
        return None
    magic, raw_size, k, len_mask = struct.unpack_from("<IIII", rec)
    len_mask &= (1 << 24) - 1
    n_len = bin(len_mask).count("1")
    if magic != MAGIC or len_mask >> (MAX_CODE_LEN + 1) or len(rec) < 16 + n_len:
        return None
    return raw_size, k, sum(c or 256 for c in rec[16 : 16 + n_len])


class ShardedCodec:
    """Block-data-parallel codec over a mesh of ranks.

    Splits a byte stream into fixed-size blocks, pads their count to a
    multiple of the data axis, and runs the sharded step on each rank's
    shard.  `roundtrip`, `compress` and `decompress` return the same
    result on every rank; every rank passes the same input.  `compress`
    writes the HTPC container of ``TpuCodec`` / ``TorchCodec`` blocks
    (one HTP3 record a block, stored where that is smaller, the crc
    trailer); each rank serializes a share of the blocks and the records
    are gathered.
    """

    def __init__(self, mesh=None, block_bytes: int = 1 << 20, k: int = 4096, *, device):
        """Args:
          mesh: from `make_mesh` / `distributed.pod_mesh` (None: `make_mesh()`).
          block_bytes: block size, a multiple of ``k``.
          k: lanes a block.
          device: this rank's device ("cpu", "cuda", "cuda:1", ...).
        """
        if block_bytes % k:
            raise ValueError(f"block_bytes {block_bytes} is not a multiple of k={k}")
        self.mesh = mesh if mesh is not None else make_mesh()
        self.block_bytes = block_bytes
        self.k = k
        self.s = block_bytes // k
        self.w32 = (self.s * MAX_CODE_LEN + 31) // 32 + 1
        self.device = torch.device(device)
        shape = mesh_shape(self.mesh)
        self.n_data, self.n_stream = shape["data"], shape["stream"]
        self.k_local = _k_local(self.mesh, k)

    def _on_device(self):
        """The codec's card as the current device (the kernels and nccl
        work on the current device), or nothing off the card."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _n_padded(self, nb: int) -> int:
        """``nb`` blocks rounded up to whole blocks a data rank."""
        return -(-nb // self.n_data) * self.n_data

    def _permute_in(self, blocks):
        """(B, N) -> shard layout whose local strided framing equals the
        GLOBAL strided lane map: stream shard c's (s, k_local) cell (r, j),
        at columns ``[c*s*k_local, (c+1)*s*k_local)``, holds global byte
        r*k + c*k_local + j.  numpy arrays or tensors."""
        b, n = blocks.shape
        return blocks.reshape(b, self.s, self.n_stream, self.k_local).swapaxes(1, 2).reshape(b, n)

    def _permute_out(self, blocks):
        b, n = blocks.shape
        return blocks.reshape(b, self.n_stream, self.s, self.k_local).swapaxes(1, 2).reshape(b, n)

    def _local_blocks(self, padded: np.ndarray) -> torch.Tensor:
        """This rank's shard of the padded blocks on its device: its data
        rank's run of blocks, and of `_permute_in`'s layout the columns of
        its stream rank."""
        nb = padded.size // self.block_bytes
        bl = nb // self.n_data
        d, c = self.mesh.get_coordinate()
        shard = padded.reshape(nb, self.s, self.n_stream, self.k_local)[d * bl : (d + 1) * bl, :, c]
        return _upload(np.ascontiguousarray(shard).reshape(bl, -1), self.device)

    def _gather(self, t: torch.Tensor, lane_dim: int) -> torch.Tensor:
        """Every rank's (blocks, ..., lanes) shard joined into the global
        array: stream ranks' lanes on ``lane_dim``, data ranks' blocks on
        dim 0."""
        return _all_gather(_all_gather(t, self.mesh, "stream", lane_dim), self.mesh, "data", 0)

    def _padded(self, data: np.ndarray, nb: int) -> np.ndarray:
        padded = np.zeros(self._n_padded(nb) * self.block_bytes, np.uint8)
        padded[: data.shape[0]] = data
        return padded

    @_counted
    def roundtrip(self, data: np.ndarray):
        """Pad to whole blocks, run the sharded step, gather.

        Returns (decoded bytes (n,) uint8 numpy, bit_counts (B, k) int32,
        words (B, w32, k) int32 on the device), B the padded block count;
        bit counts and words are those of ``TorchCodec.encode_batch`` and
        ``TpuCodec``'s, whatever the mesh."""
        n = data.shape[0]
        padded = self._padded(data, -(-max(n, 1) // self.block_bytes))
        with self._on_device():
            out, bits, words = sharded_roundtrip(
                self._local_blocks(padded), mesh=self.mesh, k=self.k, s=self.s, w32=self.w32
            )
            out = self._permute_out(self._gather(out, 1))
            return out.cpu().numpy().reshape(-1)[:n], self._gather(bits, 1), self._gather(words, 2)

    # ---------- bytes API (standard HTP3 container) ----------

    @_counted
    def compress(self, raw: bytes) -> bytes:
        """The HTPC container of HTP3 blocks, byte-identical to the JAX
        package's ``ShardedCodec.compress``.  Every block is padded to
        ``block_bytes`` (``raw_size`` = block_bytes), an input shorter than
        one block too."""
        n, bb = len(raw), self.block_bytes
        if n == 0:
            return container.pack([(container.KIND_HUFF, 0, b""), container.crc_record(b"")], bb)
        nb = -(-n // bb)
        with tracing.span("sharded.compress"):
            with self._on_device():
                with tracing.span("sharded.compress.upload"):
                    local = self._local_blocks(self._padded(np.frombuffer(raw, np.uint8), nb))
                with tracing.span("sharded.compress.step"):
                    words, bits, lc, ss, ns = sharded_encode(
                        local, mesh=self.mesh, k=self.k, s=self.s, w32=self.w32
                    )
                with tracing.span("sharded.compress.gather"):
                    # The data row's blocks with all their lanes, on the host.
                    words = _all_gather(words, self.mesh, "stream", 2).cpu()
                    bits = _all_gather(bits, self.mesh, "stream", 1).cpu()
                    lc, ss, ns = lc.cpu(), ss.cpu(), ns.cpu()
                with tracing.span("sharded.compress.serialize"):
                    # Stream rank c serializes every n_stream-th block of its row.
                    d, c = self.mesh.get_coordinate()
                    bl = words.shape[0]
                    tc = TorchCodec(self.k, device="cpu")
                    mine = []
                    for j in range(c, min(bl, nb - d * bl), self.n_stream):
                        b = d * bl + j
                        raw_len = min(bb, n - b * bb)
                        comp = TorchCompressed(
                            words=words[j], bit_counts=bits[j], raw_size=bb, k=self.k,
                            tables={"len_count": lc[j], "sorted_syms": ss[j], "num_syms": ns[j]},
                        )
                        mine.append((b, container.record(raw, b * bb, raw_len, tc.serialize(comp))))
                with tracing.span("sharded.compress.gather_records"):
                    ranked = sorted((x for part in _gather_objects(mine, self.mesh) for x in part),
                                    key=lambda x: x[0])
            with tracing.span("sharded.compress.pack"):
                records = [rec for _, rec in ranked]
                records.append(container.crc_record(raw))
                return container.pack(records, bb)

    @_counted
    def decompress(self, blob: bytes) -> bytes:
        """Decode a block container: the HTP3 records of this codec's shape
        through one sharded step, stored / ref-profile / degenerate /
        foreign-shaped records record by record (`container.decode_record`
        and the single-block decode); the total length and the crc last."""
        with tracing.span("sharded.decompress"):
            with self._on_device():
                with tracing.span("sharded.decompress.parse"):
                    _bs, total_raw, records = container.parse_records(blob)
                    tc = TorchCodec(self.k, device=self.device)
                    outs: list[bytes | None] = [None] * len(records)
                    batch = []  # indices of the records of the sharded step
                    for i, (kind, kx, raw_len, rec) in enumerate(records):
                        if kind != container.KIND_HUFF or raw_len == 0:
                            outs[i] = container.decode_record(kind, kx, raw_len, rec, tc)
                            continue
                        shape = _huff_shape(rec)
                        if (shape is None or shape[:2] != (self.block_bytes, self.k)
                                or shape[2] <= 1):
                            # Degenerate or foreign-shaped block: single-block path.
                            comp = tc.deserialize(rec)
                            outs[i] = tc.decode_device(comp).cpu().numpy().tobytes()[:raw_len]
                        else:
                            batch.append(i)
                if batch:
                    dec = self._decode_records([records[i][3] for i in batch])
            with tracing.span("sharded.decompress.join"):
                for j, i in enumerate(batch):
                    outs[i] = dec[j].tobytes()[: records[i][2]]
                out = b"".join(o for o in outs if o is not None)
                if len(out) != total_raw:
                    raise ValueError(f"container truncated: decoded {len(out)} of {total_raw} bytes")
                container.check_crc(records, out)
                return out

    def _decode_records(self, recs: list[bytes]) -> np.ndarray:
        """(len(recs), block_bytes) uint8: HTP3 blobs of this codec's shape
        decoded by the sharded step.  Data rank d parses and decodes the
        d-th run of them (w, the words a lane reads, is its run's largest
        ceil(max_bits / 32): a larger w reads only zeros); a parse error on
        any rank raises on every rank."""
        bl = -(-len(recs) // self.n_data)
        d, c = self.mesh.get_coordinate()
        with tracing.span("sharded.decompress.deserialize"):
            host = TorchCodec(self.k, device="cpu")
            try:
                comps, err = [host.deserialize(r) for r in recs[d * bl : (d + 1) * bl]], None
            except ValueError as e:
                comps, err = [], str(e)
            errs = [e for e in _gather_objects(err, self.mesh) if e]
        if errs:
            raise ValueError(errs[0])
        kl = self.k_local
        with tracing.span("sharded.decompress.step"):
            local = torch.zeros((bl, self.s * kl), dtype=torch.uint8, device=self.device)
            if comps:
                w = max((cp.meta()["max_bits"] + 31) // 32 for cp in comps)
                words = torch.zeros((len(comps), max(w, 1), kl), dtype=torch.int32)
                for j, cp in enumerate(comps):
                    lanes = cp.words[:w, c * kl : (c + 1) * kl]
                    words[j, : lanes.shape[0]] = lanes
                tabs = [torch.stack([cp.tables[key] for cp in comps]).to(self.device)
                        for key in ("e_bound", "g_rank", "sorted_syms")]
                local[: len(comps)] = sharded_decode(
                    words.to(self.device), *tabs, mesh=self.mesh, k=self.k, s=self.s, w=w
                )
        with tracing.span("sharded.decompress.gather"):
            out = self._permute_out(self._gather(local, 1))
            return out[: len(recs)].cpu().numpy()
