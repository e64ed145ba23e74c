"""The port's block pipeline (``huffman_tpu_torch.container``) against the
JAX package's: the same container bytes at PIPELINE_DEPTH 2 and 1, each
package decoding the other's; the order of the pipeline's calls, shown by
a codec that logs them (block i+1 queued before block i is serialized or
read, at most PIPELINE_DEPTH blocks in flight, stored and 'R' records
flushing the blocks in flight); edge inputs; and the staging buffers.
The port runs on the CPU.
"""

import struct

import numpy as np
import pytest
import torch

from huffman_tpu import container as jcontainer
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu_torch import TorchCodec, container, native, staging
from huffman_tpu_torch.models.torch_codec import TorchCompressed

torch.set_num_threads(2)

BS = 64 << 10
K = 64


def _biased(rng, n):
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    return rng.choice(256, size=n, p=p).astype(np.uint8).tobytes()


@pytest.fixture(scope="module")
def raw():
    """tests/test_container.py's pipeline input: five 64 KiB blocks, block
    2 incompressible (stored), a ragged final block."""
    rng = np.random.default_rng(3)
    parts = []
    for i in range(5):
        if i == 2:
            parts.append(rng.integers(0, 256, BS, dtype=np.uint8).tobytes())
        else:
            parts.append(_biased(rng, BS))
    return b"".join(parts)[: 4 * BS + 1234]


@pytest.fixture(scope="module")
def jax_blob(raw):
    return jcontainer.compress_blocks(raw, TpuCodec(K), BS)


@pytest.mark.parametrize("depth", [2, 1])
def test_pipeline_bytes_equal_jax(depth, raw, jax_blob, monkeypatch):
    monkeypatch.setattr(container, "PIPELINE_DEPTH", depth)
    codec = TorchCodec(K, device="cpu")
    blob = container.compress_blocks(raw, codec, BS)
    assert blob == jax_blob
    kinds = [kind for kind, _, rl, _ in container.parse_records(blob)[2] if rl]
    assert container.KIND_STORED in kinds and container.KIND_HUFF in kinds
    assert container.decompress_blocks(jax_blob, codec) == raw


def test_jax_decompresses_the_ports_container(raw):
    blob = container.compress_blocks(raw, TorchCodec(K, device="cpu"), BS)
    assert jcontainer.decompress_blocks(blob, TpuCodec(K)) == raw


@pytest.mark.parametrize("n", [0, 1, BS], ids=["empty", "one byte", "one block"])
def test_edge_inputs_equal_jax(n, raw):
    data = raw[:n]
    codec = TorchCodec(K, device="cpu")
    blob = container.compress_blocks(data, codec, BS)
    assert blob == jcontainer.compress_blocks(data, TpuCodec(K), BS)
    assert container.decompress_blocks(blob, codec) == data


class Recording:
    """TorchCodec(K) on the CPU, logging the calls the container makes and
    the blocks in flight (encoded, not yet serialized)."""

    def __init__(self):
        self.codec = TorchCodec(K, device="cpu")
        self.log = []
        self.index = {}  # id(block) -> its index
        self.encoded = self.serialized = self.in_flight = 0

    def upload(self, raw):
        return self.codec.upload(raw)

    def encode_device(self, x):
        comp = self.codec.encode_device(x)
        self.index[id(comp)] = self.encoded
        self.log.append(("encode", self.encoded))
        self.encoded += 1
        self.in_flight = max(self.in_flight, self.encoded - self.serialized)
        return comp

    def serialize(self, comp):
        self.log.append(("serialize", self.index[id(comp)]))
        self.serialized += 1
        return self.codec.serialize(comp)

    def deserialize(self, rec):
        comp = self.codec.deserialize(rec)
        self.index[id(comp)] = len([e for e in self.log if e[0] == "deserialize"])
        self.log.append(("deserialize", self.index[id(comp)]))
        return comp

    def decode_device(self, comp):
        self.log.append(("decode", self.index[id(comp)]))
        return self.codec.decode_device(comp)


@pytest.fixture
def logged(monkeypatch):
    """A Recording codec whose blocks log `stage`, and whose reads of
    decoded output (`staging.HostCopy.wait`) log in order."""
    rec = Recording()
    stage, wait = TorchCompressed.stage, staging.HostCopy.wait

    def logging_stage(comp):
        rec.log.append(("stage", rec.index.get(id(comp))))
        return stage(comp)

    def logging_wait(host):
        rec.log.append(("read",))
        return wait(host)

    monkeypatch.setattr(TorchCompressed, "stage", logging_stage)
    monkeypatch.setattr(staging.HostCopy, "wait", logging_wait)
    return rec


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_compress_queues_block_i_plus_1_before_serializing_block_i(
    depth, raw, jax_blob, logged, monkeypatch
):
    monkeypatch.setattr(container, "PIPELINE_DEPTH", depth)
    blob = container.compress_blocks(raw, logged, BS)
    assert blob == jax_blob
    calls = [e for e in logged.log if e[0] in ("encode", "stage", "serialize")]
    n = logged.encoded
    assert n == 5 and logged.serialized == n
    pos = {}  # each call's first place (serialize stages again, a no-op)
    for at, e in enumerate(calls):
        pos.setdefault(e, at)
    for i in range(n):
        # Staged right after its kernels, before the next block's.
        assert pos[("stage", i)] == pos[("encode", i)] + 1
        if i + depth - 1 < n:
            assert pos[("encode", i + depth - 1)] < pos[("serialize", i)]
        if i + depth < n:
            assert pos[("serialize", i)] < pos[("encode", i + depth)]
    assert logged.in_flight == min(depth, n)
    assert [e[1] for e in calls if e[0] == "serialize"] == list(range(n))


def test_decompress_queues_block_i_plus_1_before_reading_block_i(raw, jax_blob, logged):
    assert container.decompress_blocks(jax_blob, logged) == raw
    log = [e for e in logged.log if e[0] in ("decode", "read")]
    # Records H H S H S (the ragged tail's padded block is stored): the
    # first stored record flushes the blocks 0 and 1, the second block 3.
    assert log == [("decode", 0), ("decode", 1), ("read",), ("read",), ("decode", 2), ("read",)]


def _pack_with_extra(records, block_size):
    """A container whose records carry the u16 extra (kind, extra,
    raw_len, payload), as the native pipeline writes 'R' records."""
    total = sum(r[2] for r in records)
    out = bytearray(container.MAGIC + struct.pack("<IQ", block_size, total))
    for kind, kx, raw_len, payload in records:
        out += struct.pack("<IIBHx", len(payload), raw_len, kind, kx)
        out += payload
    return bytes(out)


def test_stored_and_ref_records_flush_the_blocks_in_flight(logged, monkeypatch):
    rng = np.random.default_rng(11)
    blocks = [_biased(rng, BS) for _ in range(7)]
    blocks[3] = rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
    codec = TorchCodec(K, device="cpu")
    recs = []
    for i, b in enumerate(blocks):
        if i == 3:
            recs.append((container.KIND_STORED, 0, BS, b))
        elif i == 5:
            recs.append((container.KIND_REF, 8, BS, native.compress(b, 8)))
        else:
            recs.append((container.KIND_HUFF, 0, BS, codec._compress_blob(b)))
    raw = b"".join(blocks)
    blob = _pack_with_extra(recs + [(container.KIND_CRC, 0) + container.crc_record(raw)[1:]], BS)
    decode_record = container.decode_record

    def logging_decode_record(kind, *args):
        logged.log.append(("record", chr(kind)))
        return decode_record(kind, *args)

    monkeypatch.setattr(container, "decode_record", logging_decode_record)
    logged.log.clear()  # the blobs' serializes read back too
    assert container.decompress_blocks(blob, logged) == raw
    assert jcontainer.decompress_blocks(blob, TpuCodec(K)) == raw
    log = [e for e in logged.log if e[0] in ("decode", "read", "record")]
    assert log == [
        ("decode", 0), ("decode", 1), ("read",), ("decode", 2), ("read",),
        ("read",), ("record", "S"),
        ("decode", 3), ("read",), ("record", "R"),
        ("decode", 4), ("read",), ("record", "C"),
    ]


def test_single_block_bytes_api_shares_the_fetch_path(raw, monkeypatch):
    """compress stages the block once; decompress reads its output through
    one HostCopy, as the pipeline does."""
    made = []
    init = staging.HostCopy.__init__

    def counting_init(self, *tensors):
        made.append(len(tensors))
        init(self, *tensors)

    monkeypatch.setattr(staging.HostCopy, "__init__", counting_init)
    codec = TorchCodec(K, device="cpu")
    blob = codec.compress(raw[:BS])
    assert made == [3]  # metadata, bit counts and words, staged together
    assert codec.decompress(blob) == raw[:BS]
    assert made == [3, 1]
    assert blob == TpuCodec(K).compress(raw[:BS])


def test_upload_ring_reuses_a_buffer_only_for_a_new_block():
    ring = staging.PinnedRing("cpu", 1)
    a = ring.upload(4, lambda buf: buf.__setitem__(slice(None), [1, 2, 3, 4]))
    b = ring.upload(3, lambda buf: buf.__setitem__(slice(None), [9, 9, 9]))
    assert a.tolist() == [1, 2, 3, 4] and b.tolist() == [9, 9, 9]
    assert ring.upload(0, lambda buf: None).numel() == 0


def test_deserialized_block_equals_the_encoded_one(raw):
    """deserialize's one staged upload lays out words, bit counts and
    tables as the encode left them."""
    codec = TorchCodec(K, device="cpu")
    comp = codec.encode_device(codec.upload(raw[:BS]))
    back = codec.deserialize(codec.serialize(comp))
    w = back.words.shape[0]
    assert torch.equal(back.words, comp.words[:w]) and not comp.words[w:].any()
    assert torch.equal(back.bit_counts, comp.bit_counts)
    for key in ("e_bound", "g_rank", "len_count", "num_syms"):
        assert torch.equal(back.tables[key], comp.tables[key]), key
    num_syms = int(comp.tables["num_syms"])
    assert torch.equal(back.tables["sorted_syms"][:num_syms], comp.tables["sorted_syms"][:num_syms])
    assert back.tables["num_syms"].shape == ()
