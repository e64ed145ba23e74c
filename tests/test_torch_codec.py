"""The whole slice: TorchCodec against huffman_tpu's TpuCodec on the same
bytes.  Tolerance: exact (blobs and decoded bytes are compared byte for
byte).  On the CPU the port runs its kernels' plain PyTorch versions;
TpuCodec runs its XLA path.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.models.tpu_codec import TpuCodec, TpuCompressed
from huffman_tpu_torch import TorchCodec, container, convert, native
from huffman_tpu_torch.bench import workloads
from huffman_tpu_torch.models import torch_codec

torch.set_num_threads(2)


def _pair(**kw):
    return TorchCodec(device="cpu", **kw), TpuCodec(**kw)


def _u8(raw: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, np.uint8).copy())


@pytest.mark.parametrize("name", list(workloads.WORKLOADS))
def test_workload_blobs_identical_and_cross_decode(name):
    raw = workloads.make_workload(name)
    tc, jc = _pair()
    tblob, jblob = tc.compress(raw), jc.compress(raw)
    assert tblob == jblob
    assert tc.decompress(jblob) == raw
    assert jc.decompress(tblob) == raw
    n = len(raw)
    assert tc.serialize(tc.encode_device(_u8(raw))) == jc.serialize(
        jc.encode_device(jnp.asarray(np.frombuffer(raw, np.uint8)))
    )
    assert len(tblob) < n + 8 or tblob[:4] == container.MAGIC  # stored when larger


LAYOUTS = {
    "compact_auto": dict(compact=True, counts="auto"),
    "compact_flat": dict(compact=True, counts="flat"),
    "huff_counts": dict(compact=True, counts="huff"),
    "legacy": dict(compact=False),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_identical_and_cross_decode(layout):
    raw = workloads.make_workload("biased")
    tc, jc = _pair()
    kw = LAYOUTS[layout]
    tblob = tc.serialize(tc.encode_device(_u8(raw)), **kw)
    jblob = jc.serialize(jc.encode_device(jnp.asarray(np.frombuffer(raw, np.uint8))), **kw)
    assert tblob == jblob
    assert tc.decompress(jblob) == raw
    assert jc.decompress(tblob) == raw
    assert tc.serialize(tc.deserialize(tblob), **kw) == tblob


def test_sampled_4mib_block_identical():
    raw = workloads.biased_u8(4 << 20, 1).tobytes()
    tc, jc = _pair()
    tblob = tc.compress(raw)
    assert tblob == jc.compress(raw)
    assert tc.decompress(tblob) == raw


def test_headline_16mib_block_identical_with_ratio():
    data = workloads.biased_u8(16 << 20, 0)
    tc, jc = _pair()
    comp = tc.encode_device(torch.from_numpy(data))
    assert comp.k == 131072 and comp.words.shape == (61, 131072)
    tblob = tc.serialize(comp)
    jblob = jc.serialize(jc.encode_device(jnp.asarray(data)))
    assert tblob == jblob
    assert round(len(data) / len(tblob), 4) == 2.1626
    assert torch.equal(tc.decode_device(tc.deserialize(tblob)), torch.from_numpy(data))


def test_from_numpy_decodes_in_memory():
    data = np.frombuffer(workloads.make_workload("lorem"), np.uint8)
    tc, jc = _pair()
    jcomp = jc.encode_device(jnp.asarray(data))
    comp = convert.from_numpy(
        np.asarray(jcomp.words), np.asarray(jcomp.bit_counts), jcomp.raw_size,
        jcomp.k, {k: np.asarray(v) for k, v in jcomp.tables.items()}, device="cpu",
    )
    assert tc.decode_device(comp).numpy().tobytes() == data.tobytes()
    assert tc.serialize(comp) == jc.serialize(jcomp)


def test_to_numpy_decodes_in_jax():
    raw = workloads.make_workload("file")
    tc, jc = _pair()
    f = convert.to_numpy(tc.deserialize(tc.compress(raw)))
    jcomp = TpuCompressed(
        words=jnp.asarray(f["words"]),
        bit_counts=jnp.asarray(f["bit_counts"]),
        raw_size=f["raw_size"],
        k=f["k"],
        tables={k: jnp.asarray(v) for k, v in f["tables"].items()},
    )
    assert np.asarray(jc.decode_device(jcomp)).tobytes() == raw


@pytest.mark.parametrize(
    "raw",
    [b"", b"x", b"a" * 100_000, b"ab" * 5, bytes(range(256)) * 4],
    ids=["empty", "one_byte", "single_symbol", "tiny", "equal_counts"],
)
def test_edge_blocks_identical(raw):
    tc, jc = _pair()
    tblob = tc.compress(raw)
    assert tblob == jc.compress(raw)
    assert tc.decompress(tblob) == raw
    assert jc.decompress(tblob) == raw


@pytest.mark.parametrize("n", [64 << 10, (64 << 10) - 100], ids=["n_is_s_k", "partial_row"])
def test_encode_device_pads_only_a_partial_row(n, monkeypatch):
    """The blob equals TpuCodec's whether or not the last row is padded;
    a block of whole rows (n = s * k) is encoded without a pad."""
    raw = workloads.biased_u8(n, 3)
    tc, jc = _pair()
    want = jc.serialize(jc.encode_device(jnp.asarray(raw)))
    k = torch_codec.default_lanes(n)
    if n % k == 0:
        def no_pad(*a, **kw):
            raise AssertionError("a block of whole rows was padded")

        monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    assert tc.serialize(tc.encode_device(torch.from_numpy(raw))) == want


def test_custom_lane_counts_and_cross_k_decode():
    raw = workloads.make_workload("lorem", 5000)
    for k in (8, 64):
        tc, jc = _pair(k=k)
        blob = tc.compress(raw)
        assert blob == jc.compress(raw)
        assert TorchCodec(k=1024, device="cpu").decompress(blob) == raw  # K is in the header


def test_shared_tables_identical():
    sample = workloads.make_workload("biased")
    raw = workloads.make_workload("file")
    tc, jc = _pair()
    tt = tc.build_tables(_u8(sample))
    jt = jc.build_tables(jnp.asarray(np.frombuffer(sample, np.uint8)))
    for key in jt:
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]), err_msg=key)
    tblob = tc.serialize(tc.encode_device(_u8(raw), tables=tt))
    assert tblob == jc.serialize(jc.encode_device(jnp.asarray(np.frombuffer(raw, np.uint8)), tables=jt))
    assert tc.decompress(tblob) == raw


def test_container_blocks_identical():
    raw = workloads.make_workload("biased", 150_000) + workloads.make_workload("uniform", 70_000)
    tc, jc = _pair()
    tc.block_bytes = jc.block_bytes = 64 << 10
    blob = tc.compress(raw)
    assert blob[:4] == container.MAGIC
    assert blob == jc.compress(raw)
    assert tc.decompress(blob) == raw
    kinds = [r[0] for r in container.parse_records(blob)[2]]
    assert container.KIND_STORED in kinds and kinds[-1] == container.KIND_CRC


def test_container_crc_and_truncation_raise():
    raw = workloads.make_workload("lorem", 150_000)
    tc, _ = _pair()
    tc.block_bytes = 64 << 10
    blob = bytearray(tc.compress(raw))
    with pytest.raises(ValueError):
        tc.decompress(bytes(blob[:-30]))
    blob[-1] ^= 0xFF  # the crc trailer
    with pytest.raises(ValueError, match="crc"):
        tc.decompress(bytes(blob))


def test_native_pipeline_records_decode(tmp_path):
    from huffman_tpu import native as jnative

    raw = workloads.make_workload("file", 300_000)
    src, dst = tmp_path / "in", tmp_path / "out"
    src.write_bytes(raw)
    jnative.compress_file(str(src), str(dst), k=16, block=1 << 17, threads=2)
    blob = dst.read_bytes()
    assert container.KIND_REF in [r[0] for r in container.parse_records(blob)[2]]
    assert TorchCodec(device="cpu").decompress(blob) == raw


def _blob():
    tc, _ = _pair()
    return tc.compress(workloads.make_workload("biased", 20_000))


def _bad_kraft(b):
    b = bytearray(b)
    b[16] ^= 1  # first length count
    return bytes(b)


TAMPERED = {
    "magic": lambda b: b"XXXX" + b[4:],
    "short_header": lambda b: b[:10],
    "truncated_counts": lambda b: b[:17],
    "truncated_payload": lambda b: b[: len(b) - 40],
    "bad_kraft": _bad_kraft,
    "unknown_flag": lambda b: b[:15] + bytes([b[15] | 0x80]) + b[16:],
    "huff_without_compact": lambda b: b[:15] + bytes([(b[15] | 0x04) & ~0x02]) + b[16:],
    "zero_lanes": lambda b: b[:8] + struct.pack("<I", 0) + b[12:],
}


@pytest.mark.parametrize("how", list(TAMPERED))
def test_tampered_blobs_raise(how):
    with pytest.raises(ValueError):
        TorchCodec(device="cpu").deserialize(TAMPERED[how](_blob()))


def test_serialize_refuses_unreadable_delta_width():
    """A delta wider than the parser's 24 bits raises instead of writing a
    blob that cannot be read back."""
    tc = TorchCodec(device="cpu")
    t = tc.build_tables(torch.arange(256, dtype=torch.uint8))
    comp = torch_codec.TorchCompressed(
        words=torch.zeros((1, 2), dtype=torch.int32),
        bit_counts=torch.tensor([0, 1 << 25], dtype=torch.int32),
        raw_size=1 << 30,
        k=2,
        tables=t,
    )
    with pytest.raises(ValueError, match="width"):
        tc.serialize(comp)


def test_flat_counts_skip_the_counts_blob(monkeypatch):
    tc = TorchCodec(device="cpu")
    comp = tc.encode_device(_u8(workloads.make_workload("biased")))
    auto = tc.serialize(comp, counts="flat")

    def refuse(*a, **kw):
        raise AssertionError("counts blob built for counts='flat'")

    monkeypatch.setattr(native, "compress", refuse)
    assert tc.serialize(comp, counts="flat") == auto


def test_lane_bit_packers_native_matches_numpy():
    rng = np.random.default_rng(5)
    k, nb = 300, 12
    lane_bytes = rng.integers(0, 256, size=(k, nb), dtype=np.uint8)
    bits = rng.integers(0, 8 * nb + 1, size=k)
    bits[:3] = [0, 8 * nb, 1]
    packed = native.pack_lane_bits(lane_bytes, bits)
    assert packed == torch_codec._pack_lane_bits(lane_bytes, bits)
    stream = np.frombuffer(packed, np.uint8)
    back = native.unpack_lane_bits(stream, bits, nb)
    np.testing.assert_array_equal(back, torch_codec._unpack_lane_bits(stream, bits, nb))
    # Round trip: the unpacked rows repack to the same stream.
    assert native.pack_lane_bits(back, bits) == packed
    with pytest.raises(ValueError):
        native.unpack_lane_bits(stream, bits, nb - 1)


def test_meta_is_one_fetch_and_matches_tables():
    tc = TorchCodec(device="cpu")
    comp = tc.encode_device(_u8(workloads.make_workload("lorem")))
    m = comp.meta()
    assert m is comp.meta()
    assert m["max_bits"] == int(comp.bit_counts.max())
    assert m["num_syms"] == int(comp.tables["num_syms"])
    assert m["l_min"] == int(comp.tables["l_min"])
    np.testing.assert_array_equal(m["len_count"], comp.tables["len_count"].numpy())
