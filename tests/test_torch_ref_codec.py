"""The ``ref`` profile: `TorchRefCodec` on the CPU (its kernels' plain
versions) against ``huffman_tpu``'s `JaxCodec`, golden and native on the
same bytes, and the plain encode with per-lane row counts against the
JAX package's XLA ``encode_lanes`` with the same valid mask.  Also the
tpu profile's `TorchCompressed.coding` against `TpuCompressed.coding`.
Tolerance: exact (blobs, words and decoded bytes byte for byte).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import standard_cases
from huffman_tpu import golden as jgolden, native as jnative
from huffman_tpu.models.jax_codec import JaxCodec
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu.ops.encode import encode_lanes as xla_encode_lanes
from huffman_tpu.ops.encode import words_to_byte_columns
from huffman_tpu_torch import TorchCodec, TorchRefCodec, coding, golden, native
from huffman_tpu_torch.bench import kernel_cases, workloads
from huffman_tpu_torch.constants import TPU_MAX_CODE_LEN
from huffman_tpu_torch.models.torch_ref_codec import device_path, lane_layout, slice_order
from huffman_tpu_torch.ops import tables
from huffman_tpu_torch.ops.encode import encode_lanes, encode_lanes_batch_plain, encode_lanes_plain

torch.set_num_threads(2)

CASES = standard_cases()
KS = [1, 4, 32, 256]


@pytest.mark.parametrize("name", [name for name, _ in CASES])
@pytest.mark.parametrize("k", KS)
def test_blobs_match_jax_and_golden(k, name):
    raw = dict(CASES)[name]
    tc, jc = TorchRefCodec(k, device="cpu"), JaxCodec(k)
    tblob, jblob = tc.compress(raw), jc.compress(raw)
    assert tblob == jblob
    assert tblob == golden.compress(raw, k)
    assert tc.decompress(jgolden.compress(raw, k)) == raw
    assert tc.decompress(jblob) == raw
    assert jc.decompress(tblob) == raw


@functools.lru_cache(maxsize=None)
def _mib_block() -> bytes:
    return workloads.biased_u8(1 << 20, 0).tobytes()


def test_mib_block_at_4096_lanes_matches_jax_and_native():
    """s = 256, the lane length of the card's 16 MiB block at K = 65536."""
    raw, k = _mib_block(), 4096
    tc, jc = TorchRefCodec(k, device="cpu"), JaxCodec(k)
    assert device_path(len(raw), k)
    tblob = tc.compress(raw)
    assert tblob == jc.compress(raw)
    assert tblob == native.compress(raw, k) == jnative.compress(raw, k)
    assert tc.decompress(tblob) == raw
    assert jc.decompress(tblob) == raw


@pytest.mark.parametrize("n", [15, 16, 17, 16384, 16385])
def test_host_path_bounds_match_jax(n):
    """k = 4: below 4k and above 4096k bytes both packages take the host
    library; in between the device path.  Both write the same blobs."""
    raw = workloads.biased_u8(n, 3).tobytes()
    tc, jc = TorchRefCodec(4, device="cpu"), JaxCodec(4)
    assert device_path(n, 4) == (16 <= n <= 16384)
    blob = tc.compress(raw)
    assert blob == jc.compress(raw)
    assert tc.decompress(blob) == raw


def test_absent_cuda_device_raises():
    """Asked for a card that is not there, the device path raises; the
    host path (a 3-byte input) never touches a device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tc = TorchRefCodec(4, device="cuda")
    assert tc.compress(b"abc") == JaxCodec(4).compress(b"abc")
    with pytest.raises((RuntimeError, AssertionError)):
        tc.compress(workloads.biased_u8(1024, 0).tobytes())


def test_name():
    assert TorchRefCodec(32, device="cpu").name == "Torch<32>"


@pytest.mark.parametrize("n,k", [(1000, 64), (1024, 64), (4 * 7, 7), (4096 * 3, 3)])
def test_lane_layout_matches_the_gather(n, k):
    """The two transposed views equal the JAX codec's gather with its
    valid mask (``jax_codec.py:30-32``); slice order inverts them."""
    data = workloads.biased_u8(n, 1)
    lanes, sizes = lane_layout(torch.from_numpy(data), k)
    sizes_np = np.full(k, n // k)
    sizes_np[: n % k] += 1
    s = int(sizes_np.max())
    bounds = np.concatenate([[0], np.cumsum(sizes_np)])[:-1]
    idx = bounds[None, :] + np.arange(s)[:, None]
    valid = np.arange(s)[:, None] < sizes_np[None, :]
    want = np.where(valid, data[np.clip(idx, 0, n - 1)], 0)
    np.testing.assert_array_equal(lanes.numpy(), want)
    np.testing.assert_array_equal(sizes.numpy(), sizes_np)
    np.testing.assert_array_equal(slice_order(lanes, n).numpy(), data)


def _xla_encode(block: np.ndarray, enc: np.ndarray, rows: np.ndarray, s: int, k: int):
    """JAX's XLA encode with the valid mask of ``rows``: (forward bytes
    (k, nbytes), bit counts)."""
    valid = np.arange(s)[:, None] < rows[None, :]
    words, _, bits = xla_encode_lanes(
        jnp.asarray(block.reshape(s, k).astype(np.int32)), jnp.asarray(valid),
        jnp.asarray(enc.astype(np.int32)),
    )
    return np.asarray(words_to_byte_columns(words)).T, np.asarray(bits)


def _port_bytes(words: torch.Tensor) -> np.ndarray:
    """(w32, k) int32 words -> (k, 4 w32) forward bytes (big-endian u32)."""
    return np.ascontiguousarray(words.numpy().view(np.uint32).T).astype(">u4").view(np.uint8)


def _compare(got_words, got_bits, want_bytes, want_bits):
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    got = _port_bytes(got_words)
    n = max(got.shape[1], want_bytes.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, n - a.shape[1])))  # noqa: E731
    np.testing.assert_array_equal(pad(got), pad(want_bytes))


ENCODE_CASES = list(kernel_cases.encode_cases(small=True))


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_plain_encode_with_lane_rows_matches_xla(case):
    """Row counts of s or s - 1 (the ref profile's slices) and, in a
    second pass, anywhere from 0 to s."""
    c = kernel_cases.encode_cases(small=True)[case]
    s, k = c["s"], c["k"]
    block = c["data"][c["offset"] :]
    enc = tables.pack_encode_table(coding.make_canonical_coding(c["hist"], max_len=15, clamp=True))
    rng = np.random.default_rng(s * k)
    w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
    for rows in (s - rng.integers(0, 2, k), rng.integers(0, s + 1, k)):
        rows_t = torch.from_numpy(rows.astype(np.int32))
        enc_t = torch.from_numpy(enc.astype(np.int32))
        words, bits = encode_lanes(torch.from_numpy(block), enc_t, s, k, w32, lane_rows=rows_t)
        _compare(words, bits, *_xla_encode(block, enc, rows, s, k))
        # The same counts for every block of a batch.
        bw, bb = encode_lanes_batch_plain(
            torch.from_numpy(np.stack([block, block[::-1].copy()])), enc_t.expand(2, 256),
            s, k, w32, rows_t,
        )
        _compare(bw[1], bb[1], *_xla_encode(block[::-1].copy(), enc, rows, s, k))


def test_lane_rows_of_s_equal_no_lane_rows():
    c = kernel_cases.encode_cases(small=True)["K=24"]
    s, k = c["s"], c["k"]
    block = torch.from_numpy(c["data"])
    enc = torch.from_numpy(
        tables.pack_encode_table(coding.make_canonical_coding(c["hist"])).astype(np.int32)
    )
    full = torch.full((k,), s, dtype=torch.int32)
    w32 = (s * 12 + 31) // 32 + 2
    for got, want in zip(
        encode_lanes_plain(block, enc, s, k, w32, full), encode_lanes_plain(block, enc, s, k, w32)
    ):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(workloads.WORKLOADS))
def test_torch_compressed_coding_matches_tpu_codec(name):
    raw = workloads.make_workload(name)
    got = TorchCodec(device="cpu").encode_device(
        torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    ).coding
    want = TpuCodec().encode_device(jnp.asarray(np.frombuffer(raw, np.uint8))).coding
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.max_len == TPU_MAX_CODE_LEN
