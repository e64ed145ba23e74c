"""The batched-blocks path of huffman_tpu_torch (`TorchCodec.encode_batch`
/ `batch_decode_statics` / `decode_batch`, and the batched kernels' plain
versions under them) held against huffman_tpu's on the same numpy
inputs.  Tolerance: exact (every value is an integer or a byte).

On the CPU the port runs its kernels' plain PyTorch versions; the JAX
side runs as its own CPU tests run it: `histogram256_batch` as its Pallas
kernel in interpret mode, the rest on the XLA path.

The file keeps to six JAX input shapes, because jaxlib crashes after
about 600 compiles in one process: (5, 4096), (4, 4096), (3, 5000),
(8, 256), (160, 102400) and (2, 4 MiB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.models.tpu_codec import TpuCodec, TpuCompressed
from huffman_tpu.ops import lookup as jlookup
from huffman_tpu.ops import table_build as jtb
from huffman_tpu_torch import TorchCodec, TorchCompressed, convert
from huffman_tpu_torch.bench import workloads
from huffman_tpu_torch.ops import lookup, table_build

torch.set_num_threads(2)

KEYS = ("enc_table", "len_count", "sorted_syms", "num_syms", "e_bound", "g_rank", "l_min")
NB = 100 << 10  # the batched tool's block size


def _mixed_batch():
    """(4, 4096): constant 'a', biased, uniform random, all zeros."""
    rng = np.random.default_rng(4)
    return np.stack(
        [
            np.full(4096, ord("a"), np.uint8),
            workloads.biased_u8(4096, 1),
            rng.integers(0, 256, size=4096, dtype=np.uint8),
            np.zeros(4096, np.uint8),
        ]
    )


def _table_hists():
    """(8, 256): empty, single-symbol, equal, Fibonacci (needs the 15-bit
    repair) and four random rows."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(8)
    rows = [
        np.zeros(256, np.int64),
        np.eye(1, 256, 65, dtype=np.int64).ravel() * 1000,
        np.full(256, 17),
        np.array(fib[::-1] + [0] * 236),
    ]
    for i in range(4):
        h = np.zeros(256, np.int64)
        active = rng.choice(256, size=int(rng.integers(2, 257)), replace=False)
        h[active] = rng.integers(1, [100, 2**21, 2, 5000][i], size=len(active))
        rows.append(h)
    return np.stack(rows).astype(np.int32)


# ---------------------------------------------------------------- K2 histogram

HIST_CASES = {
    "n_multiple_of_1024": lambda: workloads.biased_u8(5 * 4096, 5).reshape(5, 4096),
    "skewed_single_symbol_rows": _mixed_batch,
    "n_not_a_multiple_of_the_chunk": lambda: np.random.default_rng(3).integers(
        0, 256, size=(3, 5000), dtype=np.uint8
    ),
    "n_below_1024": lambda: np.random.default_rng(2).integers(
        0, 7, size=(8, 256), dtype=np.uint8
    ),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram256_batch_matches_jax_kernel(case):
    x = HIST_CASES[case]()
    want = np.asarray(jlookup.histogram256_batch(jnp.asarray(x), interpret=True))
    got = lookup.histogram256_batch(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.stack([np.bincount(r, minlength=256) for r in x])
    )


def test_histogram256_batch_plain_rejects_other_shapes():
    with pytest.raises(ValueError, match="uint8"):
        lookup.histogram256_batch_plain(torch.zeros(4096, dtype=torch.uint8))


# ---------------------------------------------------------------- table build

def test_build_coding_device_batch_matches_jax_vmap():
    hists = _table_hists()
    want = jax.vmap(lambda h: jtb.build_coding_device(h, serial_tree=False))(
        jnp.asarray(hists)
    )
    got = table_build.build_coding_device_batch(torch.from_numpy(hists))
    assert set(got) == set(KEYS)
    for key in KEYS:
        # The CUDA encode and decode take each key as a contiguous tensor.
        assert got[key].shape[0] == len(hists) and got[key].is_contiguous(), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert int(got["len_count"][3, 15]) > 0  # the Fibonacci row reached 15 bits
    for i, h in enumerate(hists):
        one = table_build.build_coding_device(torch.from_numpy(h))
        for key in KEYS:
            np.testing.assert_array_equal(one[key].numpy(), got[key][i].numpy(), err_msg=key)


# ---------------------------------------------------------------- the codec

ENCODE_CASES = {
    "b5_k64": (lambda: workloads.biased_u8(5 * 4096, 5).reshape(5, 4096), 64),
    "mixed_k64": (_mixed_batch, 64),
    "full_160x100KiB_k1024": (
        lambda: workloads.biased_u8(160 * NB, 160).reshape(160, NB), 1024
    ),
    "two_4MiB_k8192": (lambda: workloads.biased_u8(8 << 20, 2).reshape(2, 4 << 20), 8192),
}


@pytest.fixture(scope="module", params=list(ENCODE_CASES))
def batch(request):
    """One case encoded by both codecs: (blocks, k, torch triple, JAX
    triple as numpy)."""
    make, k = ENCODE_CASES[request.param]
    blocks = make()
    tc, jc = TorchCodec(k=k, device="cpu"), TpuCodec(k=k)
    got = tc.encode_batch(torch.from_numpy(blocks))
    jw, jb, jt = jc.encode_batch(jnp.asarray(blocks))
    want = (np.asarray(jw), np.asarray(jb), {key: np.asarray(v) for key, v in jt.items()})
    return request.param, blocks, k, got, want


def test_encode_batch_matches_jax(batch):
    _, blocks, k, (words, bits, tables), (jw, jb, jt) = batch
    bcount, nb = blocks.shape
    w32 = (nb // k * 15 + 31) // 32 + 1
    assert words.shape == (bcount, w32, k) and words.dtype == torch.int32
    assert bits.shape == (bcount, k) and bits.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jw)
    np.testing.assert_array_equal(bits.numpy(), jb)
    assert set(tables) == set(jt) == set(KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(tables[key].numpy(), jt[key], err_msg=key)


def test_decode_batch_cross_decodes_with_jax(batch):
    """Each codec decodes the other's batch, through `convert`, with and
    without precomputed statics; the statics equal JAX's tuple."""
    _, blocks, k, got, want = batch
    bcount, nb = blocks.shape
    tc, jc = TorchCodec(k=k, device="cpu"), TpuCodec(k=k)
    expect = blocks.reshape(bcount, nb // k, k)

    words, bits, tables = convert.batch_from_numpy(*want, device="cpu")
    statics = tc.batch_decode_statics(words, bits, tables, nb)
    jstatics = jc.batch_decode_statics(
        jnp.asarray(want[0]), jnp.asarray(want[1]), want[2], nb
    )
    assert statics == jstatics
    assert statics == tc.batch_decode_statics(*got, nb)
    out = tc.decode_batch(words, bits, tables, nb, statics=statics)
    assert out.shape == (bcount, nb // k, k) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), expect)
    np.testing.assert_array_equal(tc.decode_batch(*got, nb).numpy(), expect)

    pw, pb, pt = convert.batch_to_numpy(*got)
    assert pw.dtype == np.uint32
    jout = jc.decode_batch(
        jnp.asarray(pw), jnp.asarray(pb), {key: jnp.asarray(v) for key, v in pt.items()},
        nb, statics=jstatics,
    )
    np.testing.assert_array_equal(np.asarray(jout), expect)


def _block(got, i, nb, k) -> TorchCompressed:
    words, bits, tables = got
    return TorchCompressed(
        words=words[i], bit_counts=bits[i], raw_size=nb, k=k,
        tables={key: v[i] for key, v in tables.items()},
    )


def test_batch_blocks_serialize_like_jax_and_solo(batch):
    """Block i of a batch serializes to TpuCodec's bytes for JAX's block i;
    below 4 MiB (every byte counted on both paths) also to the solo
    encode's bytes."""
    name, blocks, k, got, (jw, jb, jt) = batch
    bcount, nb = blocks.shape
    tc, jc = TorchCodec(k=k, device="cpu"), TpuCodec(k=k)
    for i in sorted({0, 1, bcount - 1}):
        blob = tc.serialize(_block(got, i, nb, k))
        jcomp = TpuCompressed(
            words=jnp.asarray(jw[i]), bit_counts=jnp.asarray(jb[i]), raw_size=nb, k=k,
            tables={key: jnp.asarray(v[i]) for key, v in jt.items()},
        )
        assert blob == jc.serialize(jcomp)
        assert tc.decompress(blob) == blocks[i].tobytes()
        solo = tc.serialize(tc.encode_device(torch.from_numpy(blocks[i])))
        assert (solo == blob) == (nb < 4 << 20), name


def test_mixed_batch_blocks_equal_their_solo_encode():
    blocks = _mixed_batch()
    tc = TorchCodec(k=64, device="cpu")
    words, bits, tables = tc.encode_batch(torch.from_numpy(blocks))
    assert tables["num_syms"].tolist()[0] == 1 and tables["num_syms"].tolist()[3] == 1
    assert int(tables["num_syms"][2]) == 256
    for i, row in enumerate(blocks):
        comp = tc.encode_device(torch.from_numpy(row))
        assert torch.equal(comp.words, words[i]) and torch.equal(comp.bit_counts, bits[i])
        blob = tc.serialize(_block((words, bits, tables), i, 4096, 64))
        assert blob == tc.compress(row.tobytes()) or i == 2  # the uniform row is stored


def test_batch_counts_every_byte_where_the_solo_path_samples():
    """At 4 MiB the solo encode samples 1 row in 32 (+1 per bin); the batch
    builds block 0's table from its exact byte counts."""
    blocks = workloads.biased_u8(8 << 20, 2).reshape(2, 4 << 20)
    tc = TorchCodec(k=8192, device="cpu")
    hists = lookup.histogram256_batch(torch.from_numpy(blocks))
    assert hists.sum(dim=1).tolist() == [4 << 20] * 2
    batch_tables = table_build.build_coding_device_batch(hists)
    exact = table_build.build_coding_device(
        torch.from_numpy(np.bincount(blocks[0], minlength=256))
    )
    solo = tc.encode_device(torch.from_numpy(blocks[0])).tables
    assert torch.equal(batch_tables["len_count"][0], exact["len_count"])
    assert not torch.equal(batch_tables["enc_table"][0], solo["enc_table"])


@pytest.mark.parametrize(
    "blocks,match",
    [
        (torch.zeros((2, 100), dtype=torch.uint8), "multiple of the lane count"),
        (torch.zeros((2, 128), dtype=torch.int32), "uint8"),
        (torch.zeros(128, dtype=torch.uint8), "uint8"),
        (torch.zeros((0, 128), dtype=torch.uint8), "non-empty"),
    ],
    ids=["nb_not_a_multiple_of_k", "int32", "one_dim", "no_blocks"],
)
def test_encode_batch_rejects_bad_input(blocks, match):
    with pytest.raises(ValueError, match=match):
        TorchCodec(k=64, device="cpu").encode_batch(blocks)
