"""The plain versions of the table and decode kernels, which are the
kernels' oracle on the card, held against the JAX package on the inputs
of ``huffman_tpu_torch.bench.kernel_cases``.  Tolerance: exact (every
value is an integer or a byte).

The JAX side runs as its own CPU tests run it: the vmapped XLA table
build (``serial_tree=False``) and the XLA bit-serial decode of
``_decode_full``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.models import tpu_codec as jtc
from huffman_tpu.ops import table_build as jtb
from huffman_tpu_torch.bench import kernel_cases, workloads
from huffman_tpu_torch.ops import decode_bits, encode, lookup, table_build

torch.set_num_threads(2)

N_TABLES = 320  # of kernel_cases.table_hists, in four equal chunks
CHUNKS = 4


@functools.lru_cache(maxsize=None)
def _hists():
    return kernel_cases.table_hists(N_TABLES)


@functools.lru_cache(maxsize=None)
def _jax_build():
    return jax.jit(jax.vmap(lambda h: jtb.build_coding_device(h, serial_tree=False)))


def test_table_hists_cover_the_cases():
    h = kernel_cases.table_hists()
    present = (h > 0).sum(axis=1)
    assert h.shape == (2000, 256) and h.dtype == np.int32
    assert set(range(257)) <= set(present.tolist())
    assert (h.astype(np.int64).sum(axis=1) < 1 << 30).all()
    assert h.astype(np.int64).sum(axis=1).max() > (1 << 30) - (1 << 21)
    repaired = sum(
        int(table_build.build_coding_device(torch.from_numpy(row))["len_count"][15]) > 0
        for row in h[:60]
    )
    assert repaired > 0


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_plain_table_build_matches_jax(chunk):
    size = N_TABLES // CHUNKS
    h = _hists()[chunk * size : (chunk + 1) * size]
    got = table_build._unpack(table_build.build_coding_plain_batch(torch.from_numpy(h)), size)
    want = _jax_build()(jnp.asarray(h))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@functools.lru_cache(maxsize=None)
def _sampled_hist():
    data = torch.from_numpy(workloads.biased_u8(16 << 20, 0))
    return lookup.table_hist_plain(data, 32).numpy()


@functools.lru_cache(maxsize=None)
def _jax_first_symbols():
    """The first symbol of each lane by the JAX decode: (k,) per call."""
    return jax.jit(
        lambda w, eb, gr, sy: jtc._decode_full(w, eb, gr, sy, s=1, n=w.shape[1], group=1, w=2)
    )


@pytest.mark.parametrize("name", ["sampled", "fibonacci", "one_bit", "equal", "single"])
def test_plain_decode_every_window_matches_jax(name):
    """Lane i starts with the 15-bit window i: the plain decode's first
    symbol of every lane equals the JAX decode's."""
    h = kernel_cases.decode_hists(_sampled_hist())[name]
    t = table_build.build_coding_device(torch.from_numpy(h))
    words = kernel_cases.window_words()
    tabs = [t[key] for key in ("e_bound", "g_rank", "sorted_syms")]
    got = decode_bits.decode_lanes_plain(torch.from_numpy(words), *tabs, 1)[0]
    want = _jax_first_symbols()(
        jnp.asarray(words.view(np.uint32)), *(jnp.asarray(x.numpy()) for x in tabs)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) == int(t["num_syms"])


def test_window_words_start_with_every_window():
    w = kernel_cases.window_words().view(np.uint32)
    assert w.shape == (3, 1 << 15)
    np.testing.assert_array_equal(w[0] >> 17, np.arange(1 << 15))


def test_escape_block_round_trips_on_the_fibonacci_table():
    data = kernel_cases.escape_block(64 * 32)
    t = table_build.build_coding_device(torch.from_numpy(kernel_cases.fibonacci_hist()))
    s, k = 64, 32
    w32 = (s * 15 + 31) // 32 + 1
    words, _ = encode.encode_lanes(torch.from_numpy(data), t["enc_table"], s, k, w32)
    out = decode_bits.decode_lanes(words, t["e_bound"], t["g_rank"], t["sorted_syms"], s)
    np.testing.assert_array_equal(out.reshape(-1).numpy(), data)
    lens = (t["enc_table"] & 15).numpy()[data]
    assert (lens > 11).mean() > 0.4


# ---------------------------------------------------------------- tools.kernel_ab
# Its measurements need the card; what it does to the sources does not.


def _source(name):
    from huffman_tpu_torch.ops import _cuda

    with open(f"{_cuda._CSRC}/{name}.cu") as f:
        return f.read()


def test_kernel_ab_stamps_each_step_of_table_build():
    from huffman_tpu_torch.tools import kernel_ab

    text, labels = kernel_ab.stamp_phases(_source("table_build"))
    assert [lab.split(".")[0] for lab in labels if lab[0].isdigit()] == list("123456")
    assert text.count("clock64()") == len(labels) + 1
    assert 'extern "C" int kernel_ab_stamps' in text


def test_kernel_ab_split_replaces_one_line_each():
    from huffman_tpu_torch.tools import kernel_ab

    src = _source("decode_lanes")
    variants = kernel_ab.split_variants(src)
    assert len(variants) == 3
    for text in variants.values():
        assert len(text.splitlines()) == len(src.splitlines())
        assert sum(a != b for a, b in zip(text.splitlines(), src.splitlines())) == 1


def test_kernel_ab_reports_times_in_the_order_taken():
    from huffman_tpu_torch.tools import kernel_ab

    by = {"parent": [1.0, 4.0, 5.0, 8.0], "change": [2.0, 3.0, 6.0, 7.0]}
    assert kernel_ab._interleave(by, 2) == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]


def test_kernel_ab_sweep_changes_one_constant_each():
    from huffman_tpu_torch.tools import kernel_ab

    src = _source("decode_lanes")
    variants = kernel_ab.sweep_variants(src)
    assert len(variants) == sum(len(v) for v in kernel_ab.SWEEP.values())
    for label, text in variants.items():
        name, value = label.split("=")
        assert f"constexpr int {name} = {value};" in text
        assert sum(a != b for a, b in zip(text.splitlines(), src.splitlines())) == 1
