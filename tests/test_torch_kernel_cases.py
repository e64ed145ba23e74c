"""The plain versions of the table, decode, encode and histogram kernels,
which are the kernels' oracle on the card, held against the JAX package
on the inputs of ``huffman_tpu_torch.bench.kernel_cases``.  Tolerance:
exact (every value is an integer or a byte).

The JAX side runs as its own CPU tests run it: the vmapped XLA table
build (``serial_tree=False``), the XLA bit-serial decode of
``_decode_full``, the XLA encode of ``_encode_with_tables_body`` and
``_table_hist``.
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


def _clipped_tables() -> dict:
    """Decode tables whose windows past the last code clip their rank:
    one 1-bit code (ranks past 255 from window 2^14 on) and one 3-bit code
    beside two 15-bit ones."""
    one = np.zeros(16, np.int64)
    one[1] = 1
    three = np.zeros(16, np.int64)
    three[[3, 15]] = [1, 2]
    return {
        name: decode_bits.decode_tables_bitserial(lc, np.arange(100, 100 + int(lc.sum())))
        for name, lc in (("one 1-bit code", one), ("a 3-bit and two 15-bit codes", three))
    }


def _window_tables() -> dict:
    """name -> (e_bound, g_rank, syms) as numpy: `kernel_cases.decode_hists`
    (the sampled 16 MiB table, Fibonacci, one bit, equal counts, the
    one-symbol block), the all-zero table of no symbol (every window past
    the second level) and `_clipped_tables`."""
    out = {}
    hists = kernel_cases.decode_hists(_sampled_hist()) | {
        "empty": kernel_cases.fixed_hists()["empty"]}
    for name, h in hists.items():
        t = table_build.build_coding_device(torch.from_numpy(h))
        out[name] = tuple(t[key].numpy() for key in ("e_bound", "g_rank", "sorted_syms"))
    for name, t in _clipped_tables().items():
        out[name] = (t["e_bound"], t["g_rank"], t["syms"])
    return out


@pytest.mark.parametrize("name", ["sampled", "fibonacci", "one_bit", "equal", "single", "empty",
                                  "one 1-bit code", "a 3-bit and two 15-bit codes"])
def test_decode_luts_give_the_canonical_entry_of_every_window(name):
    """The kernel's two tables (their plain model) give every 15-bit
    window the canonical search's length and byte."""
    eb, gr, sy = _window_tables()[name]
    win = np.arange(1 << 15)
    got = decode_bits.lut_entries_plain(win, eb, gr, sy)
    words = torch.from_numpy((win.astype(np.uint32) << 17).view(np.int32)[None])
    tabs = [torch.from_numpy(np.asarray(x, np.int32)) for x in (eb, gr, sy)]
    want_byte = decode_bits.decode_lanes_plain(words, *tabs, 1)[0].numpy()
    want_len = 1 + np.searchsorted(eb[1:15], win, side="right")
    np.testing.assert_array_equal(got & 255, want_byte)
    np.testing.assert_array_equal(got >> 8, want_len)
    first, second, ek = decode_bits.decode_luts_plain(eb, gr, sy)
    lens = want_len[:: 1 << (15 - decode_bits.LUT_BITS)]
    # A prefix escapes exactly where its codes are longer than the first level.
    np.testing.assert_array_equal((first & decode_bits.ESCAPE) != 0, lens > decode_bits.LUT_BITS)
    assert len(second) == min((1 << 15) - ek, decode_bits.LEVEL2_SIZE)


def test_decode_luts_cover_the_clip_and_the_second_level():
    """Of the windows above, some ranks clip below 0 and past 255, some
    windows take the second level and some lie past it."""
    clipped_low = clipped_high = second = past = 0
    for eb, gr, sy in _window_tables().values():
        win = np.arange(1 << 15)
        ln = 1 + np.searchsorted(eb[1:15], win, side="right")
        rank = (win >> (15 - ln)) + gr[ln]
        clipped_low += int((rank < 0).sum())
        clipped_high += int((rank > 255).sum())
        _, sec, ek = decode_bits.decode_luts_plain(eb, gr, sy)
        long_code = ln > decode_bits.LUT_BITS
        second += int((long_code & (win - ek < len(sec))).sum())
        past += int((long_code & (win - ek >= len(sec))).sum())
    assert min(clipped_low, clipped_high, second, past) > 0


def test_decode_luts_match_the_kernel_constants():
    src = _source("decode_lanes")
    assert f"constexpr int kLut = {decode_bits.LUT_BITS};" in src
    assert f"constexpr int kL2 = {decode_bits.LEVEL2_SIZE};" in src
    assert "constexpr uint32_t kEsc = 1u << 31;" in src and decode_bits.ESCAPE == 1 << 31


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


@functools.lru_cache(maxsize=None)
def _encode_cases():
    return kernel_cases.encode_cases(small=True)


@functools.lru_cache(maxsize=None)
def _jax_encode(s, k, w32):
    return jax.jit(lambda p, t: jtc._encode_with_tables_body(p, t, s, k, w32, False))


@pytest.mark.parametrize("name", list(_encode_cases()))
def test_plain_encode_matches_jax_on_hard_inputs(name):
    """The plain encode (the encode kernel's oracle), alone and as a batch
    of three, against JAX's `_encode_with_tables_body` (XLA path)."""
    c = _encode_cases()[name]
    s, k, off = c["s"], c["k"], c["offset"]
    w32 = (s * 15 + 31) // 32 + 1
    x = torch.from_numpy(c["data"])[off:]
    enc = table_build.build_coding_device(torch.from_numpy(c["hist"]))["enc_table"]
    words, bits = encode.encode_lanes(x, enc, s, k, w32)
    jw, jb = _jax_encode(s, k, w32)(jnp.asarray(c["data"][off:]), jnp.asarray(enc.numpy()))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    three = torch.stack([x, x.flip(0), x.roll(1)])
    bw, bb = encode.encode_lanes_batch(three, enc.expand(3, 256), s, k, w32)
    for i in range(3):
        jw, jb = _jax_encode(s, k, w32)(jnp.asarray(three[i].numpy()), jnp.asarray(enc.numpy()))
        np.testing.assert_array_equal(bw[i].numpy().view(np.uint32), np.asarray(jw))
        np.testing.assert_array_equal(bb[i].numpy(), np.asarray(jb))


def test_lane_skewed_block_spreads_the_lanes_of_a_warp():
    s, k = 40, 64
    data = kernel_cases.lane_skewed_block(s, k)
    t = table_build.build_coding_device(torch.from_numpy(kernel_cases.fibonacci_hist()))
    lens = (t["enc_table"] & 15).numpy()[data].reshape(s, k)
    assert set(np.unique(lens)) == {1, 15}
    bits = lens.sum(axis=0)
    assert bits[:32].min() == s and bits[:32].max() == 15 * s


HIST_BLOCKS = ["constant", "uniform"] + list(_encode_cases())


@pytest.mark.parametrize("stride", [1, 32])
@pytest.mark.parametrize("name", HIST_BLOCKS)
def test_plain_table_hist_matches_jax_on_hard_inputs(name, stride):
    """The plain sampled and full counts against JAX's `_table_hist`,
    on blocks of a ragged length (70,001 bytes: four sample rows) and on
    the encode's inputs (an offset view among them)."""
    if name in _encode_cases():
        buf, off = _encode_cases()[name]["data"], _encode_cases()[name]["offset"]
    else:
        buf, off = kernel_cases.hist_blocks(70001)[name], 0
    got = lookup.table_hist(torch.from_numpy(buf)[off:], stride)
    want = jtc._table_hist(jnp.asarray(buf[off:]), stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    assert len(variants) == len(kernel_ab.SPLIT) >= 3
    for text in variants.values():
        assert len(text.splitlines()) == len(src.splitlines())
        assert sum(a != b for a, b in zip(text.splitlines(), src.splitlines())) == 1


def test_kernel_ab_first_level_share_counts_the_short_codes():
    from huffman_tpu_torch.tools import kernel_ab

    lengths = np.zeros((2, 256), np.int64)
    lengths[:, :3] = [[1, 11, 12], [2, 2, 1]]
    counts = np.zeros((2, 256), np.int64)
    counts[:, :3] = [[5, 3, 2], [1, 1, 0]]
    assert kernel_ab.first_level_share(lengths, counts, 11) == 10 / 12
    assert kernel_ab.first_level_share(lengths, counts, 12) == 1.0
    assert kernel_ab.first_level_share(lengths[0], counts[0], 10) == 0.5
    assert kernel_ab.lut_bits(_source("decode_lanes")) == decode_bits.LUT_BITS
    assert kernel_ab.lut_bits("no constant") is None


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


def test_kernel_ab_encode_split_replaces_one_line_each():
    from huffman_tpu_torch.tools import kernel_ab

    src = _source("encode_lanes")
    variants = kernel_ab.split_variants(src, kernel_ab.ENCODE_SPLIT)
    assert len(variants) == len(kernel_ab.ENCODE_SPLIT) >= 3
    for text in variants.values():
        assert len(text.splitlines()) == len(src.splitlines())
        assert sum(a != b for a, b in zip(text.splitlines(), src.splitlines())) == 1


def test_kernel_ab_encode_sweep_changes_one_constant_each():
    from huffman_tpu_torch.tools import kernel_ab

    src = _source("encode_lanes")
    variants = kernel_ab.sweep_variants(src, kernel_ab.ENCODE_SWEEP)
    assert set(kernel_ab.ENCODE_SWEEP) == {"kTileLanes", "kStageRows", "kGroupRows"}
    assert len(variants) == sum(len(v) for v in kernel_ab.ENCODE_SWEEP.values())
    for label, text in variants.items():
        name, value = label.split("=")
        assert f"constexpr int {name} = {value};" in text
        assert sum(a != b for a, b in zip(text.splitlines(), src.splitlines())) == 1


def test_kernel_ab_covers_the_redesigned_kernels():
    from huffman_tpu_torch.tools import kernel_ab

    assert {"encode_lanes", "hist256"} <= set(kernel_ab.KERNELS)
    for name in kernel_ab.KERNELS:
        assert f'extern "C" int {name}_launch(' in _source(name)


def test_kernel_ab_races_hist256_onehot():
    from huffman_tpu_torch.ops import _cuda
    from huffman_tpu_torch.tools import kernel_ab

    assert "hist256_onehot" in kernel_ab.KERNELS
    assert len(_cuda.ENTRIES["hist256_onehot"].argtypes) == 5
    assert 'extern "C" int hist256_onehot_launch(const void* data, long long n, int variant,' \
        in _source("hist256_onehot")


def test_kernel_ab_counts_the_sass_of_a_warp_step():
    from huffman_tpu_torch.tools import kernel_ab

    lines = ["MOV R1, c[0x0][0x28]"]  # before the loop
    lines += ["PRMT R2, R3, R4, R5", "SHFL.IDX PT, R6, R7, R8, 0x1f"] * 2  # the loop: 0x10
    lines += ["IMMA.16832.S8.S8 R8, R2.ROW, R4.COL, R8"] * 8
    lines += ["@!P0 BRA 0x100", "ATOMS.ADD RZ, [R9], R10", "ATOMS.ADD RZ, [R9+0x4], R10"]
    lines += ["IADD3 R11, R11, 0x1, RZ", "@P1 BRA 0x10", "EXIT"]
    sass = "\tFunction : _ZN12_GLOBAL__N_121hist256_onehot_kernelILi0EEEvPKjxPi\n" + "\n".join(
        f"        /*{16 * i:04x}*/                   {ln} ;" for i, ln in enumerate(lines))
    counts = kernel_ab.sass_step_counts(sass)["s8"]
    assert counts["total"] == 15 / 2 and counts["IMMA"] == 4 and counts["PRMT"] == 1
    assert "ATOMS" not in counts and "MOV" not in counts and "EXIT" not in counts
