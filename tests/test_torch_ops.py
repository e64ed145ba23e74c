"""Each module of huffman_tpu_torch that holds a kernel, held against its
huffman_tpu counterpart on the same numpy inputs.  Tolerance: exact
(every value is an integer or a byte).

On the CPU the port runs its kernels' plain PyTorch versions; the JAX
side runs as its own CPU tests run it: the XLA path, which
test_pallas_interpret.py shows is bit-identical to the Pallas kernels,
and the Pallas table kernels in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu import coding
from huffman_tpu.models import tpu_codec as jtc
from huffman_tpu.ops import decode_bits as jdb
from huffman_tpu.ops import lookup as jlookup
from huffman_tpu.ops import table_build as jtb
from huffman_tpu_torch.ops import decode_bits, encode, lookup, table_build

torch.set_num_threads(2)

L = 15


def _fib(n):
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return f[:n]


# ---------------------------------------------------------------- histogram

# (n, pad, hist_stride): sampled and unsampled, with and without a zero pad.
HIST_CASES = [
    (1000, 0, 1),
    (70001, 71, 1),
    (600_000, 0, 2),
    (5 * 512 * 32 + 300, 0, 32),
    (5 * 512 * 32 + 300, 4000, 32),
    (512 * 32 - 1, 1, 32),  # below one sample row: counts every byte
]


@pytest.mark.parametrize("n,pad,stride", HIST_CASES)
def test_table_hist_matches_jax(n, pad, stride):
    rng = np.random.default_rng(n)
    p = 0.8 ** np.arange(256) * 0.2
    x = np.concatenate(
        [rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8), np.zeros(pad, np.uint8)]
    )
    got = lookup.table_hist(torch.from_numpy(x), stride).numpy()
    want = np.asarray(jtc._table_hist(jnp.asarray(x), stride))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("n", [1, 513, 100_000])
def test_histogram256_matches_jax(n):
    x = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    np.testing.assert_array_equal(
        lookup.histogram256(torch.from_numpy(x)).numpy(),
        np.asarray(jlookup.histogram256(jnp.asarray(x))),
    )


def test_histogram256_empty():
    got = lookup.histogram256(torch.zeros(0, dtype=torch.uint8))
    assert got.shape == (256,) and int(got.sum()) == 0


# ---------------------------------------------------------------- table build

def _corpus_hists():
    from corpus import standard_cases

    return {
        f"corpus_{name}": np.bincount(np.frombuffer(raw, np.uint8), minlength=256)
        for name, raw in standard_cases()
    }


TABLE_CASES = {
    "empty": np.zeros(256, np.int64),
    "single": np.eye(1, 256, 65, dtype=np.int64).ravel() * 1000,
    "two": np.array([0] * 254 + [3, 9]),
    "uniform": np.full(256, 17),
    "fibonacci": np.array(_fib(20)[::-1] + [0] * 236),  # needs the 15-bit repair
    "geometric": (0.8 ** np.arange(256) * 1e6).astype(np.int64),
    "long_codes": np.array(
        [2**21, 2**19, 2**17, 2**14, 2**11, 2**9, 2**5, 2**2, 2, 1, 1, 1] + [0] * 244
    ),
    **_corpus_hists(),
}


def _random_hists():
    rng = np.random.default_rng(7)
    out = []
    for i in range(24):
        h = np.zeros(256, np.int64)
        active = rng.choice(256, size=int(rng.integers(1, 257)), replace=False)
        h[active] = [
            rng.integers(1, 100, size=len(active)),
            rng.integers(1, 2**21, size=len(active)),
            np.ones(len(active), np.int64),
            rng.geometric(0.01, size=len(active)),
        ][i % 4]
        out.append(h)
    return out


def _port_tables(hist):
    t = table_build.build_coding_device(torch.from_numpy(np.asarray(hist, np.int64)))
    return {k: v.numpy() for k, v in t.items()}


def _assert_tables_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_fibonacci_case_needs_the_repair():
    lens = coding._huffman_code_lengths(np.sort(TABLE_CASES["fibonacci"])[::-1][:20])
    assert lens.max() > L
    assert _port_tables(TABLE_CASES["fibonacci"])["len_count"][L] > 0


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_table_build_matches_jax(name):
    hist = TABLE_CASES[name]
    want = jtb.build_coding_device(jnp.asarray(hist, jnp.int32), serial_tree=False)
    _assert_tables_equal(_port_tables(hist), want)


def test_table_build_random_matches_jax():
    for hist in _random_hists():
        want = jtb.build_coding_device(jnp.asarray(hist, jnp.int32), serial_tree=False)
        _assert_tables_equal(_port_tables(hist), want)


@pytest.mark.parametrize("fused", [False, True], ids=["tree_kernel", "fused_kernel"])
def test_table_build_matches_pallas_kernels(fused):
    """The port's one table kernel against both Pallas table kernels
    (_tree_kernel and _full_table_kernel), in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    for hist in [TABLE_CASES[k] for k in ("empty", "single", "two", "fibonacci", "geometric")]:
        with pltpu.force_tpu_interpret_mode():
            want = jtb.build_coding_device(
                jnp.asarray(hist, jnp.int32), serial_tree=True, fused=fused
            )
            want = {k: np.asarray(v) for k, v in want.items()}
        _assert_tables_equal(_port_tables(hist), want)


def test_table_build_cpu_accepts_int32_and_int64():
    h = TABLE_CASES["geometric"]
    a = table_build.build_coding_flat(torch.from_numpy(h.astype(np.int32)))
    b = table_build.build_coding_flat(torch.from_numpy(h.astype(np.int64)))
    assert a.dtype == torch.int32 and a.shape == (table_build.TABLE_LEN,)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- encode / decode

@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_encode(padded, enc_table, s, k, w32):
    return jtc._encode_with_tables_body(padded, enc_table, s, k, w32, False)


def _block(kind, s, k):
    """(data (s*k,) uint8, JAX table dict) for an encode/decode case."""
    rng = np.random.default_rng(s * 1000 + k)
    if kind == "biased":
        p = 0.8 ** np.arange(256) * 0.2
        data = rng.choice(256, size=s * k, p=p / p.sum()).astype(np.uint8)
        hist = np.bincount(data, minlength=256)
    elif kind == "long_codes":
        # A table that reaches 15 bits, fed its symbols uniformly: most
        # codes are long, so lanes approach s*15 bits.
        hist = np.array(_fib(20)[::-1] + [0] * 236)
        data = rng.integers(0, 20, size=s * k).astype(np.uint8)
    else:  # "one_bit": two symbols, 1-bit codes
        hist = np.zeros(256, np.int64)
        hist[[7, 200]] = [5, 3]
        data = rng.choice(np.array([7, 200], np.uint8), size=s * k)
    return data, jtb.build_coding_device(jnp.asarray(hist, jnp.int32), serial_tree=False)


CODE_CASES = [("biased", 32, 1024), ("long_codes", 16, 1024), ("one_bit", 9, 24)]


@pytest.mark.parametrize("kind,s,k", CODE_CASES)
def test_encode_lanes_matches_jax(kind, s, k):
    data, t = _block(kind, s, k)
    w32 = (s * L + 31) // 32 + 1
    words, bits = encode.encode_lanes(
        torch.from_numpy(data), torch.tensor(np.asarray(t["enc_table"])), s, k, w32
    )
    jw, jb = _jax_encode(jnp.asarray(data), t["enc_table"], s, k, w32)
    assert words.shape == (w32, k) and words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind,s,k", CODE_CASES)
def test_decode_lanes_matches_jax(kind, s, k):
    data, t = _block(kind, s, k)
    w32 = (s * L + 31) // 32 + 1
    jw, jb = _jax_encode(jnp.asarray(data), t["enc_table"], s, k, w32)
    m = {
        "max_bits": int(np.asarray(jb).max()),
        "l_min": int(t["l_min"]),
        "num_syms": int(t["num_syms"]),
        "len_count": np.asarray(t["len_count"]),
        "sorted_syms": np.asarray(t["sorted_syms"]),
    }
    group, w, spec, ident, slots, rd = jtc.decode_statics(m, s)
    words = jnp.concatenate([jw, jnp.zeros((max(w - w32, 0), k), jw.dtype)])
    want = np.asarray(
        jtc._decode_full(
            words, t["e_bound"], t["g_rank"], t["sorted_syms"], s, s * k, group, w,
            spec, ident, jb, slots, rd,
        )
    )
    got = decode_bits.decode_lanes(
        torch.tensor(np.asarray(jw).view(np.int32)),
        *(torch.tensor(np.asarray(t[key])) for key in ("e_bound", "g_rank", "sorted_syms")),
        s,
    )
    assert got.shape == (s, k) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    np.testing.assert_array_equal(want, data)


def test_decode_lanes_reads_zeros_past_the_words():
    """Lanes whose words stop early decode as if zero words followed."""
    data, t = _block("one_bit", 9, 24)
    w32 = (9 * L + 31) // 32 + 1
    words, _ = encode.encode_lanes(
        torch.from_numpy(data), torch.tensor(np.asarray(t["enc_table"])), 9, 24, w32
    )
    tabs = [torch.tensor(np.asarray(t[k])) for k in ("e_bound", "g_rank", "sorted_syms")]
    full = decode_bits.decode_lanes(words, *tabs, 9)
    assert torch.equal(decode_bits.decode_lanes(words[:1].contiguous(), *tabs, 9), full)


@pytest.mark.parametrize(
    "len_count",
    [[0, 2], [0, 1, 1], [0, 0, 2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 3, 18, 0, 0], [1]],
    ids=["1bit", "2bit", "15bit", "single"],
)
def test_decode_tables_match_jax(len_count):
    syms = np.arange(sum(len_count), dtype=np.uint8)[::-1]
    got = decode_bits.decode_tables_bitserial(len_count, syms)
    want = jdb.decode_tables_bitserial(len_count, syms)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
