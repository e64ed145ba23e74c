"""ops/hist_variants.py against the TPU histogram race's kernel.

The same numpy inputs go through ``tools/hist_experiments.py:hist_variant``
(the Pallas kernel, run in interpret mode as the JAX package's own CPU
tests run its kernels), the port's `hist_variant` on a CPU tensor (its
plain version) and ``huffman_tpu.ops.lookup.histogram256``.  Tolerance:
exact (counts).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from huffman_tpu.ops import lookup as jlookup
from huffman_tpu_torch.bench import workloads
from huffman_tpu_torch.ops import _cuda, hist_variants

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_hist_experiments", os.path.join(REPO, "tools", "hist_experiments.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()

INPUTS = {
    "biased 2^19": lambda: workloads.biased_u8(1 << 19, 1),
    "uniform 2^20": lambda: np.random.default_rng(2).integers(0, 256, 1 << 20, dtype=np.uint8),
    "constant 2^19": lambda: np.full(1 << 19, 0x5A, np.uint8),
    "all 0xFF 2^19": lambda: np.full(1 << 19, 0xFF, np.uint8),
    "every byte value in turn 2^19": lambda: np.arange(1 << 19, dtype=np.uint32).astype(np.uint8),
}


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("variant", list(hist_variants.VARIANTS))
def test_hist_variant_matches_jax(variant, name):
    x = INPUTS[name]()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JAX_TOOL.hist_variant(jnp.asarray(x), variant))
    got = hist_variants.hist_variant(torch.from_numpy(x), variant)
    assert got.dtype == torch.int32 and tuple(got.shape) == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlookup.histogram256(jnp.asarray(x))))


@pytest.mark.parametrize("mma", hist_variants.MMA_TYPES)
def test_mma_types_count_alike(mma):
    x = np.random.default_rng(3).integers(0, 256, 1 << 19, dtype=np.uint8)
    got = hist_variants.hist_variant(torch.from_numpy(x), mma)
    np.testing.assert_array_equal(got.numpy(), np.bincount(x, minlength=256))


def test_variant_map():
    assert {v: hist_variants.mma_type(v) for v in hist_variants.VARIANTS} == {
        "base": "bf16", "bf16cmp": "bf16", "wide": "bf16", "f32cmp": "tf32", "i8dot": "s8",
    }
    assert all(hist_variants.mma_type(m) == m for m in hist_variants.MMA_TYPES)
    assert hist_variants.CHUNK == JAX_TOOL.CHUNK


@pytest.mark.parametrize("n", [0, (1 << 19) - 1, (1 << 19) + 64, 3 << 18])
def test_length_off_the_chunk_grid_raises(n):
    with pytest.raises(ValueError, match="multiple"):
        hist_variants.hist_variant(torch.zeros(n, dtype=torch.uint8), "base")


@pytest.mark.parametrize("variant", ["fp8", "Base", ""])
def test_unknown_variant_raises(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.uint8), variant)


def test_wrong_dtype_raises():
    with pytest.raises(ValueError, match="uint8"):
        hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.int32), "i8dot")


class _FakeCudaTensor(torch.Tensor):
    """Stands in for a CUDA tensor on a machine without CUDA: n zero bytes
    in CPU memory that report themselves on a card."""

    @staticmethod
    def __new__(cls, n):
        return torch.zeros(n, dtype=torch.uint8).as_subclass(cls)

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_takes_the_kernel(monkeypatch):
    """A CUDA tensor goes to the kernel (here: its build, which raises
    without nvcc), never to the plain version."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    monkeypatch.setattr(hist_variants, "hist_variant_plain", plain)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        hist_variants.hist_variant(_FakeCudaTensor(1 << 19), "i8dot")
    assert _cuda.LAUNCHES == before


def test_cpu_tensor_launches_nothing():
    before = dict(_cuda.LAUNCHES)
    hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.uint8), "wide")
    assert _cuda.LAUNCHES == before


# ------------------------------------------------- the kernel's one-hot lookups
# csrc/hist256_onehot.cu builds its one-hot fragments with PTX prmt.b32
# lookups; here its selector packing and tables are run through a numpy
# model of prmt's default mode.  Tolerance: exact (bytes).


def _prmt(a, b, sel, replicate=True):
    """PTX prmt.b32 in its default mode (``replicate``) or CUDA's
    __byte_perm (selector bits 2:0 only): result byte i is byte s_i & 7
    of (a, b), where s_i is nibble i of the low 16 bits of ``sel``; with
    bit 3 of s_i set, prmt replicates that byte's msb instead."""
    a, b, sel = (np.asarray(v, np.uint64) for v in (a, b, sel))
    src = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b, sel).shape, np.uint64)
    for i in range(4):
        s_i = (sel >> np.uint64(4 * i)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (s_i & np.uint64(7)))) & np.uint64(0xFF)
        if replicate:
            byte = np.where(s_i & np.uint64(8), np.where(byte & np.uint64(0x80), 0xFF, 0), byte)
        out |= byte.astype(np.uint64) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _selectors(w):
    """The kernel's `selectors`: lo nibbles in bits 0-15, hi in 16-31."""
    w = np.asarray(w, np.uint32)
    lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
    return _prmt(lo | lo >> 4, hi | hi >> 4, 0x6420, replicate=False)


def _table(g, one):
    """Row g's table (tlo, thi): byte g is ``one``, the others 0."""
    return (one << (8 * g) if g < 4 else 0), (0 if g < 4 else one << (8 * (g - 4)))


# Every byte value at each of a word's four positions.
_K = np.arange(256, dtype=np.uint32)
_BYTES = np.stack([_K, _K ^ 0x5A, 255 - _K, (_K * 7) & 255], axis=1)
_WORDS = (_BYTES << np.array([0, 8, 16, 24], np.uint32)).sum(axis=1).astype(np.uint32)


@pytest.mark.parametrize("one", [0x01, 0x3F])
def test_prmt_lookup_is_the_nibble_one_hot(one):
    s = _selectors(_WORDS)
    r = _prmt(s, 0, 0x1032, replicate=False)  # halves swapped: hi nibbles low
    for g in range(8):
        tlo, thi = _table(g, one)
        for name, sel, nib in (("hi", r, _BYTES >> 4), ("lo", s, _BYTES & 15)):
            for row, flip in ((g, 0), (g + 8, 0x8888)):
                got = _prmt(tlo, thi, sel ^ flip)
                got_bytes = (got[:, None] >> np.array([0, 8, 16, 24], np.uint32)) & 0xFF
                want = np.where(nib == row, one, 0)
                assert np.array_equal(got_bytes, want), (name, g, row)


def test_byte_perm_alone_would_not_zero_the_high_nibbles():
    """Why the lookup is inline PTX: without msb replication a nibble
    n >= 8 would select byte n & 7, so row g would also count n = g + 8."""
    tlo, thi = _table(3, 1)
    assert _prmt(tlo, thi, 0xBBBB) == 0
    assert _prmt(tlo, thi, 0xBBBB, replicate=False) == 0x01010101


def test_widened_lookups_are_bf16_and_tf32_halves():
    """bf16 pairs (selectors 0x1404, 0x3424) and tf32 words (0x0444 | i << 12)
    of looked-up bytes 0x3F / 0 hold 0.5 / 0.0, which the flush scales by 4."""
    s = _selectors(_WORDS)
    for g in range(8):
        tlo, thi = _table(g, 0x3F)
        x = _prmt(tlo, thi, s)
        want = np.where((_BYTES & 15) == g, 0.5, 0.0)
        pairs = [_prmt(x, 0, sel, replicate=False) for sel in (0x1404, 0x3424)]
        bf16 = np.stack([(p << 16) for q in pairs for p in (q & 0xFFFF, q >> 16)], axis=1)
        assert np.array_equal(bf16.astype(np.uint32).view(np.float32), want)
        tf32 = np.stack([_prmt(x, 0, 0x0444 | i << 12, replicate=False) for i in range(4)],
                        axis=1)
        assert np.array_equal(tf32.view(np.float32), want)


def _lanes(x, n):
    """The n-bit lanes of the uint32 x, lowest first."""
    return [int(x) >> (n * e) & ((1 << n) - 1) for e in range(32 // n)]


def _value(bits, mma):
    """A fragment element's bits as the number the MMA multiplies."""
    if mma == "s8":
        return float(np.int8(np.uint8(bits)))
    shift = 16 if mma == "bf16" else 0
    return float(np.uint32(bits << shift).view(np.float32))


def _warp_step(lane_words, mma):
    """The kernel's 16 x 16 sums for one 128-byte warp step, lane l
    holding ``lane_words[l]``: its 32 threads build their fragments as the
    kernel does (selectors, shuffles, prmt lookups, widening), the
    mma.sync layouts of PTX place them, and the flush's scale is applied."""
    one = 0x01 if mma == "s8" else 0x3F
    s = _selectors(np.asarray(lane_words, np.uint32))
    r = _prmt(s, 0, 0x1032, replicate=False)
    kdepth = {"s8": 32, "bf16": 16, "tf32": 8}[mma]
    mmas = {}  # (half, step) -> (A 16 x k, B k x 16)
    for half in range(2):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            tlo, thi = _table(g, one)
            src = [16 * half + 4 * j + t for j in range(4)]
            ah = [_prmt(tlo, thi, r[i]) for i in src]
            ah8 = [_prmt(tlo, thi, r[i] ^ 0x8888) for i in src]
            bl = [_prmt(tlo, thi, s[i]) for i in src]
            bl8 = [_prmt(tlo, thi, s[i] ^ 0x8888) for i in src]
            frags = []  # per mma: (a0, a1, a2, a3, b0 of tile 0, b1, b0 of tile 1, b1)
            if mma == "s8":
                for x, y in ((0, 1), (2, 3)):
                    frags.append((ah[x], ah8[x], ah[y], ah8[y], bl[x], bl[y], bl8[x], bl8[y]))
            elif mma == "bf16":
                for i in range(4):
                    frags.append(tuple(_prmt(v, 0, sel, replicate=False) for v, sel in (
                        (ah[i], 0x1404), (ah8[i], 0x1404), (ah[i], 0x3424), (ah8[i], 0x3424),
                        (bl[i], 0x1404), (bl[i], 0x3424), (bl8[i], 0x1404), (bl8[i], 0x3424))))
            else:
                for i in range(4):
                    for b in (0, 2):
                        frags.append(tuple(
                            _prmt(v, 0, 0x0444 | e << 12, replicate=False) for v, e in (
                                (ah[i], b), (ah8[i], b), (ah[i], b + 1), (ah8[i], b + 1),
                                (bl[i], b), (bl[i], b + 1), (bl8[i], b), (bl8[i], b + 1))))
            n = {"s8": 4, "bf16": 2, "tf32": 1}[mma]  # elements per register
            for step, f in enumerate(frags):
                a, bm = mmas.setdefault((half, step), (np.zeros((16, kdepth)),
                                                       np.zeros((kdepth, 16))))
                for e in range(n):  # k of element e: n*t + e, and + kdepth / 2 in a2, a3, b1
                    k0, k1 = n * t + e, n * t + e + kdepth // 2
                    a[g, k0], a[g + 8, k0], a[g, k1], a[g + 8, k1] = (
                        _value(_lanes(f[q], 32 // n)[e], mma) for q in range(4))
                    bm[k0, g], bm[k1, g], bm[k0, g + 8], bm[k1, g + 8] = (
                        _value(_lanes(f[q], 32 // n)[e], mma) for q in range(4, 8))
    c = sum(a @ bm for a, bm in mmas.values())
    return c * (1 if mma == "s8" else 4)


@pytest.mark.parametrize("mma", hist_variants.MMA_TYPES)
def test_warp_step_of_the_kernel_counts_its_bytes(mma):
    """A 512-byte iteration of the main loop (lane l loads words 4l..4l+3,
    word u in step u) and a 128-byte step of the tail (thread (g, t) loads
    word g & 3 of t's 16 bytes of chunk g >> 2) count their bytes."""
    rng = np.random.default_rng(10)
    for data in (rng.integers(0, 256, 512, dtype=np.uint8), np.arange(512, dtype=np.uint8),
                 np.full(512, 0xFF, np.uint8)):
        words = data.view("<u4")
        got = sum(_warp_step(words[4 * np.arange(32) + u], mma) for u in range(4))
        np.testing.assert_array_equal(got, np.bincount(data, minlength=256).reshape(16, 16))
        lanes = np.arange(32)
        g, t = lanes >> 2, lanes & 3
        tail = words[(g >> 2) * 16 + t * 4 + (g & 3)]
        np.testing.assert_array_equal(
            _warp_step(tail, mma), np.bincount(data[:128], minlength=256).reshape(16, 16))
