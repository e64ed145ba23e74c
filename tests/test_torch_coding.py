"""The port's host modules of the ``ref`` profile (``coding``, ``format``,
``ops/tables`` and ``golden``) against ``huffman_tpu``'s on the same
inputs: the reference's corpus and the 2,000 generated histograms of
``bench.kernel_cases.table_hists``.  Tolerance: exact (equal dataclass
fields, equal bytes, the same ValueError messages).
"""

import dataclasses
import functools

import numpy as np
import pytest

from corpus import long_codes, standard_cases
from huffman_tpu import coding as jcoding, format as jfmt, golden as jgolden, native as jnative
from huffman_tpu.ops import tables as jtables
from huffman_tpu_torch import coding, format as fmt, golden
from huffman_tpu_torch.bench import kernel_cases
from huffman_tpu_torch.constants import MAX_CODE_LEN
from huffman_tpu_torch.ops import tables

CASES = standard_cases()
NAMES = [name for name, _ in CASES]
KS = [1, 4, 32, 256]
CHUNKS = 4
# The ref profile's build, and the tpu profile's (15 bits over clamped counts).
BUILDS = {"ref 12-bit": {}, "clamped 15-bit": {"max_len": 15, "clamp": True}}


@functools.lru_cache(maxsize=None)
def _table_hists():
    return kernel_cases.table_hists()


def _assert_coding_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _hists():
    return {name: jcoding.histogram(raw) for name, raw in CASES}


@pytest.mark.parametrize("name", NAMES)
def test_coding_matches_on_corpus(name):
    raw = dict(CASES)[name]
    hist = coding.histogram(raw)
    np.testing.assert_array_equal(hist, jcoding.histogram(raw))
    assert hist.dtype == np.uint32
    for kw in BUILDS.values():
        cc = coding.make_canonical_coding(hist, **kw)
        _assert_coding_equal(cc, jcoding.make_canonical_coding(hist, **kw))
        for got, want in zip(
            coding.decode_tables_1x(cc.len_count, cc.sorted_syms)
            + coding.decode_tables_2x(cc.len_count, cc.sorted_syms),
            jcoding.decode_tables_1x(cc.len_count, cc.sorted_syms)
            + jcoding.decode_tables_2x(cc.len_count, cc.sorted_syms),
        ):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tables.pack_encode_table(cc), jtables.pack_encode_table(cc))


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_coding_matches_on_generated_hists(build, chunk):
    h = _table_hists()
    size = len(h) // CHUNKS
    for row in h[chunk * size : (chunk + 1) * size]:
        _assert_coding_equal(
            coding.make_canonical_coding(row, **BUILDS[build]),
            jcoding.make_canonical_coding(row, **BUILDS[build]),
        )


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_decode_tables_match_on_generated_hists(chunk):
    h = _table_hists()
    size = len(h) // (8 * CHUNKS)  # every 8th row: the 2x table is slow to build
    for row in h[::8][chunk * size : (chunk + 1) * size]:
        cc = coding.make_canonical_coding(row)
        np.testing.assert_array_equal(
            tables.pack_decode_table(cc.len_count, cc.sorted_syms),
            jtables.pack_decode_table(cc.len_count, cc.sorted_syms),
        )
        np.testing.assert_array_equal(tables.pack_encode_table(cc), jtables.pack_encode_table(cc))


def test_long_codes_need_the_repair():
    """The reference's LongCodes input: its unlimited tree is 15 deep, so
    the 12-bit build folds and repairs, as the JAX package does."""
    hist = coding.histogram(long_codes())
    order = np.argsort(-hist.astype(np.int64), kind="stable")
    raw_lens = coding._huffman_code_lengths(hist[order][hist[order] > 0])
    assert raw_lens.max() > MAX_CODE_LEN
    np.testing.assert_array_equal(
        raw_lens, jcoding._huffman_code_lengths(hist[order][hist[order] > 0])
    )
    cc = coding.make_canonical_coding(hist)
    assert cc.code_lens.max() == MAX_CODE_LEN
    lc = np.bincount(raw_lens, minlength=coding.MAX_OPTIMAL_CODE_LEN + 1)
    np.testing.assert_array_equal(
        coding.limit_code_lengths(lc), jcoding.limit_code_lengths(lc)
    )


def test_clamp_and_code_assignment_match():
    for row in _table_hists()[:200]:
        np.testing.assert_array_equal(coding.clamp_hist(row, 15), jcoding.clamp_hist(row, 15))
        cc = jcoding.make_canonical_coding(row, max_len=15, clamp=True)
        for got, want in zip(
            coding.assign_canonical_codes(cc.len_count, cc.sorted_syms, 15),
            jcoding.assign_canonical_codes(cc.len_count, cc.sorted_syms, 15),
        ):
            np.testing.assert_array_equal(got, want)


def test_unpack_decode_entry_matches():
    cc = coding.make_canonical_coding(_hists()["lorem"])
    packed = tables.pack_decode_table(cc.len_count, cc.sorted_syms)
    for got, want in zip(tables.unpack_decode_entry(packed), jtables.unpack_decode_entry(packed)):
        np.testing.assert_array_equal(got, want)


def test_slice_and_region_sizes_match():
    for n in (0, 1, 7, 1000, 65536, 100003):
        for k in (1, 3, 32, 4096):
            np.testing.assert_array_equal(fmt.slice_sizes(n, k), jfmt.slice_sizes(n, k))
    bits = np.random.default_rng(0).integers(0, 1 << 20, 500)
    np.testing.assert_array_equal(fmt.stream_region_sizes(bits), jfmt.stream_region_sizes(bits))


@pytest.mark.parametrize("k", KS)
def test_golden_and_headers_match_on_corpus(k):
    for name, raw in CASES:
        blob = golden.compress(raw, k)
        assert blob == jgolden.compress(raw, k), name
        assert golden.decompress(blob, k) == raw, name
        h, jh = fmt.parse_header(blob, k), jfmt.parse_header(blob, k)
        for f in dataclasses.fields(jh):
            a, b = getattr(h, f.name), getattr(jh, f.name)
            if f.name == "payload":
                assert bytes(a) == bytes(b)
            elif isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        cc = coding.make_canonical_coding(coding.histogram(raw))
        assert fmt.write_header(
            len(raw), cc.len_count, cc.len_mask, cc.sorted_syms, h.end_offsets
        ) == blob[: len(blob) - len(h.payload)], name


def _outcome(fn, blob):
    try:
        out = fn(blob)
    except ValueError as e:
        return ("ValueError", str(e))
    if isinstance(out, fmt.ParsedHeader) or isinstance(out, jfmt.ParsedHeader):
        return ("header", out.raw_size, out.num_syms, out.len_count.tolist(),
                out.sorted_syms.tolist(), out.end_offsets.tolist(), bytes(out.payload))
    return ("bytes", out)


def _mutations(kind: str, blob: bytes):
    """The malformed blobs of tests/test_fuzz.py's ref-profile check."""
    rng = np.random.default_rng(7)
    out = []
    if kind == "header bytes":
        for _ in range(30):
            bad = bytearray(blob)
            i = int(rng.integers(0, min(64, len(bad))))
            bad[i] ^= int(rng.integers(1, 256))
            out.append(bytes(bad))
    elif kind == "any byte":
        for _ in range(15):
            bad = bytearray(blob)
            i = int(rng.integers(0, len(bad)))
            bad[i] ^= int(rng.integers(1, 256))
            out.append(bytes(bad))
    else:
        out = [blob[:cut] for cut in range(min(len(blob), 80))]
    return out


@pytest.mark.parametrize("kind", ["header bytes", "any byte", "truncations"])
def test_malformed_ref_blobs_fail_alike(kind):
    """Each corruption either raises the same ValueError in both packages
    or parses and decodes to the same bytes."""
    raw = (b"the quick brown fox " * 600)[:3_000]
    k = 8
    for bad in _mutations(kind, golden.compress(raw, k)):
        assert _outcome(lambda b: fmt.parse_header(b, k), bad) == _outcome(
            lambda b: jfmt.parse_header(b, k), bad
        )
        assert _outcome(lambda b: golden.decompress(b, k), bad) == _outcome(
            lambda b: jgolden.decompress(b, k), bad
        )


def test_truncated_native_blob_raises_alike():
    raw = b"some data to compress" * 100
    blob = jnative.compress(raw, 4)
    got = _outcome(lambda b: fmt.parse_header(b, 4), blob[:10])
    assert got[0] == "ValueError"
    assert got == _outcome(lambda b: jfmt.parse_header(b, 4), blob[:10])
    assert _outcome(lambda b: golden.decompress(b, 4), blob[:10]) == got


def test_golden_codec_facade():
    c = golden.GoldenCodec(16)
    raw = dict(CASES)["biased"]
    assert c.name == jgolden.GoldenCodec(16).name
    assert c.compress(raw) == jgolden.GoldenCodec(16).compress(raw)
    assert c.decompress(c.compress(raw)) == raw
