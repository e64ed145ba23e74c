"""The compress chain of huffman_tpu_torch (``ops/encode_chain.py``, the
C entries of ``csrc/encode_chain.cu``) on the CPU.

The C entries run only on a card, so here they are stand-ins: Python
models of ``encode_chain.cu`` and of the four kernels' entries that read
their inputs and write their outputs through the raw pointers they are
given, by the kernels' plain versions.  A CPU tensor that reports itself
on a card (`_OnCard`) sends the wrappers' host code down its CUDA path
against them.  Held here: the allocation's layout; that the chain's
words, bit counts and tables equal the per-kernel path's and the plain
path's exactly, in the keys, shapes, dtypes and contiguity of
``build_coding_device(_batch)``; the counters, the error and the span of
a chain call; and which inputs take the chain.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from huffman_tpu_torch import TorchCodec, tracing
from huffman_tpu_torch.constants import TPU_MAX_CODE_LEN
from huffman_tpu_torch.ops import _cuda, encode, encode_chain, lookup, table_build
from huffman_tpu_torch.ops.encode import encode_lanes_batch_plain
from huffman_tpu_torch.ops.lookup import HIST_ROW

torch.set_num_threads(2)

K = 64


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card."""

    @property
    def is_cuda(self):
        return True


def _read(ptr: int, count: int, dtype) -> torch.Tensor:
    return torch.frombuffer(bytearray(ctypes.string_at(ptr, count * dtype.itemsize)), dtype=dtype)


def _write(ptr: int, t: torch.Tensor) -> None:
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def _hist256(data, rows, row_len, pitch, last_len, bias, out, stream):
    x = _read(data, (rows - 1) * pitch + last_len, torch.uint8)
    counted = torch.cat(
        [x[r * pitch : r * pitch + (last_len if r == rows - 1 else row_len)] for r in range(rows)]
    )
    _write(out, (torch.bincount(counted.long(), minlength=256) + bias).int())
    return 0


def _hist256_batch(data, bcount, n, out, stream):
    x = _read(data, bcount * n, torch.uint8).view(bcount, n).long()
    rows = [torch.bincount(r, minlength=256) for r in x]
    _write(out, torch.stack(rows).int())
    return 0


def _table_build(hist, bcount, out, stream):
    hists = _read(hist, bcount * 256, torch.int32).view(bcount, 256)
    _write(out, table_build.build_coding_plain_batch(hists))
    return 0


def _encode_lanes(padded, enc, bcount, s, k, w32, words, bits, stream):
    blocks = _read(padded, bcount * s * k, torch.uint8).view(bcount, s * k)
    tabs = _read(enc, bcount * 256, torch.int32).view(bcount, 256)
    w, b = encode_lanes_batch_plain(blocks, tabs, s, k, w32)
    _write(words, w)
    _write(bits, b)
    return 0


def _chain(padded, rows, row_len, pitch, last_len, bias, s, k, w32, hist, table, words, bits,
           stream):
    """``encode_chain_launch`` as ``csrc/encode_chain.cu`` writes it."""
    return (_hist256(padded, rows, row_len, pitch, last_len, bias, hist, stream)
            or _table_build(hist, 1, table, stream)
            or _encode_lanes(padded, table, 1, s, k, w32, words, bits, stream))


def _chain_batch(blocks, bcount, s, k, w32, hist, table, words, bits, stream):
    """``encode_chain_batch_launch``."""
    return (_hist256_batch(blocks, bcount, s * k, hist, stream)
            or _table_build(hist, bcount, table, stream)
            or _encode_lanes(blocks, table, bcount, s, k, w32, words, bits, stream))


#: The C entries that queue a whole compress request: those of the table
#: that launch more than one kernel.
CHAINS = [entry for entry, e in _cuda.ENTRIES.items() if len(e.kernels) > 1]

STAND_INS = {
    "hist256": _hist256, "hist256_batch": _hist256_batch, "table_build": _table_build,
    "encode_lanes": _encode_lanes, "encode_chain": _chain, "encode_chain_batch": _chain_batch,
}


@pytest.fixture
def card(monkeypatch):
    """Stand-ins for the built C entries, zeroed counters, the recorder off."""
    monkeypatch.setattr(_cuda, "load", lambda: STAND_INS)
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    for name in _cuda.LAUNCHES:
        monkeypatch.setitem(_cuda.LAUNCHES, name, 0)
    for entry in _cuda.CALLS:
        monkeypatch.setitem(_cuda.CALLS, entry, 0)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _biased(seed: int, n: int) -> np.ndarray:
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    return np.random.default_rng(seed).choice(256, size=n, p=p).astype(np.uint8)


def _w32(s: int) -> int:
    return (s * TPU_MAX_CODE_LEN + 31) // 32 + 1


def _calls() -> dict:
    return {e: c for e, c in _cuda.CALLS.items() if c}


@pytest.mark.parametrize("k", [1024, 131072])
@pytest.mark.parametrize("bcount", [1, 16, 160])
def test_layout_is_aligned_and_disjoint(bcount, k):
    s = 100
    w32 = _w32(s)
    bits, table, hist, total = encode_chain.layout(bcount, w32, k)
    regions = [(0, bcount * w32 * k), (bits, bcount * k), (table, bcount * table_build.TABLE_LEN),
               (hist, bcount * 256)]
    for (start, size), (nxt, _) in zip(regions, regions[1:]):
        assert start + size <= nxt
    assert all(start % encode_chain.ALIGN == 0 for start, _ in regions)
    assert encode_chain.ALIGN * 4 == 256 and total == hist + bcount * 256
    # The views, on a meta allocation: each inside its region, contiguous,
    # in the shapes of `table_build._unpack`.
    (_, _, _, _), views = encode_chain._views(bcount, w32, k, bcount > 1)
    arena = torch.empty(total, dtype=torch.int32, device="meta")
    flat = torch.empty(bcount * table_build.TABLE_LEN, dtype=torch.int32, device="meta")
    want = table_build._unpack(flat, bcount if bcount > 1 else None)
    got = {key: arena.as_strided(shape, st, off) for key, shape, st, off in views}
    lead = (bcount,) if bcount > 1 else ()
    assert got.pop("words").shape == lead + (w32, k)
    assert got.pop("bit_counts").shape == lead + (k,)
    assert list(got) == list(want)
    for key, t in got.items():
        assert t.shape == want[key].shape and t.is_contiguous(), key
        assert table <= t.storage_offset() and t.storage_offset() + t.numel() <= hist, key
        assert t.storage_offset() - table == want[key].storage_offset(), key


# name -> (k, s, hist_stride): the 1-in-32 row sample; every byte; every
# byte with a partial last row of 384 bytes.
BLOCKS = {"sampled": (K, 512, 32), "every byte": (K, 64, 1), "partial last row": (K, 70, 1)}


def _same(got: tuple, want: tuple) -> None:
    """(words, bit counts, tables dict) equal, in the same keys, shapes,
    dtypes and contiguity."""
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)
    assert list(got[2]) == list(want[2])
    for key, w in want[2].items():
        g = got[2][key]
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), key
        assert torch.equal(g, w), key


def _one_allocation(outs: list) -> None:
    """Every output a view of one allocation, the words at its start and
    each view's offset a multiple of 256 bytes."""
    base = outs[0].untyped_storage().data_ptr()
    assert outs[0].data_ptr() == base
    for t in outs:
        assert t.untyped_storage().data_ptr() == base
    for t in outs[1:3]:  # the bit counts and the table buffer's first field
        assert (t.data_ptr() - base) % 256 == 0


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_chain_equals_per_kernel_and_plain_paths(name, card):
    k, s, stride = BLOCKS[name]
    raw = torch.from_numpy(_biased(len(name), s * k))
    assert (s * k) % HIST_ROW == (384 if name == "partial last row" else 0)
    codec = TorchCodec(k, hist_stride=stride, device="cpu")
    plain = codec.encode_device(raw)
    on_card = raw.as_subclass(_OnCard)
    chain = codec.encode_device(on_card)
    assert _calls() == {"encode_chain": 1}
    assert {n: c for n, c in _cuda.LAUNCHES.items() if c} == {
        "hist256": 1, "table_build": 1, "encode_lanes": 1}
    # The per-kernel path through the same stand-ins: three C calls.
    tables = table_build.build_coding_device(
        lookup.table_hist(on_card, stride).as_subclass(_OnCard))
    enc = tables["enc_table"].as_subclass(_OnCard)
    per_kernel = (*encode.encode_lanes(on_card, enc, s, k, _w32(s)), tables)
    assert _calls() == {"encode_chain": 1, "hist256": 1, "table_build": 1, "encode_lanes": 1}
    want = (plain.words, plain.bit_counts, plain.tables)
    _same((chain.words, chain.bit_counts, chain.tables), want)
    _same(per_kernel, want)
    _one_allocation([chain.words, chain.bit_counts, *chain.tables.values()])


@pytest.mark.parametrize("bcount", [1, 3])
def test_pages_chain_equals_per_kernel_and_plain_paths(bcount, card):
    s = 16
    pages = torch.from_numpy(_biased(bcount, bcount * s * K).reshape(bcount, s * K))
    codec = TorchCodec(K, device="cpu")
    plain = codec.encode_batch(pages)
    on_card = pages.as_subclass(_OnCard)
    chain = codec.encode_batch(on_card)
    assert _calls() == {"encode_chain_batch": 1}
    assert {n: c for n, c in _cuda.LAUNCHES.items() if c} == {
        "hist256_batch": 1, "table_build": 1, "encode_lanes": 1}
    tables = table_build.build_coding_device_batch(
        lookup.histogram256_batch(on_card).as_subclass(_OnCard))
    enc = tables["enc_table"].as_subclass(_OnCard)
    per_kernel = (*encode.encode_lanes_batch(on_card, enc, s, K, _w32(s)), tables)
    _same(chain, plain)
    _same(per_kernel, plain)
    _one_allocation([chain[0], chain[1], *chain[2].values()])


@pytest.mark.parametrize("entry", CHAINS)
@pytest.mark.parametrize("on", [False, True])
def test_chain_call_counts_once_and_is_a_span_while_on(entry, on, monkeypatch):
    seen = []
    monkeypatch.setattr(_cuda, "load", lambda: {entry: lambda *a: seen.append(a) or 0})
    for name in _cuda.LAUNCHES:
        monkeypatch.setitem(_cuda.LAUNCHES, name, 0)
    monkeypatch.setitem(_cuda.CALLS, entry, 0)
    tracing.reset()
    if on:
        tracing.enable()
    else:
        def refuse(*args, **kwargs):
            raise AssertionError("a span site called into the profiler or read a clock")

        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    try:
        _cuda.launch(entry, 1, 2)
        table = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert seen == [(1, 2)] and _cuda.CALLS[entry] == 1
    kernels = _cuda.ENTRIES[entry].kernels
    assert {n: c for n, c in _cuda.LAUNCHES.items() if c} == {n: 1 for n in kernels}
    assert len(kernels) == 3 and kernels[1:] == ("table_build", "encode_lanes")
    assert list(table) == ([(None, "launch.encode_chain")] if on else [])


@pytest.mark.parametrize("entry", CHAINS)
def test_chain_call_raises_on_a_nonzero_return(entry, monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda: {entry: lambda *a: 700})
    before = dict(_cuda.LAUNCHES), dict(_cuda.CALLS)
    with pytest.raises(RuntimeError, match="encode_chain failed to launch: error 700"):
        _cuda.launch(entry)
    assert (dict(_cuda.LAUNCHES), dict(_cuda.CALLS)) == before


def test_reset_launches_clears_calls(monkeypatch):
    for entry in _cuda.CALLS:
        monkeypatch.setitem(_cuda.CALLS, entry, 5)
    for name in _cuda.LAUNCHES:
        monkeypatch.setitem(_cuda.LAUNCHES, name, 5)
    _cuda.reset_launches()
    assert set(_cuda.CALLS.values()) == set(_cuda.LAUNCHES.values()) == {0}
    assert set(CHAINS) <= set(_cuda.CALLS) and set(_cuda.LAUNCHES) <= set(_cuda.CALLS)


# name -> (a compress of the CPU tensor or of the same bytes on a "card",
# the C entries it must call): the chain only for a tensor on a card whose
# table comes from its own bytes.
ENGAGES = {
    "cpu encode_device": (lambda c, x, p: c.encode_device(x), False, {}),
    "cpu encode_device(tables=)": (
        lambda c, x, p: c.encode_device(x, tables=c.build_tables(x)), False, {}),
    "cpu encode_batch": (lambda c, x, p: c.encode_batch(p), False, {}),
    "card encode_device": (lambda c, x, p: c.encode_device(x), True, {"encode_chain": 1}),
    "card encode_device(tables=)": (
        lambda c, x, p: c.encode_device(x, tables=_card_tables(c)), True, {"encode_lanes": 1}),
    "card encode_batch": (lambda c, x, p: c.encode_batch(p), True, {"encode_chain_batch": 1}),
}


def _card_tables(codec) -> dict:
    """A shared table, built on the CPU (no C call), as if on the card."""
    tables = codec.build_tables(torch.arange(256, dtype=torch.uint8))
    return {key: t.as_subclass(_OnCard) for key, t in tables.items()}


@pytest.mark.parametrize("name", list(ENGAGES))
def test_chain_engages_only_on_a_card_without_tables(name, card):
    compress, on_card, calls = ENGAGES[name]
    x = torch.from_numpy(_biased(9, 16 * K))
    pages = x.view(2, 8 * K)
    if on_card:
        x, pages = x.as_subclass(_OnCard), pages.as_subclass(_OnCard)
    compress(TorchCodec(K, device="cpu"), x, pages)
    assert _calls() == calls


# What the table gave before it was one record an entry: the kernels, the
# C entries, each entry's library, kernels and span.
KERNELS = ["hist256", "hist256_batch", "table_build", "encode_lanes", "decode_lanes",
           "hist256_onehot", "carry", "fold"]
MORE_ENTRIES = {
    "encode_lanes_rows": ("encode_chain", ("encode_lanes",), "launch.encode_lanes"),
    "encode_chain": ("encode_chain", ("hist256", "table_build", "encode_lanes"),
                     "launch.encode_chain"),
    "encode_chain_batch": ("encode_chain", ("hist256_batch", "table_build", "encode_lanes"),
                           "launch.encode_chain"),
}
LIBRARY_OF = {"hist256": "encode_chain", "hist256_batch": "encode_chain",
              "table_build": "encode_chain", "encode_lanes": "encode_chain",
              "decode_lanes": "decode_lanes", "hist256_onehot": "hist256_onehot",
              "carry": "bench_ops", "fold": "bench_ops"}


def test_the_table_derives_the_kernels_entries_and_spans():
    assert list(_cuda.LAUNCHES) == KERNELS
    assert list(_cuda.CALLS) == KERNELS + list(MORE_ENTRIES)
    assert CHAINS == ["encode_chain", "encode_chain_batch"]
    want = {k: (LIBRARY_OF[k], (k,), f"launch.{k}") for k in KERNELS} | MORE_ENTRIES
    got = {entry: (e.library, e.kernels, e.span) for entry, e in _cuda.ENTRIES.items()}
    assert got == want
    assert all(e.span == "launch." + e.name for e in _cuda.ENTRIES.values())
    assert {e.library for e in _cuda.ENTRIES.values()} == set(_cuda.LIBRARIES)


@pytest.mark.parametrize("entry", list(_cuda.ENTRIES))
def test_each_entry_has_the_arguments_its_source_declares(entry):
    """The record's argument types, one a parameter of ``<entry>_launch``
    in a source of its library, in its C types."""
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "const void* const*": ctypes.POINTER(ctypes.c_void_p),
             "const long long*": ctypes.POINTER(ctypes.c_longlong),
             "const int*": ctypes.POINTER(ctypes.c_int)}
    e = _cuda.ENTRIES[entry]
    decls = []
    for source in _cuda.LIBRARIES[e.library]:
        with open(f"{_cuda._CSRC}/{source}.cu") as f:
            text = f.read()
        for part in text.split(f'extern "C" int {entry}_launch(')[1:]:
            params = [" ".join(p.split()) for p in part[: part.index(")")].split(",")]
            decls.append([ctype[p.rsplit(" ", 1)[0]] for p in params])
    assert decls and all(d == e.argtypes for d in decls), decls
