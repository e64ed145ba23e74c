"""`TorchCodec.decode_device` on a card (``ops.decode_bits.decode_block``),
on the CPU.

The C entry ``decode_lanes_launch`` runs only on a card, so here it is a
stand-in: a Python model of it that reads the words and tables and writes
the output through the raw pointers it is given, by the plain decode.
Blocks whose tensors report themselves on a card (`_OnCard`, from the
compress chain's tests) send ``decode_device`` down its card path against
it.  Held here: the bytes equal the plain decode's and the CPU codec's;
one C call, one launch and one "prepared" count a request, into the
output it returns; a malformed block refused before any C call; no state
kept on the block; the empty and one-symbol blocks as before; the span
and the counters.
"""

import dataclasses
import struct
import types

import numpy as np
import pytest
import torch
from test_torch_encode_chain import STAND_INS, _OnCard, _read, _write

from huffman_tpu_torch import TorchCodec, tracing
from huffman_tpu_torch.bench import kernel_cases
from huffman_tpu_torch.models.torch_codec import FLAG_COMPACT, MAGIC
from huffman_tpu_torch.ops import _cuda, decode_bits
from huffman_tpu_torch.ops.decode_bits import decode_lanes_batch_plain, decode_lanes_plain
from huffman_tpu_torch.ops.encode_chain import encode_pages

torch.set_num_threads(2)


def _decode_lanes(words, bcount, pitch, n_words, k, e_bound, g_rank, syms, s, out, stream):
    """``decode_lanes_launch`` as ``csrc/decode_lanes.cu`` declares it."""
    w = _read(words, bcount * pitch * k, torch.int32).view(bcount, pitch, k)
    tables = [_read(p, bcount * n, torch.int32).view(bcount, n)
              for p, n in ((e_bound, 17), (g_rank, 16), (syms, 256))]
    _write(out, decode_lanes_batch_plain(w, *tables, s, n_words))
    SEEN.append({"out": out, "bcount": bcount, "pitch": pitch, "n_words": n_words, "k": k,
                 "s": s})
    return 0


#: The stand-in's calls since the fixture's start.
SEEN: list = []


@pytest.fixture
def card(monkeypatch):
    """The stand-in for the built C entry, zeroed counters, the recorder off."""
    monkeypatch.setattr(_cuda, "load", lambda: {"decode_lanes": _decode_lanes})
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    for counts in (_cuda.LAUNCHES, _cuda.CALLS, _cuda.DECODE_PATHS):
        for key in counts:
            monkeypatch.setitem(counts, key, 0)
    SEEN.clear()
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _biased(seed: int, n: int) -> np.ndarray:
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    return np.random.default_rng(seed).choice(256, size=n, p=p).astype(np.uint8)


def _on_card(comp):
    """The block with every tensor reporting itself on a card."""
    return dataclasses.replace(
        comp, words=comp.words.as_subclass(_OnCard),
        bit_counts=comp.bit_counts.as_subclass(_OnCard),
        tables={key: t.as_subclass(_OnCard) for key, t in comp.tables.items()},
    )


def _block(codec, raw: np.ndarray, source: str):
    """A CPU block of ``raw``: `encode_device`'s, or that one serialized
    and parsed back."""
    comp = codec.encode_device(torch.from_numpy(raw))
    return comp if source == "encode_device" else codec.deserialize(codec.serialize(comp))


def _counts() -> tuple[dict, dict, dict]:
    nonzero = lambda d: {key: c for key, c in d.items() if c}  # noqa: E731
    return nonzero(_cuda.CALLS), nonzero(_cuda.LAUNCHES), nonzero(_cuda.DECODE_PATHS)


@pytest.mark.parametrize("source", ["encode_device", "deserialize"])
@pytest.mark.parametrize("last_row", ["full", "partial"])
@pytest.mark.parametrize("k", [64, 512])
def test_prepared_path_equals_plain_decode_and_cpu_codec(source, last_row, k, card):
    n = 48 * k - (0 if last_row == "full" else 37)
    raw = _biased(k + n, n)
    codec = TorchCodec(k, device="cpu")
    comp = _block(codec, raw, source)
    want = codec.decode_device(comp)
    assert _counts() == ({}, {}, {})  # a CPU block takes the CPU path
    t = comp.tables
    plain = decode_lanes_plain(comp.words, t["e_bound"], t["g_rank"], t["sorted_syms"], 48)
    got = codec.decode_device(_on_card(comp))
    assert got.dtype == torch.uint8 and got.shape == (n,) and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(got, plain.reshape(-1)[:n])
    assert got.numpy().tobytes() == raw.tobytes()
    (seen,) = SEEN
    assert seen["bcount"] == 1 and seen["k"] == k and seen["s"] == 48
    assert seen["pitch"] == seen["n_words"] == comp.words.shape[0]
    # The output is the allocation the C call wrote, or a view of its first n bytes.
    assert got.data_ptr() == seen["out"]
    assert got.untyped_storage().nbytes() == 48 * k and got.storage_offset() == 0


@pytest.mark.parametrize("requests", [1, 3])
def test_one_c_call_and_one_launch_a_request(requests, card):
    codec = TorchCodec(64, device="cpu")
    comp = _on_card(_block(codec, _biased(1, 64 * 40), "encode_device"))
    for _ in range(requests):
        codec.decode_device(comp)
    assert _counts() == ({"decode_lanes": requests}, {"decode_lanes": requests},
                         {"prepared": requests})
    assert len(SEEN) == requests


def _wrong_dtype(comp):
    return dataclasses.replace(comp, words=comp.words.to(torch.int64).as_subclass(_OnCard))


def _short_e_bound(comp):
    return dataclasses.replace(comp, tables=comp.tables | {"e_bound": comp.tables["e_bound"][:16]})


def _noncontiguous_words(comp):
    words = comp.words.as_subclass(torch.Tensor)
    strided = torch.empty(words.shape[::-1], dtype=words.dtype).t()
    strided.copy_(words)
    return dataclasses.replace(comp, words=strided.as_subclass(_OnCard))


def _words_on_the_cpu(comp):
    return dataclasses.replace(comp, words=comp.words.as_subclass(torch.Tensor))


def _other_lane_count(comp):
    return dataclasses.replace(comp, k=comp.k * 2)


MALFORMED = {
    "words int64": (_wrong_dtype, "words must be torch.int32"),
    "e_bound of 16": (_short_e_bound, r"e_bound must have shape \(17,\)"),
    "non-contiguous words": (_noncontiguous_words, "words must be contiguous"),
    "words on the CPU": (_words_on_the_cpu, "words must be a CUDA tensor"),
    "words of another lane count": (_other_lane_count, r"words must have shape \(W, 128\)"),
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_block_raises_before_any_c_call(name, card):
    spoil, message = MALFORMED[name]
    codec = TorchCodec(64, device="cpu")
    comp = spoil(_on_card(_block(codec, _biased(2, 64 * 40), "deserialize")))
    with pytest.raises(ValueError, match=message):
        codec.decode_device(comp)
    assert SEEN == [] and _counts() == ({}, {}, {})


@pytest.mark.parametrize("source", ["encode_device", "deserialize"])
def test_fresh_and_repeated_blocks_take_the_same_path(source, card):
    codec = TorchCodec(64, device="cpu")
    raw = _biased(3, 64 * 40)
    fresh = _on_card(_block(codec, raw, source))
    fields = {f.name for f in dataclasses.fields(fresh)}
    before = {key: v for key, v in vars(fresh).items() if key != "_meta"}
    seen = []
    for _ in range(3):
        out = codec.decode_device(fresh)
        assert out.numpy().tobytes() == raw.tobytes()
        seen.append(_counts())
    assert seen == [({"decode_lanes": i}, {"decode_lanes": i}, {"prepared": i}) for i in (1, 2, 3)]
    # Nothing kept on the block but the metadata `meta` caches, as before.
    assert set(vars(fresh)) == fields
    assert all(vars(fresh)[key] is v for key, v in before.items())


def _one_symbol(sym: int | None, n: int) -> bytes:
    """An HTP3 blob of ``n`` bytes coded with one zero-length code for
    ``sym`` (none at all where None): no bit counts, no payload."""
    mask, table = (0, b"") if sym is None else (1, bytes([1, sym]))
    return struct.pack("<IIII", MAGIC, n, 64, mask | FLAG_COMPACT) + table


# name -> (a CPU block of the codec, the bytes it decodes to).  The
# encoder gives even a one-symbol input two 1-bit codes, so the
# one-symbol blocks come from blobs.
DEGENERATE = {
    "empty, encode_device": (lambda c: c.encode_device(torch.zeros(0, dtype=torch.uint8)), b""),
    "empty, deserialize": (lambda c: c.deserialize(_one_symbol(None, 0)), b""),
    "one symbol": (lambda c: c.deserialize(_one_symbol(97, 3000)), b"a" * 3000),
    "no symbol": (lambda c: c.deserialize(_one_symbol(None, 100)), bytes(100)),
}


@pytest.mark.parametrize("name", list(DEGENERATE))
def test_empty_and_one_symbol_blocks_launch_nothing(name, card):
    make, raw = DEGENERATE[name]
    codec = TorchCodec(64, device="cpu")
    comp = make(codec)
    want = codec.decode_device(comp)
    got = codec.decode_device(_on_card(comp))
    assert got.dtype == want.dtype == torch.uint8 and torch.equal(got, want)
    assert got.numpy().tobytes() == raw
    assert SEEN == [] and _counts() == ({}, {}, {"checked": 1})


@pytest.mark.parametrize("on", [False, True])
def test_the_c_call_is_a_span_while_on(on, card, monkeypatch):
    codec = TorchCodec(64, device="cpu")
    comp = _on_card(_block(codec, _biased(4, 64 * 40), "deserialize"))
    if on:
        tracing.enable()
    else:
        def refuse(*args, **kwargs):
            raise AssertionError("a span site called into the profiler or read a clock")

        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    codec.decode_device(comp)
    tracing.disable()
    table = {key: stat.count for key, stat in tracing.snapshot().items()}
    assert table == ({(None, "device_api.decode_device"): 1,
                      ("device_api.decode_device", "launch.decode_lanes"): 1} if on else {})


def test_a_failed_launch_raises_and_counts_nothing(card, monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda: {"decode_lanes": lambda *a: 700})
    codec = TorchCodec(64, device="cpu")
    comp = _on_card(_block(codec, _biased(5, 64 * 40), "deserialize"))
    with pytest.raises(RuntimeError, match="decode_lanes failed to launch: error 700"):
        codec.decode_device(comp)
    assert _counts() == ({}, {}, {})


def test_reset_launches_clears_decode_paths(monkeypatch):
    for path in _cuda.DECODE_PATHS:
        monkeypatch.setitem(_cuda.DECODE_PATHS, path, 5)
    _cuda.reset_launches()
    assert _cuda.DECODE_PATHS == {"prepared": 0, "checked": 0}


class _OnOtherCard(_OnCard):
    """A CPU tensor that says it is on the second card."""

    def get_device(self):
        return 1


def test_the_ops_keep_their_checked_path(card, monkeypatch):
    """`decode_lanes` on a card takes `decode_block`, and
    `decode_lanes_batch` launches through `_cuda.launch`; neither counts
    in `DECODE_PATHS`."""
    blocks, launched = [], []
    block, launch = decode_bits.decode_block, _cuda.launch
    monkeypatch.setattr(decode_bits, "decode_block", lambda *a: blocks.append(a[4:]) or block(*a))
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, *args: launched.append(entry) or launch(entry, *args))
    codec = TorchCodec(64, device="cpu")
    comp = _on_card(_block(codec, _biased(6, 64 * 40), "deserialize"))
    t = comp.tables
    tabs = (t["e_bound"], t["g_rank"], t["sorted_syms"])
    out = decode_bits.decode_lanes(comp.words, *tabs, 40)
    assert blocks == [(64, 40, 40 * 64)] and launched == ["decode_lanes"]
    assert out.shape == (40, 64) and out.dtype == torch.uint8 and out.is_contiguous()
    assert torch.equal(out, decode_lanes_plain(comp.words, *tabs, 40))
    batch = decode_bits.decode_lanes_batch(
        comp.words[None], *(x[None] for x in tabs), 40, comp.words.shape[0])
    assert blocks == [(64, 40, 40 * 64)] and launched == ["decode_lanes"] * 2
    assert batch.shape == (1, 40, 64) and torch.equal(batch[0], out)
    assert _counts()[2] == {}
    with pytest.raises(ValueError, match="e_bound must have shape"):
        decode_bits.decode_lanes(comp.words, t["e_bound"][:16], t["g_rank"], t["sorted_syms"], 40)
    # Tables on another card than the words are refused as decode_device refuses them.
    with pytest.raises(ValueError, match="g_rank must be on"):
        decode_bits.decode_lanes(comp.words, t["e_bound"], t["g_rank"].as_subclass(_OnOtherCard),
                                 t["sorted_syms"], 40)
    assert launched == ["decode_lanes"] * 2 and len(SEEN) == 2


def _put(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


def _cases() -> dict:
    """name -> (a call of the codec on tensors passed through ``on`` (`_put`
    them on the card, or leave them), returning a tensor; the C entries it
    calls; the kernels it launches; its DECODE_PATHS)."""
    codec = TorchCodec(64, device="cpu")
    raw = torch.from_numpy(_biased(7, 64 * 40))
    comp = _block(codec, raw.numpy(), "deserialize")
    pages = raw.view(2, 64 * 20)
    words, bits, tables = codec.encode_batch(pages)
    shared = codec.build_tables(torch.arange(256, dtype=torch.uint8))
    tabs = (comp.tables["e_bound"], comp.tables["g_rank"], comp.tables["sorted_syms"])
    return {
        "encode_device": (lambda on: codec.encode_device(on(raw)).words,
                          ["encode_chain"], ("hist256", "table_build", "encode_lanes"), {}),
        "encode_device(tables=)": (
            lambda on: codec.encode_device(on(raw), {k: on(t) for k, t in shared.items()}).words,
            ["encode_lanes"], ("encode_lanes",), {}),
        "encode_batch": (lambda on: codec.encode_batch(on(pages))[0], ["encode_chain_batch"],
                         ("hist256_batch", "table_build", "encode_lanes"), {}),
        "decode_device": (
            lambda on: codec.decode_device(dataclasses.replace(
                comp, words=on(comp.words), bit_counts=on(comp.bit_counts),
                tables={k: on(t) for k, t in comp.tables.items()})),
            ["decode_lanes"], ("decode_lanes",), {"prepared": 1}),
        "decode_batch": (
            lambda on: codec.decode_batch(on(words), on(bits), {k: on(t) for k, t in tables.items()},
                                          64 * 20),
            ["decode_lanes"], ("decode_lanes",), {}),
        "decode_lanes": (lambda on: decode_bits.decode_lanes(on(comp.words), *map(on, tabs), 40),
                         ["decode_lanes"], ("decode_lanes",), {}),
    }


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("name", list(_cases()))
def test_every_c_call_goes_through_launch(name, spans, card, monkeypatch):
    """Each device-API method on the card crosses into C only through
    `_cuda.launch`: the stand-ins see exactly the entries `launch` was
    given, and the counts and spans are those of those entries."""
    run, entries, kernels, paths = _cases()[name]
    plain = run(lambda t: t)
    called, launched = [], []
    stand_ins = STAND_INS | {"decode_lanes": _decode_lanes}
    monkeypatch.setattr(_cuda, "load", lambda: {
        e: (lambda *a, e=e, f=f: called.append(e) or f(*a)) for e, f in stand_ins.items()})
    launch = _cuda.launch
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, *args: launched.append(entry) or launch(entry, *args))
    if spans:
        tracing.enable()
    got = run(_put)
    tracing.disable()
    assert torch.equal(got, plain)
    assert called == launched == entries
    assert _counts() == ({e: 1 for e in entries}, {k: 1 for k in kernels}, paths)
    opened = [key[1] for key in tracing.snapshot() if key[1].startswith("launch.")]
    assert opened == ([_cuda.ENTRIES[e].span for e in entries] if spans else [])


# ------------------------------------------------------------- the kernel on a card


@pytest.fixture
def cuda():
    """The first CUDA card, or a skip: the decode kernel runs only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU build")
    return torch.device("cuda")


# name -> (blocks (B, s*k) uint8 as numpy, s, k, whether they are coded
# with the Fibonacci table (else each with its own), whether rows of
# garbage follow the words the decode reads).  The Fibonacci table gives
# symbols 12-19 15-bit codes, 9 of its 20 symbols codes longer than the
# kernel's first level: `kernel_cases.escape_block` feeds them uniformly,
# `kernel_cases.lane_skewed_block` feeds the 15-bit ones to odd lanes at a
# rate that steps with the lane.
CARD_CASES = {
    "16 MiB, K = 131072, s = 128": (lambda: _biased(1, 16 << 20)[None], 128, 131072, False, False),
    "B = 160, K = 1024, s = 100": (
        lambda: np.stack([_biased(b, 100 << 10) for b in range(160)]), 100, 1024, False, False),
    "B = 64, K = 4096, s = 256": (
        lambda: np.stack([_biased(b, 1 << 20) for b in range(64)]), 256, 4096, False, False),
    "K not a multiple of the threads a block": (
        lambda: np.stack([_biased(b, 77 * 1500) for b in range(3)]), 77, 1500, False, False),
    "escape-heavy block": (
        lambda: kernel_cases.escape_block(128 * 131072)[None], 128, 131072, True, False),
    "15-bit codes": (
        lambda: np.stack([kernel_cases.lane_skewed_block(96, 2048, b) for b in range(4)]),
        96, 2048, True, False),
    "words past n_words read as zero": (
        lambda: np.stack([_biased(b, 100 << 10) for b in range(16)]), 100, 1024, False, True),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_equals_plain_decode_on_the_card(name, cuda):
    from huffman_tpu_torch.ops import encode, table_build

    make, s, k, fibonacci, garbage = CARD_CASES[name]
    blocks = torch.from_numpy(make()).to(cuda)
    bcount, w32 = blocks.shape[0], (s * 15 + 31) // 32 + 1
    if fibonacci:
        fib = torch.from_numpy(np.tile(kernel_cases.fibonacci_hist(), (bcount, 1))).to(cuda)
        tables = table_build.build_coding_device_batch(fib.to(torch.int32))
        words, bits = encode.encode_lanes_batch(blocks, tables["enc_table"], s, k, w32)
    else:
        words, bits, tables = encode_pages(blocks, s, k, w32)
    tabs = [tables[key].contiguous() for key in ("e_bound", "g_rank", "sorted_syms")]
    w = w32
    if garbage:
        # Rows from w on hold random words that the decode must not read.
        w = int((bits.max() + 31) // 32)
        junk = np.random.default_rng(5).integers(-2**31, 2**31, size=(bcount, w32 - w, k))
        words[:, w:] = torch.from_numpy(junk.astype(np.int32)).to(cuda)
    got = decode_bits.decode_lanes_batch(words, *tabs, s, w)
    want = decode_lanes_batch_plain(words, *tabs, s, w)
    assert torch.equal(got, want)
    assert torch.equal(got.reshape(bcount, -1), blocks)
    if bcount == 1:
        one = decode_bits.decode_block(words[0], *(t[0] for t in tabs), k, s, s * k)
        assert torch.equal(one, want.reshape(-1))


@pytest.mark.card
@pytest.mark.parametrize("k", [1024, 131072])
def test_kernel_decodes_a_partial_last_row_on_the_card(k, cuda):
    n = 40 * k - 37
    raw = _biased(k, n)
    codec = TorchCodec(k, device="cuda")
    comp = codec.encode_device(torch.from_numpy(raw).to(cuda))
    got = codec.decode_device(comp)
    t = comp.tables
    plain = decode_lanes_plain(comp.words, t["e_bound"], t["g_rank"], t["sorted_syms"], 40)
    assert got.shape == (n,) and torch.equal(got, plain.reshape(-1)[:n])
    assert got.cpu().numpy().tobytes() == raw.tobytes()


@pytest.mark.card
@pytest.mark.parametrize("name", ["sampled", "fibonacci", "one_bit", "equal", "single"])
def test_kernel_decodes_every_window_on_the_card(name, cuda):
    """Lane i starts with the 15-bit window i mod 2^15; later bits random."""
    data = torch.from_numpy(_biased(0, 16 << 20)).to(cuda)
    from huffman_tpu_torch.ops import lookup, table_build

    hist = lookup.table_hist(data, 32).cpu().numpy()
    h = kernel_cases.decode_hists(hist)[name]
    t = table_build.build_coding_device(torch.from_numpy(h.astype(np.int32)).to(cuda))
    tabs = [t[key] for key in ("e_bound", "g_rank", "sorted_syms")]
    words = torch.from_numpy(kernel_cases.window_words(rows=4)).to(cuda)
    got = decode_bits.decode_lanes(words, *tabs, 4)
    assert torch.equal(got, decode_lanes_plain(words, *tabs, 4))
