"""The plain reference against the program's plain CPU path at small
sizes, and against its own writer."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import ROOT

from hbench import reference as R

SAMPLE = {"row_bytes": 512, "every_nth_row": 32, "from_bytes": 4 << 20, "plus_one": 1}


def _data(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "biased":
        p = 0.8 ** np.arange(256) * 0.2
        return rng.choice(256, n, p=p / p.sum()).astype(np.uint8)
    if kind == "text":
        text = np.fromfile(f"{ROOT}/hbench/data/corpus.bin", np.uint8)
        return text[(rng.integers(0, len(text)) + np.arange(n)) % len(text)]
    if kind == "uniform":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "two":
        return rng.choice(np.array([7, 200], np.uint8), n)
    return np.full(n, 42, np.uint8)


CASES = [("biased", 8192, 64), ("text", 65536, 1024), ("uniform", 20000, 64),
         ("two", 4096, 32), ("biased", 4 << 20, 32768), ("text", 100000, 1024),
         ("one", 5000, 64)]


@pytest.mark.parametrize("kind,n,k", CASES)
def test_reference_equals_the_program(kind, n, k):
    from huffman_tpu_torch.models.torch_codec import TorchCodec

    data = _data(kind, n, n + k)
    codec = TorchCodec(k, device="cpu")
    comp = codec.encode_device(torch.from_numpy(data.copy()))
    padded = R.pad_lanes(data[None], k)
    tab = R.code_table(R.table_histogram(padded[0], n, SAMPLE))
    words, bits = R.encode_lanes(padded, tab["lens"][None], tab["codes"][None], k)
    assert np.array_equal(tab["enc"], comp.tables["enc_table"].numpy())
    assert np.array_equal(words[0], comp.words.numpy().view(np.uint32))
    assert np.array_equal(bits[0], comp.bit_counts.numpy())
    got = R.read_htp3(codec.serialize(comp))
    assert np.array_equal(got["raw"], data)
    if tab["ranked"].size > 1:
        assert np.array_equal(got["bits"], bits[0]) and np.array_equal(got["lens"], tab["lens"])
    if kind != "one":
        own = R.write_htp3(n, k, tab, words[0], bits[0])
        assert np.array_equal(R.read_htp3(own)["raw"], data)
        assert codec.decompress(own) == data.tobytes()


def test_container_of_the_program_reads_back():
    from huffman_tpu_torch.models.torch_codec import TorchCodec

    data = _data("text", (3 << 16) + 777, 3)
    codec = TorchCodec(1024, device="cpu")
    codec.block_bytes = 1 << 16
    blob = codec.compress(data.tobytes())
    raw, blocks = R.read_container(blob)
    assert raw == data.tobytes() and len(blocks) >= 3
    own = R.write_container([(len(data), R.write_htp3(
        len(data), 1024, *_table_words(data, 1024)))], data.tobytes(), 1 << 16)
    assert R.read_container(own)[0] == data.tobytes()


def _table_words(data, k):
    padded = R.pad_lanes(data[None], k)
    tab = R.code_table(R.table_histogram(padded[0], len(data), None))
    words, bits = R.encode_lanes(padded, tab["lens"][None], tab["codes"][None], k)
    return tab, words[0], bits[0]


def test_count_blob_reads_the_programs_counts():
    from huffman_tpu_torch import native

    rng = np.random.default_rng(0)
    for n in (1, 9, 1000, 131072):
        d = np.minimum(rng.geometric(0.05, n), 255).astype(np.uint8)
        assert np.array_equal(R.read_count_blob(native.compress(d.tobytes(), 8)), d)


def test_huffman_lengths_match_a_brute_force_optimum():
    rng = np.random.default_rng(1)
    for _ in range(200):
        h = rng.integers(0, 50, 256) * (rng.random(256) < 0.1)
        if np.count_nonzero(h) < 2:
            continue
        t = R.code_table(h)
        w = R.code_table(h, 15)["lens"]
        assert (t["len_count"] << (15 - np.arange(16))).sum() == 1 << 15
        # Huffman's cost by merging the two least weights (the optimum).
        import heapq

        q = [int(x) for x in h[h > 0]]
        heapq.heapify(q)
        cost = 0
        while len(q) > 1:
            a, b = heapq.heappop(q), heapq.heappop(q)
            cost += a + b
            heapq.heappush(q, a + b)
        if w.max() < 15:
            assert int((h * w).sum()) == cost


@pytest.mark.parametrize("cut", [0, 3, 15, 20, -1])
def test_truncated_or_corrupt_blob_is_refused_or_differs(cut):
    data = _data("biased", 8192, 9)
    tab, words, bits = _table_words(data, 64)
    blob = bytearray(R.write_htp3(len(data), 64, tab, words, bits))
    if cut == -1:
        blob[-10] ^= 0x10
        try:
            got = R.read_htp3(bytes(blob))["raw"]
        except ValueError:
            return
        assert not np.array_equal(got, data)
    else:
        with pytest.raises((ValueError, IndexError, Exception)):
            R.read_htp3(bytes(blob[:cut]))
