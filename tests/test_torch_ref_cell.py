"""The benchmark's ``ref64k`` deployment and its cell ``ref64k.bytes``, the
``uniform`` source and the stored fallback, on the CPU at small sizes.

* The plain reference of the ref profile (``hbench/ref_reference.py``)
  against `TorchRefCodec`'s blobs, byte for byte, and against the JAX
  package's golden blobs; its reader of the codec's blobs.
* The profile's check (``hbench/profiles/ref.py``): every number 0 on the
  codec's blobs, and each planted fault moves its number.
* The uniform source, whose requests come back as stored records.
* The spans and counters of `TorchRefCodec` and of the stored fallback
  (``container.record``) at each writer of HTP3 blocks, and the three
  readers of the cell's per-layer metrics.
* One run of the cell through the harness from a copy of the benchmark
  whose ``ref64k`` configuration is cut to a small size.
"""

import ast
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from hbench import harness, reference, spec
from hbench import ref_reference as RR
from huffman_tpu import golden as jgolden
from huffman_tpu_torch import TorchCodec, TorchRefCodec, coding, container, tracing
from huffman_tpu_torch.models import torch_ref_codec
from huffman_tpu_torch.parallel import ShardedCodec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 26
ZERO = dict.fromkeys(("failed", "table_diff", "lane_diff", "blob_diff", "decode_diff"), 0)
#: The configurations cut to the tests' size: S = 256 bytes a stream as
#: in ``ref64k``; 64 KiB blocks.
SMALL = {"ref64k": {"unit_bytes": 1 << 16, "lanes": 256},
         "block16m": {"unit_bytes": 1 << 16, "block_bytes": 1 << 16, "lanes": 512}}
READERS = ("ref.host_waits.compress", "ref.host_waits.decompress", "ref.table_ms")


def _skewed(n: int, rng) -> bytes:
    """n bytes whose counts are the Fibonacci numbers (the most frequent
    symbol takes the rest), shuffled: from n ~ 1000 on the unlimited
    Huffman lengths pass 12 bits, so the MiniZ repair runs."""
    fib = [1, 1]
    while sum(fib) + fib[-1] + fib[-2] <= n:
        fib.append(fib[-1] + fib[-2])
    syms = (np.arange(len(fib), dtype=np.int64) * 7 + 3).astype(np.uint8)
    data = np.repeat(syms, fib[::-1])
    data = np.concatenate([data, np.full(max(n - len(data), 0), syms[0], np.uint8)])[:n]
    rng.shuffle(data)
    return data.tobytes()


def _inputs(k: int) -> dict[str, bytes]:
    rng = np.random.default_rng(SEED + k)
    corpus = np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8)
    return {
        "ragged": corpus[: 4 * k * 3 + 5].tobytes(),
        "four_k": corpus[1000 : 1000 + 4 * k].tobytes(),
        "4096_k": corpus[: 4096 * k].tobytes(),
        "skewed": _skewed(2000 * k + 3, rng),
        "uniform": rng.integers(0, 256, 4 * k * 7 + 1, dtype=np.uint8).tobytes(),
    }


CASES = [(k, name) for k in (8, 32, 1024) for name in _inputs(k)]


@pytest.fixture(scope="module")
def blobs():
    """Each case's codec blob, its decode, and the reference's blob."""
    out = {}
    for k in (8, 32, 1024):
        codec = TorchRefCodec(k, device="cpu")
        for name, raw in _inputs(k).items():
            blob = codec.compress(raw)
            out[k, name] = (raw, blob, codec.decompress(blob), RR.compress(raw, k))
    return out


# ---------- the plain reference ----------


@pytest.mark.parametrize("k,name", CASES, ids=[f"k{k}-{n}" for k, n in CASES])
def test_codec_blob_equals_the_reference(k, name, blobs):
    raw, blob, decoded, want = blobs[k, name]
    assert torch_ref_codec.device_path(len(raw), k)
    assert blob == want["blob"]
    assert decoded == raw


@pytest.mark.parametrize("k,name", CASES, ids=[f"k{k}-{n}" for k, n in CASES])
def test_reference_reads_the_codec_blob(k, name, blobs):
    raw, blob, _, _ = blobs[k, name]
    assert RR.read(blob, k).tobytes() == raw


def test_skewed_input_needs_the_repair():
    raw = np.frombuffer(_skewed(2000 * 32 + 3, np.random.default_rng(SEED)), np.uint8)
    t = RR.code_table(np.bincount(raw, minlength=256))
    unlimited = max(reference._huffman_depths(sorted(np.bincount(raw)[np.bincount(raw) > 0])))
    assert unlimited > RR.MAX_LEN and t["lens"].max() == RR.MAX_LEN
    assert int((t["len_count"] << (RR.MAX_LEN - np.arange(RR.MAX_LEN + 1))).sum()) == 1 << 12


@pytest.mark.parametrize("n,k", [(0, 8), (1, 8), (31, 8), (1000, 8), (1000, 1), (5003, 32),
                                 (4096, 1024), (1 << 15, 256)])
@pytest.mark.parametrize("kind", ["corpus", "skewed", "single", "uniform"])
def test_reference_equals_the_jax_golden(n, k, kind):
    """Ties the new reference to the JAX package: its blob is golden's."""
    rng = np.random.default_rng(SEED + n + k)
    raw = {
        "corpus": np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8,
                              count=n).tobytes(),
        "skewed": _skewed(n, rng),
        "single": b"q" * n,
        "uniform": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
    }[kind]
    blob = RR.compress(raw, k)["blob"]
    assert blob == jgolden.compress(raw, k)
    assert RR.read(blob, k).tobytes() == raw


def test_reference_imports_nothing_of_jax_or_the_program():
    """``ref_reference`` and the ``reference`` it reads import neither JAX
    nor either package (their import statements, read from the files)."""
    banned = ("jax", "jaxlib", "huffman_tpu", "huffman_tpu_torch")
    for name in ("ref_reference.py", "reference.py", "profiles/ref.py"):
        with open(os.path.join(REPO, "hbench", name)) as f:
            tree = ast.parse(f.read())
        top_level = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in top_level:
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(m.split(".")[0] in banned for m in mods), (name, mods)


# ---------- the profile's check ----------


def _tally(raw: bytes, blob: bytes, decoded: bytes | None = None, k: int = 32) -> dict:
    tally = spec.part("profiles", "ref").Tally({"lanes": k})
    a = np.frombuffer(raw, np.uint8)
    tally.blob(a, blob)
    if decoded is not None:
        tally.decoded(a[None], np.frombuffer(decoded, np.uint8)[None])
    return {name: v["value"] for name, v in tally.numbers().items()}


@pytest.mark.parametrize("k,name", CASES, ids=[f"k{k}-{n}" for k, n in CASES])
def test_codec_passes_the_check(k, name, blobs):
    raw, blob, decoded, _ = blobs[k, name]
    assert _tally(raw, blob, decoded, k) == ZERO


def _header_size(blob: bytes, k: int) -> int:
    h = RR.parse(blob, k)
    return len(blob) - len(h["payload"])


def test_flipped_payload_byte_moves_blob_diff(blobs):
    raw, blob, _, _ = blobs[32, "ragged"]
    bad = bytearray(blob)
    bad[-3] ^= 0x20  # inside stream 31, near its first bits
    got = _tally(raw, bytes(bad))
    assert got["blob_diff"] > 1 and got["table_diff"] == got["lane_diff"] == 0


@pytest.mark.parametrize("which", [0, 7, 30])
def test_flipped_end_offset_moves_blob_and_lane_diff(which, blobs):
    raw, blob, _, _ = blobs[32, "ragged"]
    at = _header_size(blob, 32) - 4 * 31 + 4 * which
    bad = bytearray(blob)
    bad[at] ^= 0x01
    got = _tally(raw, bytes(bad))
    assert got["blob_diff"] > 0 and got["lane_diff"] > 0


def _capped_at_11(monkeypatch):
    """Plant an 11-bit cap in the codec's table build: a valid table of
    the format, the wrong one."""
    real = coding.make_canonical_coding

    def planted(hist, max_len=12, clamp=False):
        cc = real(hist, 11)
        lc = np.zeros(13, np.uint16)
        lc[:12] = cc.len_count
        bits, lens = coding.assign_canonical_codes(lc, cc.sorted_syms, 12)
        return dataclasses.replace(cc, code_bits=bits, code_lens=lens, len_count=lc, max_len=12)

    monkeypatch.setattr(coding, "make_canonical_coding", planted)


@pytest.mark.parametrize("name", ["skewed", "4096_k"])
def test_table_capped_at_11_bits_moves_table_diff(name, monkeypatch):
    raw = _inputs(32)[name]
    _capped_at_11(monkeypatch)
    codec = TorchRefCodec(32, device="cpu")
    blob = codec.compress(raw)
    assert codec.decompress(blob) == raw  # lossless, and still caught
    got = _tally(raw, blob)
    assert got["table_diff"] > 0 and got["blob_diff"] > 0


def test_dropped_output_byte_moves_decode_diff(blobs):
    raw, blob, decoded, _ = blobs[32, "ragged"]
    got = _tally(raw, blob, decoded[:-1])
    assert got == dict(ZERO, decode_diff=1)


def test_control_at_11_bits_is_not_correct(blobs):
    """The reference one step below the configuration's 12 bits."""
    raw, _, _, _ = blobs[32, "4096_k"]
    got = _tally(raw, RR.compress(raw, 32, cap=11)["blob"])
    assert got["table_diff"] > 0 and got["failed"] == got["decode_diff"] == 0


# ---------- the uniform source and the stored fallback ----------


def _small_config(name: str) -> dict:
    with open(os.path.join(REPO, "hbench", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **SMALL[name])


def test_uniform_request_comes_back_stored():
    """Two blocks of the source, a container whose crc trailer lets
    `reference.read_container` read it."""
    cfg = _small_config("block16m")
    traffic = {"api": "bytes", "source": "uniform", "pool_units": 8}
    pool = spec.part("sources", "uniform").make_pool(cfg, traffic, SEED, "cpu")
    again = spec.part("sources", "uniform").make_pool(cfg, traffic, SEED, "cpu")
    assert pool.shape == (8, 1 << 16) and torch.equal(pool, again)
    counts = torch.bincount(pool.reshape(-1).long(), minlength=256)
    assert counts.min() > 0.9 * counts.float().mean()
    codec = spec.part("profiles", "tpu").make_codec(cfg, "cpu")
    raw = pool[:2].reshape(-1).numpy().tobytes()
    container.reset_stored()
    blob = codec.compress(raw)
    _, _, records = container.parse_records(blob)
    assert [r[0] for r in records] == [container.KIND_STORED] * 2 + [container.KIND_CRC]
    assert reference.read_container(blob)[0] == raw
    assert codec.decompress(blob) == raw
    assert container.STORED == {"blocks": 2, "records": 2, "encoded_bytes": 2 << 16}


def _stored_spans(codec, raw: bytes) -> tuple[bytes, dict]:
    """The blob of one compress with the span recorder on, and its spans."""
    tracing.reset()
    tracing.enable()
    try:
        blob = codec.compress(raw)
    finally:
        tracing.disable()
    got = tracing.snapshot()
    tracing.reset()
    assert codec.decompress(blob) == raw
    return blob, got


def test_one_stored_block_is_counted():
    bb = 1 << 16
    codec = TorchCodec(512, device="cpu")
    codec.block_bytes = bb
    raw = np.random.default_rng(SEED).integers(0, 256, bb, dtype=np.uint8).tobytes()
    container.reset_stored()
    _, got = _stored_spans(codec, raw)
    assert container.STORED == {"blocks": 1, "records": 1, "encoded_bytes": bb}
    assert got[(None, "compress.stored")].count == 1
    # A block that compresses: weighed, and nothing stored.
    corpus = np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8, count=bb)
    container.reset_stored()
    assert (None, "compress.stored") not in _stored_spans(codec, corpus.tobytes())[1]
    assert container.STORED == {"blocks": 1, "records": 0, "encoded_bytes": 0}


def test_container_with_a_uniform_block_counts_it():
    """Three blocks of a container, the middle one uniform: one stored."""
    bb = 1 << 16
    codec = TorchCodec(512, device="cpu")
    codec.block_bytes = bb
    corpus = np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8, count=2 * bb)
    noise = np.random.default_rng(SEED).integers(0, 256, bb, dtype=np.uint8)
    raw = np.concatenate([corpus[:bb], noise, corpus[bb:]]).tobytes()
    container.reset_stored()
    blob, got = _stored_spans(codec, raw)
    kinds = [r[0] for r in container.parse_records(blob)[2]]
    assert kinds == [container.KIND_HUFF, container.KIND_STORED, container.KIND_HUFF,
                     container.KIND_CRC]
    assert container.STORED == {"blocks": 3, "records": 1, "encoded_bytes": bb}
    assert got[(None, "compress.stored")].count == 1


def test_sharded_codec_counts_its_stored_blocks():
    """The sharded codec's blocks go through the same choice: two uniform
    blocks of three stored, counted and spanned."""
    bb = 4096
    codec = ShardedCodec(block_bytes=bb, k=64, device="cpu")
    corpus = np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8, count=bb)
    noise = np.random.default_rng(SEED).integers(0, 256, 2 * bb, dtype=np.uint8)
    raw = np.concatenate([noise[:bb], corpus, noise[bb:]]).tobytes()
    container.reset_stored()
    blob, got = _stored_spans(codec, raw)
    kinds = [r[0] for r in container.parse_records(blob)[2]]
    assert kinds == [container.KIND_STORED, container.KIND_HUFF, container.KIND_STORED,
                     container.KIND_CRC]
    assert container.STORED == {"blocks": 3, "records": 2, "encoded_bytes": 2 * bb}
    assert got[("sharded.compress.serialize", "compress.stored")].count == 2


# ---------- TorchRefCodec's spans and counters ----------


COMPRESS_STAGES = ("upload", "hist", "table", "encode", "regions", "download")
DECOMPRESS_STAGES = ("parse", "upload", "scatter", "tables", "decode", "order", "download")


def test_spans_name_every_stage():
    raw = _inputs(32)["ragged"]
    codec = TorchRefCodec(32, device="cpu")
    tracing.reset()
    tracing.enable()
    try:
        assert codec.decompress(codec.compress(raw)) == raw
    finally:
        tracing.disable()
    got = tracing.snapshot()
    tracing.reset()
    for top, stages in (("ref.compress", COMPRESS_STAGES), ("ref.decompress", DECOMPRESS_STAGES)):
        assert got[(None, top)].count == 1
        inner = 0
        for stage in stages:
            stat = got[(top, f"{top}.{stage}")]
            assert stat.count == 1
            inner += stat.total_ns
        assert got[(None, top)].child_ns == inner <= got[(None, top)].total_ns


def test_counts_follow_the_device_path():
    codec = TorchRefCodec(32, device="cpu")
    raw = _inputs(32)["ragged"]
    torch_ref_codec.reset_counts()
    for _ in range(3):
        assert codec.decompress(codec.compress(raw)) == raw
    c = torch_ref_codec.COUNTS
    assert (c["compress"]["calls"], c["compress"]["waits"]) == (3, 12)
    assert c["compress"]["table_ns"] > 0
    assert c["decompress"] == {"calls": 3, "waits": 6, "table_ns": 0}
    # The host library's sizes, and a single symbol, count nothing.
    torch_ref_codec.reset_counts()
    for short in (raw[: 4 * 32 - 1], b"", b"z" * 4096):
        assert codec.decompress(codec.compress(short)) == short
    assert c["decompress"] == {"calls": 0, "waits": 0, "table_ns": 0}
    assert c["compress"]["calls"] == 1  # b"z" * 4096 encodes on the device path


# ---------- the readers and the cells ----------


def _small_root(tmp_path) -> str:
    """A copy of the benchmark whose ``ref64k`` configuration is cut to
    `SMALL`."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "hbench"), os.path.join(root, "hbench"),
                    ignore=shutil.ignore_patterns("data", "tests", "__pycache__"))
    os.symlink(os.path.join(REPO, "hbench", "data"), os.path.join(root, "hbench", "data"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name in ("ref64k",):
        with open(os.path.join(root, "hbench", "configs", f"{name}.json"), "w") as f:
            json.dump(_small_config(name), f)
    return root


def test_cells_are_found_by_name():
    ref = spec.load_cell("ref64k.bytes")
    assert ref.profile.__file__ == os.path.join(REPO, "hbench", "profiles", "ref.py")
    assert (ref.config["unit_bytes"], ref.config["lanes"], ref.config["max_code_len"]) == (
        16 << 20, 65536, 12)
    assert ref.config["table_sample"] is None and ref.traffic["request_units"] == 1
    assert {m["name"] for m in ref.end_to_end} == {"ratio", "setup_s"}
    assert {m["name"] for m in ref.per_layer} == set(READERS)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert [c["name"] for c in bench["configs"]][-1] == "ref64k"
    assert [w["name"] for w in bench["workloads"]][-1] == "ref64k.bytes"
    assert bench["workloads"][-1]["chips"] == 1
    assert [m["name"] for m in bench["per_layer"]][-3:] == list(READERS)


@pytest.mark.parametrize("cell", ["ref64k.bytes"])
def test_cell_runs_correct_through_the_harness(cell, tmp_path):
    root = _small_root(tmp_path)
    c = spec.load_cell(cell, root)
    torch_ref_codec.reset_counts()
    line, checks = harness.run_cell(c, SEED, 0.4, True, device="cpu")
    assert line["correct"] and line["failed"] == 0, checks
    assert {n: v["value"] for n, v in line["checks"].items()} == ZERO
    got = {n: v["value"] for n, v in line["metrics"].items()}
    assert got["ref.host_waits.compress"] == 4.0 and got["ref.host_waits.decompress"] == 2.0
    assert got["ref.table_ms"] > 0
    line, _ = harness.run_cell(c, SEED + 1, 0.4, False, device="cpu")
    assert line["correct"] and set(line["metrics"]) == {"ratio", "setup_s"}
    assert 1.3 < line["metrics"]["ratio"]["value"] < 2.5


@pytest.mark.parametrize("metric", READERS)
def test_reader_gives_none_without_its_counter(metric, monkeypatch):
    """The program before the counters, or no call on the path: None."""
    run = harness.Run(spec.load_cell("ref64k.bytes"), 1.0, {}, 1.5, {})
    monkeypatch.delattr(torch_ref_codec, "COUNTS")
    assert spec.reader(metric)(run) is None
    monkeypatch.setattr(torch_ref_codec, "COUNTS", {m: {"calls": 0, "waits": 0, "table_ns": 0}
                                                    for m in ("compress", "decompress")},
                        raising=False)
    assert spec.reader(metric)(run) is None


@pytest.mark.parametrize("metric,want", [
    ("ref.host_waits.compress", 4.0), ("ref.host_waits.decompress", 2.0),
    ("ref.table_ms", 1.5)])
def test_reader_on_hand_made_counts(metric, want, monkeypatch):
    run = harness.Run(spec.load_cell("ref64k.bytes"), 1.0, {}, 1.5, {})
    monkeypatch.setattr(torch_ref_codec, "COUNTS", {
        "compress": {"calls": 10, "waits": 40, "table_ns": 15_000_000},
        "decompress": {"calls": 8, "waits": 16, "table_ns": 0}})
    assert spec.reader(metric)(run) == pytest.approx(want, rel=1e-12)
