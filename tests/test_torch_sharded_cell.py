"""The benchmark's ``sharded`` deployment on the CPU: its configuration and
profile (``hbench/configs/sharded.json``, ``hbench/profiles/sharded.py``),
the counters and spans of ``huffman_tpu_torch.parallel.sharded``, and the
readers of the cell's per-layer metrics.

The codec runs at a small size (8 blocks of 64 KiB at K = 256) in this
process at world size 1 and in four spawned gloo ranks at mesh data 2 x
stream 2.  Its containers and decodes are held to the cell's own check,
``hbench.check.Tally`` over the NumPy reference: every number 0.  Two
planted faults show that the check sees a rank that skips the stream
all-reduce and a flipped record byte.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hbench import harness, spec
from hbench.check import Tally
from huffman_tpu_torch import container, tracing
from huffman_tpu_torch.parallel import ShardedCodec, sharded
from huffman_tpu_torch.parallel.sharded import LocalMesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BB, K, NB = 64 << 10, 256, 8
S = BB // K
W32 = (S * 15 + 31) // 32 + 1
RANK_TIMEOUT = 120  # seconds for all spawned ranks together
FAULT_RANK = 1
#: The eight readers of the cell's per-layer metrics.
METRICS = [f"sharded.{m}" for m in (
    "compress_GiB_s", "decompress_GiB_s", "collectives.compress", "collectives.decompress",
    "gathered_MiB.compress", "gathered_MiB.decompress", "nccl_ms.compress", "nccl_ms.decompress")]


def _config(data=1, stream=1) -> dict:
    """The deployment's configuration at the tests' size and mesh."""
    cfg = spec.load_cell("sharded.4chip").config
    return dict(cfg, unit_bytes=BB, block_bytes=BB, lanes=K, mesh={"data": data, "stream": stream})


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(2**31 + 21)
    p = 0.8 ** np.arange(256) * 0.2
    corpus = np.fromfile(os.path.join(REPO, "hbench", "data", "corpus.bin"), np.uint8)
    at = int(rng.integers(0, corpus.size - NB * BB))
    return {
        "biased": rng.choice(256, size=NB * BB, p=p / p.sum()).astype(np.uint8).tobytes(),
        "corpus": corpus[at : at + NB * BB].tobytes(),
        "ragged": rng.choice(256, size=(NB - 1) * BB + 1000, p=p / p.sum()).astype(np.uint8).tobytes(),
    }


RAWS = _inputs()


def _tally(raw: bytes, blob: bytes, decoded: bytes | None = None) -> dict:
    """The cell's check of one compress request's container and of the
    decompress of it: every number of `Tally`."""
    tally = Tally(_config())
    a = np.frombuffer(raw, np.uint8)
    tally.blob(a, blob)
    if decoded is not None:
        tally.decoded(a[None], np.frombuffer(decoded, np.uint8)[None])
    return {name: v["value"] for name, v in tally.numbers().items()}


ZERO = dict.fromkeys(("failed", "table_diff", "lane_diff", "blob_diff", "decode_diff"), 0)


def _record_bytes(blob: bytes, blocks) -> int:
    """Bytes of the records of ``blocks`` in a container, its crc left out."""
    _, _, records = container.parse_records(blob)
    return sum(len(records[b][3]) for b in blocks)


# ---------- the configuration and the profile ----------


def test_cell_is_found_by_name():
    cell = spec.load_cell("sharded.4chip")
    assert cell.profile.__file__ == os.path.join(REPO, "hbench", "profiles", "sharded.py")
    assert cell.traffic["api"] == "bytes" and cell.traffic["source"] == "biased"
    cfg = cell.config
    assert (cfg["block_bytes"], cfg["lanes"], cfg["max_code_len"]) == (1 << 20, 4096, 15)
    assert cfg["table_sample"] is None and cfg["mesh"] == {"data": 2, "stream": 2}
    assert cell.traffic["request_units"] * cfg["unit_bytes"] == 64 << 20
    assert {m["name"] for m in cell.end_to_end} == {"ratio", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_profile_builds_the_configured_codec_on_one_rank():
    codec = spec.part("profiles", "sharded").make_codec(_config(), torch.device("cpu"))
    assert isinstance(codec, ShardedCodec) and isinstance(codec.mesh, LocalMesh)
    assert (codec.block_bytes, codec.k, codec.s, codec.w32) == (BB, K, S, W32)
    assert (codec.n_data, codec.n_stream, codec.device.type) == (1, 1, "cpu")


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1)], ids=lambda m: f"mesh{m[0]}x{m[1]}")
def test_profile_refuses_a_world_that_is_not_the_mesh(mesh):
    with pytest.raises(ValueError, match="ranks, not 1"):
        spec.part("profiles", "sharded").make_codec(_config(*mesh), "cpu")


# ---------- one rank ----------


@pytest.fixture(scope="module")
def one_rank():
    """World size 1: each input's container and decode, and the counters."""
    codec = spec.part("profiles", "sharded").make_codec(_config(), "cpu")
    res = {"blobs": {}, "decoded": {}, "counts": {}}
    for name, raw in RAWS.items():
        sharded.reset_counts()
        res["blobs"][name] = codec.compress(raw)
        res["decoded"][name] = codec.decompress(res["blobs"][name])
        res["counts"][name] = {m: dict(c) for m, c in sharded.COUNTS.items()}
    return res


@pytest.mark.parametrize("name", list(RAWS))
def test_world_size_1_passes_the_check(name, one_rank):
    blob = one_rank["blobs"][name]
    assert _tally(RAWS[name], blob, one_rank["decoded"][name]) == ZERO
    _, total, records = container.parse_records(blob)
    assert total == len(RAWS[name]) and len(records) == NB + 1
    huff = [r for r in records[:-1] if r[0] == container.KIND_HUFF]
    # A short tail is stored where its padded block's blob is the larger.
    assert len(huff) == (NB - 1 if name == "ragged" else NB)
    assert all(int.from_bytes(r[3][4:8], "little") == BB for r in huff)


@pytest.mark.parametrize("name", list(RAWS))
def test_world_size_1_makes_no_collective(name, one_rank):
    counts = one_rank["counts"][name]
    assert counts["compress"] == {"calls": 1, "collectives": 0, "gathered_bytes": 0}
    assert counts["decompress"] == {"calls": 1, "collectives": 0, "gathered_bytes": 0}
    assert counts["roundtrip"]["calls"] == 0


def test_flipped_record_byte_is_caught(one_rank):
    blob = bytearray(one_rank["blobs"]["biased"])
    _, _, records = container.parse_records(bytes(blob))
    at = blob.index(records[3][3]) + len(records[3][3]) // 2  # inside block 3's payload
    blob[at] ^= 0x10
    got = _tally(RAWS["biased"], bytes(blob))
    assert got["blob_diff"] > 0


def test_roundtrip_counts_its_calls():
    sharded.reset_counts()
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    raw = np.frombuffer(RAWS["biased"], np.uint8)
    out, _, _ = codec.roundtrip(raw)
    np.testing.assert_array_equal(out, raw)
    assert sharded.COUNTS["roundtrip"] == {"calls": 1, "collectives": 0, "gathered_bytes": 0}
    assert sharded.COUNTS["compress"]["calls"] == 0


# ---------- the spans ----------


def _spans(on: bool) -> dict:
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    tracing.reset()
    if on:
        tracing.enable()
    try:
        codec.decompress(codec.compress(RAWS["ragged"]))
    finally:
        tracing.disable()
    got = tracing.snapshot()
    tracing.reset()
    return got


def test_spans_nest_under_their_parents():
    got = _spans(True)
    for half, stages in (
        ("compress", ("upload", "step", "gather", "serialize", "gather_records", "pack")),
        ("decompress", ("parse", "deserialize", "step", "gather", "join")),
    ):
        top = f"sharded.{half}"
        assert got[(None, top)].count == 1
        inner = 0
        for stage in stages:
            stat = got[(top, f"{top}.{stage}")]
            assert stat.count == 1 and stat.total_ns > 0
            inner += stat.total_ns
        assert got[(None, top)].child_ns == inner <= got[(None, top)].total_ns
    # The codec's own spans sit inside the stages that call them (the
    # ragged input's short tail is a stored record, read in .parse).
    assert got[("sharded.compress.serialize", "serialize")].count == NB
    assert got[("sharded.decompress.deserialize", "deserialize")].count == NB - 1


def test_spans_off_record_nothing():
    assert _spans(False) == {}


# ---------- four gloo ranks at mesh (2, 2) ----------


# One spawned rank: the profile's codec on the gloo world, every result
# pickled for the test to hold to the check; last, the planted fault.
RANK_MAIN = """
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from hbench import spec
from huffman_tpu_torch.parallel import distributed, sharded
store, world, rank, inputs, out = sys.argv[1:]
world, rank = int(world), int(rank)
distributed.initialize(backend="gloo", init_method="file://" + store, world_size=world, rank=rank)
with open(inputs, "rb") as f:
    config, raws, fault_rank = pickle.load(f)
codec = spec.part("profiles", "sharded").make_codec(config, "cpu")
res = {"coordinate": list(codec.mesh.get_coordinate()), "blobs": {}, "decoded": {}, "counts": {}}
for name, raw in raws.items():
    sharded.reset_counts()
    res["blobs"][name] = codec.compress(raw)
    res["decoded"][name] = codec.decompress(res["blobs"][name])
    res["counts"][name] = {m: dict(c) for m, c in sharded.COUNTS.items()}
# The planted fault: this rank's share of the stream all-reduce is a copy
# of its histogram, so it keeps its own counts (its stream peer still gets
# the sum, and the collectives still pair up).
if rank == fault_rank:
    real = dist.all_reduce
    dist.all_reduce = lambda t, *a, **k: real(t.clone(), *a, **k)
raw = raws["biased"]
res["fault_blob"] = codec.compress(raw)
nb = -(-len(raw) // codec.block_bytes)
local = codec._local_blocks(codec._padded(np.frombuffer(raw, np.uint8), nb))
words, bits, tables = sharded._encode_shard(local, codec.mesh, codec.k_local, codec.s, codec.w32)
# The step as this rank sees it: every lane, and the tables of its stream column.
res["fault_step"] = {
    "words": codec._gather(words, 2).numpy().view(np.uint32),
    "bits": codec._gather(bits, 1).numpy().astype(np.int64),
    "enc": sharded._all_gather(tables["enc_table"], codec.mesh, "data", 0).numpy().astype(np.int64),
    "k": codec.k,
}
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((_config(2, 2), RAWS, FAULT_RANK), f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    env["GLOO_SOCKET_IFNAME"] = "lo"  # every rank is local: bind to loopback
    procs, logs = [], []
    for rank in range(4):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(tmp / "store"), "4", str(rank), str(inputs),
             str(tmp / f"out{rank}.pkl")],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        text = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:] for r in failed)
        pytest.fail(f"ranks {failed} failed or hung ({len(hung)} killed at {RANK_TIMEOUT} s):\n{text}")
    results = []
    for rank in range(4):
        with open(tmp / f"out{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize("name", list(RAWS))
def test_mesh_2x2_passes_the_check(name, four_ranks, one_rank):
    assert [r["coordinate"] for r in four_ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for res in four_ranks:
        assert res["blobs"][name] == one_rank["blobs"][name]
        assert _tally(RAWS[name], res["blobs"][name], res["decoded"][name]) == ZERO


@pytest.mark.parametrize("name", list(RAWS))
def test_mesh_2x2_counts_what_the_code_implies(name, four_ranks):
    """A compress makes the stream all-reduce of the (B/2, 256) int32
    histograms, the stream all-gathers of the words and of the bit counts,
    and the two record gathers (stream, then data); a decompress the two
    gathers of parse errors (no bytes) and the two of the decoded bytes."""
    bl = NB // 2
    for rank, res in enumerate(four_ranks):
        d = rank // 2
        counts, blob = res["counts"][name], res["blobs"][name]
        records = _record_bytes(blob, range(d * bl, (d + 1) * bl)) + _record_bytes(blob, range(NB))
        tensors = bl * 256 * 4 + 2 * bl * W32 * (K // 2) * 4 + 2 * bl * (K // 2) * 4
        assert counts["compress"] == {"calls": 1, "collectives": 5,
                                      "gathered_bytes": tensors + records}
        assert counts["decompress"] == {"calls": 1, "collectives": 4,
                                        "gathered_bytes": 2 * bl * BB // 2 + 2 * bl * BB}
        assert counts["roundtrip"] == {"calls": 0, "collectives": 0, "gathered_bytes": 0}


def test_skipped_stream_all_reduce_is_caught(four_ranks, one_rank):
    raw = RAWS["biased"]
    bad = four_ranks[FAULT_RANK]
    # The container every rank returns: its blocks' lanes were coded with
    # two tables, so the reference's reader refuses them.
    assert bad["fault_blob"] != one_rank["blobs"]["biased"]
    assert _tally(raw, bad["fault_blob"])["blob_diff"] > 0
    # The step as the faulty rank sees it: the tables of its stream
    # column are its half's, not the whole block's.
    tally = Tally(_config())
    tally.encoded(np.frombuffer(raw, np.uint8).reshape(NB, BB), bad["fault_step"])
    assert tally.n["table_diff"] > 0 and tally.n["lane_diff"] > 0
    # Its stream peer built the whole block's tables: only its lanes differ.
    peer = four_ranks[FAULT_RANK ^ 1]
    tally = Tally(_config())
    tally.encoded(np.frombuffer(raw, np.uint8).reshape(NB, BB), peer["fault_step"])
    assert tally.n["table_diff"] == 0 and tally.n["lane_diff"] > 0


# ---------- the metric readers ----------


def _run(trace_ops=None, requests=(40, 3), wall_s=(20.0, 25.0)) -> harness.Run:
    halves = {}
    for (name, n, wall) in zip(("compress", "decompress"), requests, wall_s):
        h = harness.Half(name, requests=n, bytes=n * (64 << 20), wall_s=wall)
        if trace_ops is not None:
            h.trace = {"busy_s": 0.1, "window_s": 1.0, "device_s": sum(trace_ops.values()),
                       "requests": 4, "ops": dict(trace_ops), "gaps": {}}
        halves[name] = h
    return harness.Run(spec.load_cell("sharded.4chip"), 50.0, halves, 2.18, {})


@pytest.fixture
def counts(monkeypatch):
    values = {"compress": {"calls": 8, "collectives": 40, "gathered_bytes": 8 * (100 << 20)},
              "decompress": {"calls": 4, "collectives": 16, "gathered_bytes": 4 * (96 << 20)},
              "roundtrip": {"calls": 0, "collectives": 0, "gathered_bytes": 0}}
    monkeypatch.setattr(sharded, "COUNTS", values)
    return values


# NCCL's kernels, the profiler's range over one of them, another kernel.
OPS = {"ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 0.002,
       "ncclDevKernel_AllReduce_Sum_u32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 0.0004,
       "nccl:all_gather": 0.0021, "encode_lanes_kernel": 0.003}


@pytest.mark.parametrize("metric,want", [
    ("sharded.compress_GiB_s", 40 * (64 << 20) / 20.0 / 2**30),
    ("sharded.decompress_GiB_s", 3 * (64 << 20) / 25.0 / 2**30),
    ("sharded.collectives.compress", 5.0),
    ("sharded.collectives.decompress", 4.0),
    ("sharded.gathered_MiB.compress", 100.0),
    ("sharded.gathered_MiB.decompress", 96.0),
    ("sharded.nccl_ms.compress", 1e3 * 0.0024 / 4),
    ("sharded.nccl_ms.decompress", 1e3 * 0.0024 / 4),
])
def test_reader_on_a_hand_made_run(metric, want, counts):
    assert spec.reader(metric)(_run(OPS)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", METRICS[2:])
def test_reader_gives_none_without_its_source(metric, monkeypatch):
    """No counters (the program before them), no call, no trace, or a
    slice with no NCCL operation: None, and no exception."""
    run = _run({"encode_lanes_kernel": 0.003, "nccl:all_gather": 0.0021})
    monkeypatch.delattr(sharded, "COUNTS")
    assert spec.reader(metric)(run) is None
    assert spec.reader(metric)(_run(None)) is None
    zeros = {m: {"calls": 0, "collectives": 0, "gathered_bytes": 0}
             for m in ("compress", "decompress", "roundtrip")}
    monkeypatch.setattr(sharded, "COUNTS", zeros, raising=False)
    assert spec.reader(metric)(run) is None


@pytest.mark.parametrize("metric", METRICS[:2])
def test_rate_reader_gives_none_without_requests(metric):
    assert spec.reader(metric)(_run(None, requests=(0, 0))) is None
