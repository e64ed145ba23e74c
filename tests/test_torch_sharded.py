"""The port's sharded codec (`huffman_tpu_torch.parallel`) beside
``huffman_tpu.parallel`` on the CPU.

The JAX side runs on the 8-virtual-device mesh of tests/conftest.py with
no Pallas, once a module (its bytes do not depend on the mesh shape).
The port runs in this process at world size 1 (a `LocalMesh`) and in
spawned gloo ranks at meshes (1, 2), (2, 1) and (2, 2), whose every
result must equal the world-size-1 result.  Inputs are numpy-seeded as
in tests/test_sharded.py: 4096-byte blocks, k = 64.
"""

import contextlib
import os
import pickle
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from huffman_tpu import container as jcontainer
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu.ops.decode_bits import decode_tables_bitserial as jax_decode_tables
from huffman_tpu.parallel import ShardedCodec as JaxShardedCodec
from huffman_tpu.parallel import make_mesh as jax_make_mesh
from huffman_tpu.parallel.sharded import sharded_encode as jax_sharded_encode
from huffman_tpu_torch import TorchCodec, container, convert
from huffman_tpu_torch.parallel import ShardedCodec, make_mesh, sharded
from huffman_tpu_torch.parallel.sharded import LocalMesh, sharded_decode
from huffman_tpu_torch.tools import bench_sharded

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BB, K = 4096, 64
S = BB // K
W32 = (S * 15 + 31) // 32 + 1
RANK_TIMEOUT = 120  # seconds for all spawned ranks together


def _data(n, seed=0, style="biased"):
    rng = np.random.default_rng(seed)
    if style == "biased":
        p = 0.8 ** np.arange(256) * 0.2
        p /= p.sum()
        return rng.choice(256, size=n, p=p).astype(np.uint8)
    if style == "uniform":
        return rng.integers(0, 256, size=n, dtype=np.uint8)
    if style == "single":
        return np.full(n, 65, np.uint8)
    raise ValueError(style)


STYLES = ("biased", "uniform", "single")
ROUNDTRIP = {style: _data(3 * BB + 1000, style=style) for style in STYLES}
RAWS = {
    "3 blocks + 777": _data(3 * BB + 777, seed=9).tobytes(),
    "empty": b"",
    "incompressible": _data(2 * BB, seed=11, style="uniform").tobytes(),
    "one symbol": b"z" * (2 * BB + 5),
    "shorter than a block": _data(1000, seed=4).tobytes(),
}


@pytest.fixture(scope="module")
def jax_results():
    """JAX's roundtrip arrays, compress bytes and per-block decode tables
    on the (4, 2) mesh, and a single-chip TpuCodec container."""
    mesh = jax_make_mesh(stream=2)
    jc = JaxShardedCodec(mesh=mesh, block_bytes=BB, k=K)
    roundtrip = {s: tuple(np.asarray(a) for a in jc.roundtrip(x)) for s, x in ROUNDTRIP.items()}
    tables = {}
    for style, x in ROUNDTRIP.items():
        padded = np.zeros(4 * BB, np.uint8)
        padded[: x.size] = x
        blocks = jax.device_put(
            jnp.asarray(jc._permute_in(padded.reshape(4, BB))), NamedSharding(mesh, P("data", "stream"))
        )
        _, _, lc, ss, ns = (np.asarray(a) for a in jax_sharded_encode(
            blocks, mesh=mesh, k=K, s=S, w32=W32))
        per_block = [jax_decode_tables(lc[b], ss[b][: ns[b]]) for b in range(4)]
        tables[style] = {
            "e_bound": np.stack([t["e_bound"] for t in per_block]),
            "g_rank": np.stack([t["g_rank"] for t in per_block]),
            "sorted_syms": np.stack([t["syms"] for t in per_block]),
        }
    blobs = {name: jc.compress(raw) for name, raw in RAWS.items()}
    tpu_blob = jcontainer.compress_blocks(RAWS["3 blocks + 777"], TpuCodec(K), BB)
    return {"roundtrip": roundtrip, "tables": tables, "blobs": blobs, "tpu_blob": tpu_blob}


@pytest.fixture(scope="module")
def ours():
    """The port's results at world size 1."""
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    roundtrip = {}
    for style, x in ROUNDTRIP.items():
        out, bits, words = codec.roundtrip(x)
        roundtrip[style] = (out, bits.numpy(), words.numpy().view(np.uint32))
    return {"roundtrip": roundtrip, "blobs": {name: codec.compress(raw) for name, raw in RAWS.items()}}


def test_default_mesh_is_one_rank():
    mesh = make_mesh()
    assert isinstance(mesh, LocalMesh)
    assert sharded.mesh_shape(mesh) == {"data": 1, "stream": 1}
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(stream=2)


@pytest.mark.parametrize("style", STYLES)
def test_roundtrip_matches_jax(style, jax_results, ours):
    out, bits, words = ours["roundtrip"][style]
    jout, jbits, jwords = jax_results["roundtrip"][style]
    np.testing.assert_array_equal(out, ROUNDTRIP[style])
    np.testing.assert_array_equal(out, jout)
    assert bits.shape == (4, K) and words.shape == (4, W32, K)
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(words, jwords)


@pytest.mark.parametrize("name", list(RAWS))
def test_compress_matches_jax(name, jax_results, ours):
    assert ours["blobs"][name] == jax_results["blobs"][name]


def test_short_input_pads_to_a_block_unlike_the_container(ours):
    """Below one block the sharded codec writes raw_size = block_bytes, as
    JAX's does; container.compress_blocks would keep the natural size."""
    raw = RAWS["shorter than a block"]
    _, _, records = container.parse_records(ours["blobs"]["shorter than a block"])
    assert records[0][2] == len(raw)
    assert int.from_bytes(records[0][3][4:8], "little") == BB
    assert container.compress_blocks(raw, TorchCodec(K, device="cpu"), BB) != ours["blobs"][
        "shorter than a block"]


@pytest.mark.parametrize("name", list(RAWS))
def test_decompress_reads_jax_and_own_containers(name, jax_results, ours):
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    assert codec.decompress(jax_results["blobs"][name]) == RAWS[name]
    assert codec.decompress(ours["blobs"][name]) == RAWS[name]


def test_decompress_reads_a_tpu_codec_container(jax_results):
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    assert codec.decompress(jax_results["tpu_blob"]) == RAWS["3 blocks + 777"]


@pytest.mark.parametrize("name", list(RAWS))
def test_torch_codec_reads_the_sharded_container(name, ours):
    assert TorchCodec(K, device="cpu").decompress(ours["blobs"][name]) == RAWS[name]


def test_decompress_rejects_corrupt_and_truncated_containers(ours):
    codec = ShardedCodec(block_bytes=BB, k=K, device="cpu")
    blob = bytearray(ours["blobs"]["3 blocks + 777"])
    blob[len(blob) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="crc"):
        codec.decompress(bytes(blob))
    _, _, records = container.parse_records(ours["blobs"]["3 blocks + 777"])
    short = container.pack([r[:1] + r[2:] for r in records[:2]], BB)
    short = short[:8] + len(RAWS["3 blocks + 777"]).to_bytes(8, "little") + short[16:]
    with pytest.raises(ValueError, match="truncated"):
        codec.decompress(short)


@pytest.mark.parametrize("style", STYLES)
def test_jax_state_decodes_in_the_port(style, jax_results):
    """JAX's sharded_roundtrip words and bit counts and its tables, through
    `convert.batch_from_numpy`, into the port's sharded_decode."""
    _, jbits, jwords = jax_results["roundtrip"][style]
    words, _, tables = convert.batch_from_numpy(
        jwords, jbits, jax_results["tables"][style], device="cpu"
    )
    out = sharded_decode(
        words, tables["e_bound"], tables["g_rank"], tables["sorted_syms"],
        mesh=make_mesh(), k=K, s=S, w=W32,
    )
    want = np.zeros(4 * BB, np.uint8)
    want[: ROUNDTRIP[style].size] = ROUNDTRIP[style]
    np.testing.assert_array_equal(out.numpy().reshape(-1), want)


def _fake_mesh(stream):
    return types.SimpleNamespace(
        mesh_dim_names=("data", "stream"), size=lambda i: (1, stream)[i],
        get_coordinate=lambda: [0, 0],
    )


@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("stream", [1, 2, 4])
def test_permutations_match_jax(stream, direction):
    blocks = np.random.default_rng(stream).integers(0, 256, size=(3, BB), dtype=np.uint8)
    mesh = make_mesh() if stream == 1 else _fake_mesh(stream)
    ours = ShardedCodec(mesh, block_bytes=BB, k=K, device="cpu")
    theirs = JaxShardedCodec(mesh=jax_make_mesh(stream=stream), block_bytes=BB, k=K)
    fn, jfn = (ours._permute_in, theirs._permute_in) if direction == "in" else (
        ours._permute_out, theirs._permute_out)
    np.testing.assert_array_equal(fn(blocks), jfn(blocks))
    np.testing.assert_array_equal(fn(torch.from_numpy(blocks)).numpy(), jfn(blocks))


def test_codec_selects_its_card_before_the_step(monkeypatch, ours):
    """Kernels launch on the current device, so a rank on cuda:1 must make
    it current around each step: every upload and step runs inside
    ``torch.cuda.device('cuda:1')``."""
    events = []

    @contextlib.contextmanager
    def fake_device(dev):
        events.append(("enter", str(dev)))
        yield
        events.append(("exit", str(dev)))

    def upload(a, device):
        events.append(("upload", str(device)))
        return torch.from_numpy(a)

    def recorded(name):
        real = getattr(sharded, name)

        def step(*args, **kwargs):
            events.append(("step", name))
            return real(*args, **kwargs)

        return step

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(sharded, "_upload", upload)
    for name in ("sharded_roundtrip", "sharded_encode"):
        monkeypatch.setattr(sharded, name, recorded(name))
    codec = ShardedCodec(block_bytes=BB, k=K, device="cuda:1")
    np.testing.assert_array_equal(codec.roundtrip(ROUNDTRIP["biased"])[0], ROUNDTRIP["biased"])
    assert codec.compress(RAWS["3 blocks + 777"]) == ours["blobs"]["3 blocks + 777"]
    step = [("enter", "cuda:1"), ("upload", "cuda:1"), None, ("exit", "cuda:1")]
    assert events == [e or ("step", "sharded_roundtrip") for e in step] + [
        e or ("step", "sharded_encode") for e in step]


def test_container_crc_helpers_match_jax():
    raw = RAWS["3 blocks + 777"]
    assert container.crc_record(raw) == jcontainer.crc_record(raw)
    records = [(k, 0, rl, p) for k, rl, p in [container.crc_record(raw)]]
    container.check_crc(records, raw)
    container.check_crc([], raw)  # no trailer: nothing to check
    with pytest.raises(ValueError, match="crc mismatch"):
        container.check_crc(records, raw[:-1])


# One spawned rank: the codec on a mesh of the gloo world, every result
# pickled for the parent to compare.
RANK_MAIN = """
import pickle, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from huffman_tpu_torch.parallel import ShardedCodec, distributed, make_mesh
from huffman_tpu_torch.tools import bench_sharded
store, world, rank, stream, inputs, out = sys.argv[1:]
world, rank, stream = int(world), int(rank), int(stream)
distributed.initialize(backend="gloo", init_method="file://" + store, world_size=world, rank=rank)
mesh = make_mesh(stream=stream)
with open(inputs, "rb") as f:
    bb, k, roundtrip, raws = pickle.load(f)
codec = ShardedCodec(mesh, block_bytes=bb, k=k, device="cpu")
res = {"coordinate": list(mesh.get_coordinate()), "roundtrip": {}, "compress": {}, "decompress": {}}
for style, x in roundtrip.items():
    o, b, w = codec.roundtrip(x)
    res["roundtrip"][style] = (o, b.numpy(), w.numpy())
for name, raw in raws.items():
    blob = codec.compress(raw)
    res["compress"][name] = blob
    res["decompress"][name] = codec.decompress(blob)
res["world_row"] = bench_sharded.world_row(mesh, 2, k, "cpu", block=bb, reps=2)
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""


def _spawn(tmp_path, world, stream):
    inputs = tmp_path / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((BB, K, ROUNDTRIP, RAWS), f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    env["GLOO_SOCKET_IFNAME"] = "lo"  # every rank is local: bind to loopback
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(tmp_path / "store"), str(world), str(rank),
             str(stream), str(inputs), str(tmp_path / f"out{rank}.pkl")],
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
        logs = "\n".join((tmp_path / f"rank{r}.log").read_text()[-3000:] for r in failed)
        pytest.fail(f"ranks {failed} failed or hung ({len(hung)} killed at {RANK_TIMEOUT} s):\n{logs}")
    results = []
    for rank in range(world):
        with open(tmp_path / f"out{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)], ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_spawned_gloo_ranks_equal_world_size_1(shape, tmp_path, ours):
    data, stream = shape
    results = _spawn(tmp_path, data * stream, stream)
    assert [r["coordinate"] for r in results] == [
        [d, c] for d in range(data) for c in range(stream)]
    for res in results:
        for style, (out, bits, words) in res["roundtrip"].items():
            want_out, want_bits, want_words = ours["roundtrip"][style]
            np.testing.assert_array_equal(out, want_out)
            # The block count pads to a multiple of the data axis (4 here).
            np.testing.assert_array_equal(bits, want_bits)
            np.testing.assert_array_equal(words.view(np.uint32), want_words)
        assert res["compress"] == ours["blobs"]
        assert res["decompress"] == RAWS
        assert res["world_row"]["ok"] and res["world_row"]["devices"] == data * stream


def test_bench_sharded_one_rank_row_on_cpu():
    row = bench_sharded.one_rank_row(2, K, "cpu", block=BB, reps=2)
    assert row["devices"] == 1 and row["ok"] is True and row["roundtrip_GiB_s"] > 0


def test_bench_sharded_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_sharded.main([])
