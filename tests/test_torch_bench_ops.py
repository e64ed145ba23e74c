"""The sustained bodies' carried 0 and checksum (``bench/fused.py``)
beside the JAX harness on the CPU.

`checksum_plain` must wrap exactly as ``jnp.sum(x.astype(jnp.int32))``
does and `carry_plain` must add as ``x + pert`` does; the port's
encode / decode bodies and ``bench_streaming``'s ``combined_once`` must
give the JAX bodies' float32 values on the same block (the JAX bodies
are captured from ``huffman_tpu.bench.harness.bench_tpu_codec`` and
``tools/bench_streaming.py`` by standing in for ``sustained_seconds``);
and every sustained body of the port must go through `fused.carry` and
`fused.checksum`, shown by spies.  The kernels themselves run only on a
card: ``chip_smoke.py`` holds them against these plain versions there.
"""

import collections
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.bench import harness as jharness
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu_torch import TorchCodec
from huffman_tpu_torch.bench import fused, harness, workloads
from huffman_tpu_torch.tools import (
    bench_sharded,
    bench_streaming,
    hist_experiments,
    probe_batched,
    probe_encode_stages,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERT0 = torch.zeros((), dtype=torch.uint8)


CHECKSUM_CASES = {
    "biased 1 MiB": lambda: workloads.biased_u8(1 << 20),
    "16 MiB of 0xFF": lambda: np.full(16 << 20, 0xFF, np.uint8),
    "int32 words with negatives": lambda: np.random.default_rng(1).integers(
        -(1 << 31), 1 << 31, 1 << 16, dtype=np.int64).astype(np.int32),
    "int32 words that wrap": lambda: np.full(4096, (1 << 31) - 1, np.int32),
    "empty u8": lambda: np.zeros(0, np.uint8),
    "empty int32": lambda: np.zeros(0, np.int32),
    "(18, 1024) int32": lambda: np.random.default_rng(2).integers(
        0, 1 << 31, (18, 1024), dtype=np.int64).astype(np.int32),
}


@pytest.mark.parametrize("name", list(CHECKSUM_CASES))
def test_checksum_plain_wraps_as_jax(name):
    x = CHECKSUM_CASES[name]()
    want = jnp.sum(jnp.asarray(x).astype(jnp.int32))
    got = fused.checksum_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want)
    assert torch.equal(fused.checksum(torch.from_numpy(x)), got)
    if name == "16 MiB of 0xFF":  # 4278190080 wraps
        assert int(got) == 4278190080 - (1 << 32) == -16777216


CARRY_CASES = {
    "u8, pert 0": (lambda: workloads.biased_u8(1 << 16), 0),
    "u8, pert 1 (255 wraps to 0)": (lambda: np.arange(1 << 12).astype(np.uint8), 1),
    "int32, pert 0": (lambda: np.arange(-2048, 2048, dtype=np.int32), 0),
    "int32, pert 1": (lambda: np.array([-1, 0, (1 << 31) - 1, 7], np.int32), 1),
    "empty u8, pert 1": (lambda: np.zeros(0, np.uint8), 1),
}


@pytest.mark.parametrize("name", list(CARRY_CASES))
def test_carry_plain_adds_as_jax(name):
    make, p = CARRY_CASES[name]
    x = make()
    pert = torch.tensor(p, dtype=torch.uint8)
    want = np.asarray(jnp.asarray(x) + jnp.asarray(p, jnp.uint8))
    got = fused.carry_plain(torch.from_numpy(x), pert)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(fused.carry(torch.from_numpy(x), pert), got)
    if x.dtype == np.uint8 and p == 1 and x.size:
        assert int(got[255]) == 0


BAD_ARGS = {
    "int64 x to carry": lambda: fused.carry(torch.zeros(4, dtype=torch.int64), PERT0),
    "int64 x to checksum": lambda: fused.checksum(torch.zeros(4, dtype=torch.int64)),
    "strided x": lambda: fused.checksum(torch.zeros((4, 4), dtype=torch.uint8).t()),
    "int32 pert": lambda: fused.carry(torch.zeros(4, dtype=torch.uint8),
                                      torch.zeros((), dtype=torch.int32)),
    "pert of shape (1,)": lambda: fused.carry(torch.zeros(4, dtype=torch.uint8),
                                              torch.zeros(1, dtype=torch.uint8)),
    "a meta tensor": lambda: fused.checksum(torch.empty(4, dtype=torch.uint8, device="meta")),
}


@pytest.mark.parametrize("name", list(BAD_ARGS))
def test_bad_arguments_raise(name):
    with pytest.raises(ValueError):
        BAD_ARGS[name]()


def _capture_bodies(monkeypatch, module, stop_after=None):
    """Stand in for ``module.sustained_seconds``: record each body and
    return a time of 1 ms; raise `_Stop` once ``stop_after`` bodies are
    in."""
    bodies = []

    def fake(body, *args, **kwargs):
        bodies.append(body)
        if stop_after is not None and len(bodies) == stop_after:
            raise _Stop
        return 1e-3

    monkeypatch.setattr(module, "sustained_seconds", fake)
    return bodies


class _Stop(Exception):
    pass


def _jax_bench_bodies(monkeypatch, raw):
    """``bench_tpu_codec``'s enc_once and dec_once on ``raw``
    (huffman_tpu/bench/harness.py:127-145)."""
    bodies = _capture_bodies(monkeypatch, jharness)
    jharness.bench_tpu_codec(TpuCodec(), raw)
    assert len(bodies) == 2
    return bodies


def _jax_value(body):
    return np.float32(body(jnp.zeros((), jnp.uint8)))


def _value(body):
    got = body(PERT0)
    assert got.dtype == torch.float32 and got.dim() == 0
    return np.float32(got)


def test_harness_bodies_equal_the_jax_bodies(monkeypatch):
    data = workloads.biased_u8(1 << 20)
    jenc, jdec = _jax_bench_bodies(monkeypatch, data.tobytes())
    codec = TorchCodec(device="cpu")
    t = torch.from_numpy(data.copy())
    comp = codec.encode_device(t)
    enc, dec = harness.encode_body(codec, t), harness.decode_body(comp)
    assert _value(enc) == _jax_value(jenc)
    assert _value(dec) == _jax_value(jdec)
    assert _value(dec) == np.float32(data.astype(np.int64).sum())


def _jax_streaming_bodies(monkeypatch, tmp_path, block_mib):
    """The JAX tool's enc_once, dec_once and combined_once
    (tools/bench_streaming.py:79-97), at ``block_mib``."""
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_streaming", os.path.join(REPO, "tools", "bench_streaming.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bodies = _capture_bodies(monkeypatch, jharness, stop_after=3)
    monkeypatch.setattr(sys, "argv", [
        "bench_streaming.py", "--fast", "--block-mib", str(block_mib),
        "--out", str(tmp_path / "jax.json")])
    with pytest.raises(_Stop):
        mod.main()
    return bodies


def test_streaming_combined_once_decodes_the_first_w_words_as_jax(monkeypatch, tmp_path):
    jenc, jdec, jcombined = _jax_streaming_bodies(monkeypatch, tmp_path, 1)
    bodies = _capture_bodies(monkeypatch, bench_streaming)
    seen = []
    real = bench_streaming.decode_lanes

    def spy(words, *args):
        seen.append(tuple(words.shape))
        return real(words, *args)

    monkeypatch.setattr(bench_streaming, "decode_lanes", spy)
    bench_streaming.shared_table_row(1 << 20, 2, "cpu")
    enc, dec, combined = bodies
    comp = TorchCodec(device="cpu").encode_device(torch.from_numpy(workloads.biased_u8(1 << 20)))
    s = -(-(1 << 20) // comp.k)
    w = bench_streaming.decode_statics(comp.meta(), s)
    assert 0 < w < comp.words.shape[0]
    seen.clear()
    assert _value(combined) == _jax_value(jcombined)
    assert seen == [(w, comp.k)]
    assert _value(enc) == _jax_value(jenc)
    assert _value(dec) == _jax_value(jdec)


def _spied(monkeypatch):
    """Counts of `fused.carry` and `fused.checksum` calls, through spies
    that call the real functions."""
    calls = collections.Counter()
    for name in ("carry", "checksum"):
        real = getattr(fused, name)

        def spy(*args, name=name, real=real):
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(fused, name, spy)
    return calls


def _harness_bodies(monkeypatch):
    codec = TorchCodec(device="cpu")
    data = torch.from_numpy(workloads.biased_u8(1 << 18))
    return [harness.encode_body(codec, data), harness.decode_body(codec.encode_device(data))]


def _streaming_bodies(monkeypatch):
    bodies = _capture_bodies(monkeypatch, bench_streaming)
    bench_streaming.shared_table_row(1 << 18, 2, "cpu")
    bench_streaming.batched_row(2, 2, "cpu")
    return bodies


def _race_bodies(monkeypatch):
    bodies = _capture_bodies(monkeypatch, hist_experiments)
    hist_experiments.race_on(torch.from_numpy(hist_experiments.race_block(1 << 19)), 2, 1)
    return bodies


def _stage_bodies(monkeypatch, tmp_path):
    bodies = _capture_bodies(monkeypatch, probe_encode_stages)
    probe_encode_stages.main(["0.25", "--reps", "2", "--device", "cpu",
                              "--out", str(tmp_path / "stages.json")])
    return bodies


def _batched_stage_bodies(monkeypatch):
    bodies = _capture_bodies(monkeypatch, probe_batched)
    probe_batched.stage_row(2, 2, "cpu")
    return bodies


def _sharded_bodies(monkeypatch):
    bodies = _capture_bodies(monkeypatch, bench_sharded)
    bench_sharded.one_rank_row(2, 64, "cpu", block=4096, reps=2)
    return bodies


# Each tool's bodies in order, with the carry and checksum calls of one
# run of each.
SPIED = {
    "harness encode_body, decode_body": (lambda mp, tmp: _harness_bodies(mp),
                                         [(1, 2), (1, 1)]),
    "bench_streaming enc_once, decode_body, combined_once, enc_b, dec_b": (
        lambda mp, tmp: _streaming_bodies(mp), [(1, 1), (1, 1), (1, 1), (1, 2), (1, 1)]),
    "hist_experiments race": (lambda mp, tmp: _race_bodies(mp), [(1, 1)] * 7),
    "probe_encode_stages dep, hist/1, hist/S, table, kernel, full": (
        _stage_bodies, [(1, 0), (1, 1), (1, 1), (1, 1), (1, 2), (1, 3)]),
    "probe_batched dep, hist_b, table, body, full": (
        lambda mp, tmp: _batched_stage_bodies(mp), [(1, 0), (1, 1), (1, 1), (1, 1), (1, 2)]),
    "bench_sharded one-rank row": (lambda mp, tmp: _sharded_bodies(mp), [(1, 1)]),
}


@pytest.mark.parametrize("name", list(SPIED))
def test_every_sustained_body_goes_through_carry_and_checksum(name, monkeypatch, tmp_path):
    make, want = SPIED[name]
    calls = _spied(monkeypatch)
    bodies = make(monkeypatch, tmp_path)
    got = []
    for body in bodies:
        calls.clear()
        out = body(PERT0)
        assert out.dtype == torch.float32 and out.dim() == 0
        got.append((calls["carry"], calls["checksum"]))
    assert got == want
