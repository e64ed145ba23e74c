"""The sustained loop's carried 0 and fold (``bench/fused.py``) beside
the JAX harness on the CPU.

`fold_plain` must give ``acc + (jnp.sum(a) + ...).astype(jnp.float32)``
exactly (one int32 total that wraps, one conversion), and `carry_plain`
must add ``jnp.isnan(acc).astype(jnp.uint8)`` as ``x + pert`` does.  The
port's bodies must give the JAX bodies' float32 values on the same block
(the JAX bodies are captured from ``huffman_tpu.bench.harness.
bench_tpu_codec`` and ``tools/bench_streaming.py`` by standing in for
``sustained_seconds``), and after R steps of `harness.sustained_step`
the accumulator must equal the JAX harness's ``fori_loop`` over the same
body bit for bit.  Every sustained body of the port must go through
`fused.carry` and `fused.fold` and return nothing, shown by spies.  The
kernels themselves run only on a card: ``chip_smoke.py`` holds them
against these plain versions there.
"""

import collections
import importlib.util
import os
import pathlib
import sys
import tempfile

import jax
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
NAN = float("nan")


def _acc(value=0.0):
    acc = fused.accumulator("cpu")
    acc.fill_(value)
    return acc


def _jax_fold(acc0, xs):
    """``acc0 + (jnp.sum(x0) + jnp.sum(x1) + ...).astype(jnp.float32)``,
    each sum over ``x.astype(jnp.int32)``, as the JAX bodies write it."""
    total = sum(jnp.sum(jnp.asarray(x).astype(jnp.int32)) for x in xs)
    return np.float32(jnp.float32(acc0) + jnp.asarray(total, jnp.int32).astype(jnp.float32))


FOLD_CASES = {
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


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_fold_plain_wraps_as_jax(name):
    x = FOLD_CASES[name]()
    want = _jax_fold(0.0, [x])
    acc = _acc()
    assert fused.fold_plain(acc, torch.from_numpy(x)) is None
    assert acc.dtype == torch.float32 and acc.dim() == 0
    assert np.float32(acc) == want
    again = _acc()
    fused.fold(again, torch.from_numpy(x))
    assert np.float32(again) == want
    if name == "16 MiB of 0xFF":  # 4278190080 wraps
        assert np.float32(acc) == np.float32(4278190080 - (1 << 32)) == np.float32(-16777216)


def _u8_view(n, off, seed=3):
    return workloads.biased_u8(n + off + 16, seed)[off : off + n]


# (acc before, the tensors folded): the int32 total wraps, rounds to
# float32 once, and the float add rounds again.
FOLD_MULTI_CASES = {
    "u8 and int32 together": (
        1.5, lambda: [workloads.biased_u8(1 << 16), np.arange(-300, 5000, dtype=np.int32)]),
    "bit counts and table": (0.0, lambda: [
        np.random.default_rng(4).integers(0, 5000, 131072).astype(np.int32),
        np.random.default_rng(5).integers(0, 1 << 20, 256).astype(np.int32)]),
    # 2^24 + 1 and 1: one total 2^24 + 2 is exact; two conversions would
    # give 2^24 + 0 and then 2^24 again.
    "one total past 2^24": (0.0, lambda: [
        np.array([1 << 24, 1], np.int32), np.array([1], np.int32)]),
    "past 2^24, odd totals round to even": (0.0, lambda: [
        np.array([(1 << 24) + 1], np.int32), np.array([(1 << 25) + 2], np.int32)]),
    "acc past 2^24 takes a small total": (float(1 << 24), lambda: [np.array([1], np.int32)]),
    "totals that wrap across tensors": (0.0, lambda: [
        np.full(2, (1 << 31) - 1, np.int32), np.full(3 << 20, 0xFF, np.uint8)]),
    "NaN acc stays NaN": (NAN, lambda: [np.arange(100, dtype=np.uint8)]),
    "u8 views off alignment": (0.0, lambda: [_u8_view(4097, off) for off in (1, 7, 15)]),
    "four tensors": (-2.0, lambda: [np.arange(7, dtype=np.uint8)] * 4),
}


@pytest.mark.parametrize("name", list(FOLD_MULTI_CASES))
def test_fold_plain_of_many_tensors_is_one_total(name):
    acc0, make = FOLD_MULTI_CASES[name]
    xs = make()
    want = _jax_fold(acc0, xs)
    acc = _acc(acc0)
    fused.fold_plain(acc, *(torch.from_numpy(np.ascontiguousarray(x)) for x in xs))
    np.testing.assert_array_equal(np.float32(acc), want)
    if name == "one total past 2^24":
        assert np.float32(acc) == np.float32(16777218)


CARRY_CASES = {
    "u8, acc 0": (lambda: workloads.biased_u8(1 << 16), 0.0),
    "u8, acc NaN (255 wraps to 0)": (lambda: np.arange(1 << 12).astype(np.uint8), NAN),
    "int32, acc 0": (lambda: np.arange(-2048, 2048, dtype=np.int32), 0.0),
    "int32, acc NaN": (lambda: np.array([-1, 0, (1 << 31) - 1, 7], np.int32), NAN),
    "empty u8, acc NaN": (lambda: np.zeros(0, np.uint8), NAN),
    "u8 view off alignment, acc -inf": (lambda: _u8_view(1000, 5), float("-inf")),
}


@pytest.mark.parametrize("name", list(CARRY_CASES))
def test_carry_plain_adds_as_jax(name):
    make, a = CARRY_CASES[name]
    x = make()
    pert = jnp.isnan(jnp.float32(a)).astype(jnp.uint8)
    want = np.asarray(jnp.asarray(x) + pert)
    acc = _acc(a)
    got = fused.carry_plain(torch.from_numpy(np.ascontiguousarray(x)), acc)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(fused.carry(torch.from_numpy(np.ascontiguousarray(x)), acc), got)
    if x.dtype == np.uint8 and a != a and x.size:
        assert int(got[255]) == 0


BAD_ARGS = {
    "int64 x to carry": lambda: fused.carry(torch.zeros(4, dtype=torch.int64), _acc()),
    "int64 x to fold": lambda: fused.fold(_acc(), torch.zeros(4, dtype=torch.int64)),
    "strided x": lambda: fused.fold(_acc(), torch.zeros((4, 4), dtype=torch.uint8).t()),
    "uint8 acc": lambda: fused.carry(torch.zeros(4, dtype=torch.uint8),
                                     torch.zeros((), dtype=torch.uint8)),
    "acc of shape (1,)": lambda: fused.carry(torch.zeros(4, dtype=torch.uint8),
                                             torch.zeros(1, dtype=torch.float32)),
    "a meta tensor": lambda: fused.fold(torch.zeros((), device="meta"),
                                        torch.empty(4, dtype=torch.uint8, device="meta")),
    "acc on another device": lambda: fused.fold(torch.zeros((), device="meta"),
                                                torch.zeros(4, dtype=torch.uint8)),
    "nothing to fold": lambda: fused.fold(_acc()),
    "five tensors to fold": lambda: fused.fold(_acc(), *[torch.zeros(4, dtype=torch.uint8)] * 5),
}


@pytest.mark.parametrize("name", list(BAD_ARGS))
def test_bad_arguments_raise(name):
    with pytest.raises(ValueError):
        BAD_ARGS[name]()


def test_accumulator_is_a_zero_with_scratch_words_after_it():
    acc = fused.accumulator("cpu")
    assert acc.dtype == torch.float32 and acc.dim() == 0 and float(acc) == 0.0
    assert acc.storage_offset() == 0 and acc.untyped_storage().tolist() == [0] * 16


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
    (huffman_tpu/bench/harness.py:127-145, the bodies of bench.py:172-190)."""
    bodies = _capture_bodies(monkeypatch, jharness)
    jharness.bench_tpu_codec(TpuCodec(), raw)
    assert len(bodies) == 2
    return bodies


def _jax_value(body):
    return np.float32(body(jnp.zeros((), jnp.uint8)))


def _value(body):
    """The accumulator after one step of ``body``, which returns nothing."""
    acc, step = harness.sustained_step(body, "cpu")
    assert step() is None
    assert acc.dtype == torch.float32 and acc.dim() == 0
    return np.float32(acc)


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


@pytest.fixture(scope="module")
def loop_pairs():
    """body name -> (the JAX body, the port's body) on the 1 MiB biased
    block: ``bench.py``'s compress and decompress bodies (as
    ``bench_tpu_codec`` has them) beside `harness.encode_body` /
    `decode_body`, and the JAX ``bench_streaming``'s three beside the
    port tool's."""
    data = workloads.biased_u8(1 << 20)
    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as tmp:
        jenc, jdec = _jax_bench_bodies(mp, data.tobytes())
        js = _jax_streaming_bodies(mp, pathlib.Path(tmp), 1)
        ps = _capture_bodies(mp, bench_streaming)
        bench_streaming.shared_table_row(1 << 20, 2, "cpu")
    codec = TorchCodec(device="cpu")
    t = torch.from_numpy(data.copy())
    return {
        "encode_body": (jenc, harness.encode_body(codec, t)),
        "decode_body": (jdec, harness.decode_body(codec.encode_device(t))),
        "bench_streaming enc_once": (js[0], ps[0]),
        "bench_streaming dec_once": (js[1], ps[1]),
        "bench_streaming combined_once": (js[2], ps[2]),
    }


@pytest.fixture(scope="module")
def jax_loops(loop_pairs):
    """body name -> ``r -> acc`` after r iterations of the JAX harness's
    ``it(i, acc) = acc + body(jnp.isnan(acc).astype(jnp.uint8))``
    (huffman_tpu/bench/harness.py:40-42), r traced: one compile a body."""
    loops = {}
    for name, (jbody, _) in loop_pairs.items():
        def it(i, acc, jbody=jbody):
            return acc + jbody(jnp.isnan(acc).astype(jnp.uint8))

        loops[name] = jax.jit(lambda r, it=it: jax.lax.fori_loop(0, r, it, jnp.float32(0.0)))
    return loops


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("name", [
    "encode_body", "decode_body", "bench_streaming enc_once", "bench_streaming dec_once",
    "bench_streaming combined_once",
])
def test_accumulator_after_r_steps_equals_the_jax_fori_loop(name, steps, loop_pairs, jax_loops):
    want = np.float32(jax_loops[name](steps))
    acc, step = harness.sustained_step(loop_pairs[name][1], "cpu")
    for _ in range(steps):
        step()
    assert np.float32(acc).tobytes() == want.tobytes()
    assert want != 0


def test_a_nan_accumulator_carries_one_into_the_next_step():
    """Once ``acc`` is NaN the carried value is 1 and the sums still fold
    in (and leave it NaN), as ``jnp.isnan(acc)`` in the JAX loop."""
    x = torch.from_numpy(np.array([0, 254, 255], np.uint8))
    seen = []

    def body(acc):
        y = fused.carry(x, acc)
        seen.append(y.tolist())
        fused.fold(acc, y)

    acc, step = harness.sustained_step(body, "cpu")
    step()
    acc.fill_(NAN)
    step()
    assert seen == [[0, 254, 255], [1, 255, 0]]
    assert np.isnan(np.float32(acc))


def _spied(monkeypatch):
    """Counts of `fused.carry` and `fused.fold` calls and of the tensors
    folded, through spies that call the real functions."""
    calls = collections.Counter()
    for name in ("carry", "fold"):
        real = getattr(fused, name)

        def spy(*args, name=name, real=real):
            calls[name] += 1
            if name == "fold":
                calls["folded"] += len(args) - 1
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


# Each tool's bodies in order, with the carry calls, the fold calls and
# the tensors folded of one run of each.
SPIED = {
    "harness encode_body, decode_body": (lambda mp, tmp: _harness_bodies(mp),
                                         [(1, 1, 2), (1, 1, 1)]),
    "bench_streaming enc_once, decode_body, combined_once, enc_b, dec_b": (
        lambda mp, tmp: _streaming_bodies(mp),
        [(1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 1)]),
    "hist_experiments race": (lambda mp, tmp: _race_bodies(mp), [(1, 1, 1)] * 7),
    "probe_encode_stages dep, hist/1, hist/S, table, kernel, full": (
        _stage_bodies, [(1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 3)]),
    "probe_batched dep, hist_b, table, body, full": (
        lambda mp, tmp: _batched_stage_bodies(mp),
        [(1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2)]),
    "bench_sharded one-rank row": (lambda mp, tmp: _sharded_bodies(mp), [(1, 1, 1)]),
}


@pytest.mark.parametrize("name", list(SPIED))
def test_every_sustained_body_goes_through_carry_and_checksum(name, monkeypatch, tmp_path):
    """Every body carries its 0 with one `fused.carry` and folds its sums
    into the accumulator with one `fused.fold`, and returns nothing for
    the harness to add (the test's name is from when the sums were
    `checksum`s that the harness added)."""
    make, want = SPIED[name]
    calls = _spied(monkeypatch)
    bodies = make(monkeypatch, tmp_path)
    got = []
    for body in bodies:
        calls.clear()
        acc, step = harness.sustained_step(body, "cpu")
        assert step() is None
        assert np.isfinite(np.float32(acc))
        got.append((calls["carry"], calls["fold"], calls["folded"]))
    assert got == want
