"""The port's recorder of host spans (``huffman_tpu_torch.tracing``), on
the CPU: off by default, where no span site calls into the profiler or
reads a clock and the codec's results are unchanged; on, where the bytes
API through the block container and the batched API record exactly their
spans under their parents, with totals that hold their children; the
launch and staging sites, which run only on a card, by stand-ins; and
``debug.profile_trace``, whose Chrome trace holds the spans' ranges.
"""

import json
import types

import numpy as np
import pytest
import torch

from huffman_tpu_torch import TorchCodec, debug, staging, tracing
from huffman_tpu_torch.ops import _cuda

torch.set_num_threads(2)

BS = 64 << 10
K = 64
N_BATCH, N_PAGE = 4, 4096


def _biased(rng, n):
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    return rng.choice(256, size=n, p=p).astype(np.uint8)


@pytest.fixture(scope="module")
def raw():
    """Three 64 KiB blocks through the container."""
    return _biased(np.random.default_rng(5), 3 * BS).tobytes()


@pytest.fixture(scope="module")
def pages():
    return torch.from_numpy(_biased(np.random.default_rng(6), N_BATCH * N_PAGE)).view(
        N_BATCH, N_PAGE
    )


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and its table empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _codec():
    codec = TorchCodec(K, device="cpu")
    codec.block_bytes = BS
    return codec


def _drive(raw, pages):
    """The bytes API through the container, and the batched API; returns
    what they returned."""
    codec = _codec()
    blob = codec.compress(raw)
    back = codec.decompress(blob)
    words, bits, tables = codec.encode_batch(pages)
    out = codec.decode_batch(words, bits, tables, N_PAGE)
    return blob, back, out


def _forbid_profiler_and_clock(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span site called into the profiler or read a clock")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=refuse))


#: The spans of `_drive` on the CPU, (parent, name): count.  Three blocks
#: each way through the container; one batch each way.
EXPECTED = {
    (None, "device_api.upload"): 3,
    (None, "device_api.encode_device"): 3,
    (None, "serialize"): 3,
    ("serialize", "serialize.wait"): 3,
    ("serialize", "serialize.transpose"): 3,
    ("serialize", "serialize.pack"): 3,
    (None, "deserialize"): 3,
    ("deserialize", "deserialize.unpack"): 3,
    ("deserialize", "deserialize.upload"): 3,
    (None, "device_api.decode_device"): 3,
    (None, "device_api.encode_batch"): 1,
    (None, "device_api.decode_batch"): 1,
    ("device_api.decode_batch", "device_api.statics"): 1,
}


def test_off_by_default():
    assert tracing.ON is False
    assert tracing.span("serialize") is tracing.span("deserialize")


def test_off_calls_no_profiler_and_no_clock(raw, pages, monkeypatch):
    want = _drive(raw, pages)
    _forbid_profiler_and_clock(monkeypatch)
    blob, back, out = _drive(raw, pages)
    assert blob == want[0]
    assert back == raw == want[1]
    assert torch.equal(out, want[2])
    assert tracing.snapshot() == {}


def test_on_records_each_span_under_its_parent(raw, pages):
    want = _drive(raw, pages)
    tracing.enable()
    blob, back, out = _drive(raw, pages)
    tracing.disable()
    assert (blob, back) == want[:2] and torch.equal(out, want[2])
    table = tracing.snapshot()
    assert {key: stat.count for key, stat in table.items()} == EXPECTED


def test_on_totals_hold_their_children(raw, pages):
    tracing.enable()
    _drive(raw, pages)
    table = tracing.snapshot()
    for (parent, name), stat in table.items():
        assert stat.total_ns > 0 and stat.self_ns >= 0, (parent, name, stat)
    for name in {n for _, n in table}:
        own = sum(s.total_ns for (_, n), s in table.items() if n == name)
        kids = sum(s.total_ns for (p, _), s in table.items() if p == name)
        held = sum(s.child_ns for (_, n), s in table.items() if n == name)
        assert kids == held <= own, name


def test_reset_clears_and_disable_stops(raw, pages):
    tracing.enable()
    _drive(raw, pages)
    assert tracing.snapshot()
    tracing.reset()
    assert tracing.snapshot() == {}
    tracing.disable()
    _drive(raw, pages)
    assert tracing.snapshot() == {}


def test_a_span_open_across_reset_records_into_the_new_table():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
        tracing.reset()
    table = tracing.snapshot()
    assert set(table) == {(None, "outer")}
    assert table[(None, "outer")].count == 1
    assert 0 < table[(None, "outer")].child_ns <= table[(None, "outer")].total_ns


def test_a_span_that_raises_still_records():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("x")
    assert {k: s.count for k, s in tracing.snapshot().items()} == {
        (None, "outer"): 1, ("outer", "inner"): 1,
    }


@pytest.mark.parametrize(
    "entry,kernel", [("hist256", "hist256"), ("encode_lanes_rows", "encode_lanes")]
)
@pytest.mark.parametrize("on", [False, True])
def test_launch_is_a_span_while_on(entry, kernel, on, monkeypatch):
    """``_cuda.launch`` with a stand-in for the built C entries."""
    calls = []
    monkeypatch.setattr(_cuda, "load", lambda: {entry: lambda *a: calls.append(a) or 0})
    monkeypatch.setitem(_cuda.LAUNCHES, kernel, 0)
    if on:
        tracing.enable()
    else:
        _forbid_profiler_and_clock(monkeypatch)
    _cuda.launch(entry, 1, 2)
    assert calls == [(1, 2)] and _cuda.LAUNCHES[kernel] == 1
    table = tracing.snapshot()
    assert list(table) == ([(None, f"launch.{kernel}")] if on else [])


def test_a_failed_launch_still_raises_while_on(monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda: {"hist256": lambda *a: 700})
    tracing.enable()
    with pytest.raises(RuntimeError, match="hist256 failed to launch: error 700"):
        _cuda.launch("hist256")
    assert list(tracing.snapshot()) == [(None, "launch.hist256")]


class _Event:
    """Stands in for a CUDA event."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.mark.parametrize("on", [False, True])
def test_host_copy_wait_is_a_span_while_on(on, monkeypatch):
    copy = staging.HostCopy(torch.arange(5))
    copy._event = event = _Event()
    if on:
        tracing.enable()
    else:
        _forbid_profiler_and_clock(monkeypatch)
    with tracing.span("serialize.wait"):
        (got,) = copy.wait()
    assert event.waits == 1 and got.tolist() == list(range(5))
    want = [("serialize.wait", "staging.wait"), (None, "serialize.wait")] if on else []
    assert list(tracing.snapshot()) == want


@pytest.mark.parametrize("on", [False, True])
def test_ring_slot_wait_is_a_span_while_on(on, monkeypatch):
    ring = staging.PinnedRing("cpu", 2)
    ring._events[0] = event = _Event()
    if on:
        tracing.enable()
    else:
        _forbid_profiler_and_clock(monkeypatch)
    out = ring.upload(3, lambda buf: buf.__setitem__(slice(None), 7))
    ring.upload(3, lambda buf: buf.__setitem__(slice(None), 8))  # slot 1: no event
    assert event.waits == 1 and out.tolist() == [7, 7, 7]
    table = tracing.snapshot()
    assert {k: s.count for k, s in table.items()} == ({(None, "staging.wait"): 1} if on else {})


@pytest.mark.parametrize("was_on", [False, True])
def test_profile_trace_holds_the_spans_and_restores_the_switch(raw, tmp_path, was_on):
    if was_on:
        tracing.enable()
    codec = _codec()
    with debug.profile_trace(str(tmp_path / "trace"), device="cpu") as path:
        assert tracing.ON
        blob = codec.compress(raw)
        codec.decompress(blob)
    assert tracing.ON is was_on
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    for name in ("serialize", "serialize.transpose", "serialize.pack", "deserialize",
                 "deserialize.unpack", "deserialize.upload", "device_api.encode_device",
                 "device_api.decode_device", "device_api.upload"):
        assert tracing.PREFIX + name in names, name

