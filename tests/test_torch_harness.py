"""The port's measurement path (bench/harness.py, bench/table.py, native
NativeCodec, tools/) against huffman_tpu's on the CPU.  Ratios, round
trips and rendered tables are compared exactly; times only for being
finite and positive (a CPU time says nothing of the card).
"""

import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu import native as jnative
from huffman_tpu.bench import harness as jharness
from huffman_tpu.bench import table as jtable
from huffman_tpu.models.tpu_codec import TpuCodec
from huffman_tpu_torch import TorchCodec, native
from huffman_tpu_torch.bench import harness, render_markdown, run_suite, workloads
from huffman_tpu_torch.tools import hist_experiments, run_benchmarks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"method", "streams", "compress_bps", "decompress_bps", "ratio", "roundtrip_ok"}


def _jax_run_benchmarks():
    spec = importlib.util.spec_from_file_location(
        "_jax_run_benchmarks", os.path.join(REPO, "tools", "run_benchmarks.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RESULTS = {
    "biased": {"bytes": 102400, "rows": [
        {"method": "Torch<auto>", "streams": 1024, "compress_bps": 3.5e9,
         "decompress_bps": 7.25e9, "ratio": 0.4648, "roundtrip_ok": True},
        {"method": "NativeHost", "streams": 32, "compress_bps": 5.1e8,
         "decompress_bps": 8.0e8, "ratio": 0.46335, "roundtrip_ok": False},
    ]},
    "short": {"bytes": 100, "rows": [
        {"method": "zlib-1", "streams": 1, "compress_bps": 1.0e6,
         "decompress_bps": 2.0e6, "ratio": 1.11},
    ]},
}


@pytest.mark.parametrize("which", ["ok and mismatch", "empty"])
def test_render_markdown_matches_jax(which):
    results = RESULTS if which != "empty" else {}
    out = render_markdown(results)
    assert out == jtable.render_markdown(results)
    if results:
        assert "**(MISMATCH!)**" in out


@pytest.mark.parametrize("names", [["biased", "uniform"], ["sorted", "lorem", "short"]])
def test_run_suite_bytes_rows_match_jax(names):
    jzlib = _jax_run_benchmarks()._ZlibCodec(1)
    n = 64 << 10
    got = run_suite(names, [
        ("bytes", "NativeHost", 32, native.NativeCodec(32)),
        ("bytes", "zlib-1", 1, run_benchmarks.ZlibCodec(1)),
    ], n)
    want = jharness.run_suite(names, [
        ("bytes", "NativeHost", 32, jnative.NativeCodec(32)),
        ("bytes", "zlib-1", 1, jzlib),
    ], n)
    assert list(got) == list(want)
    for wname in names:
        assert got[wname]["bytes"] == want[wname]["bytes"]
        for g, w in zip(got[wname]["rows"], want[wname]["rows"], strict=True):
            assert set(g) == KEYS
            assert (g["method"], g["streams"], g["ratio"], g["roundtrip_ok"]) == (
                w["method"], w["streams"], w["ratio"], w["roundtrip_ok"]
            )
            assert g["roundtrip_ok"] is True
            assert math.isfinite(g["compress_bps"]) and g["compress_bps"] > 0


def test_native_codec_matches_jax():
    raw = workloads.make_workload("lorem", 50_000)
    c, jc = native.NativeCodec(8), jnative.NativeCodec(8)
    assert c.name == jc.name == "Native<8>"
    assert c.compress(raw) == jc.compress(raw)
    assert c.decompress(jc.compress(raw)) == raw


def test_bench_torch_codec_on_cpu():
    raw = workloads.biased_u8(256 << 10, 0).tobytes()
    row = harness.bench_torch_codec(TorchCodec(device="cpu"), raw, reps=2)
    assert set(row) == KEYS
    jc = TpuCodec()
    blob = jc.serialize(jc.encode_device(jnp.asarray(np.frombuffer(raw, np.uint8))))
    assert row["ratio"] == len(blob) / len(raw)
    assert row["roundtrip_ok"] is True
    assert row["method"] == "Torch<auto>" and row["streams"] == 2048
    assert math.isfinite(row["compress_bps"]) and row["compress_bps"] > 0
    assert math.isfinite(row["decompress_bps"]) and row["decompress_bps"] > 0


def test_sustained_seconds_on_cpu():
    x = torch.arange(1 << 16, dtype=torch.float32)

    def body(pert):
        return (x + pert).sum()

    sec = harness.sustained_seconds(body, reps=4, tries=2, device="cpu")
    assert math.isfinite(sec) and sec > 0


def test_sustained_seconds_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        harness.sustained_seconds(lambda pert: pert.sum(), device="meta")


@pytest.mark.parametrize("k", [None, 8192, 32768])
def test_torch_codec_name_matches_jax(k):
    assert TorchCodec(k, device="cpu").name == TpuCodec(k).name.replace("Tpu", "Torch")


def test_race_on_cpu():
    data = torch.from_numpy(hist_experiments.race_block(1 << 19))
    rows = hist_experiments.race_on(data, reps=2, tries=1)
    assert [r["name"] for r in rows] == [
        "hist256", "base", "bf16cmp", "f32cmp", "i8dot", "wide", "bincount"
    ]
    assert [r["kind"] for r in rows] == [
        "atomics", "bf16", "bf16", "tf32", "s8", "bf16", "library"
    ]
    for r in rows:
        assert r["ok"] is True and r["timing"] == "host" and r["device_ms"] is None
        assert math.isfinite(r["ms"]) and r["ms"] > 0
        assert "OK" in hist_experiments.format_row(r)


def test_race_propagates_failures():
    with pytest.raises(ValueError, match="multiple"):
        hist_experiments.race_on(torch.zeros((1 << 19) + 64, dtype=torch.uint8), reps=2, tries=1)


def test_run_benchmarks_main_on_cpu(tmp_path, capsys, monkeypatch):
    """``main`` with the suite's rows built on the CPU in place of the card."""
    codecs = run_benchmarks.suite_codecs
    monkeypatch.setattr(run_benchmarks, "suite_codecs", lambda: codecs("cpu"))
    monkeypatch.setattr(run_benchmarks, "card_line", lambda: "no card")
    out = tmp_path / "results.json"
    run_benchmarks.main([
        "--size", str(64 << 10), "--workloads", "biased", "--fast", "--out", str(out),
    ])
    results = json.loads(out.read_text())
    rows = results["biased"]["rows"]
    assert [r["method"] for r in rows] == [
        "Torch<auto>", "Torch<8192>", "Torch<32768>", "TorchRef", "NativeHost", "NativeHost",
        "zlib-1",
    ]
    assert all(r["roundtrip_ok"] for r in rows)
    assert render_markdown(results) in capsys.readouterr().out

