"""bench_torch.py, the port's benchmark entry, against bench.py on the CPU.

The one-line contract (a failure line and a non-zero exit without a
card, from ``--once`` and from the supervisor; the watchdog's line), the
line's exact fields (roundtrip_ok, k_lanes, ratio, ratio_payload at the
four decimals it prints) against bench.py's derivation through TpuCodec,
the decode body's word count w against ``decode_statics``, and the
last-good record's path.  Times are checked only for being finite and
positive: a CPU time says nothing of the card.
"""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from huffman_tpu.models import tpu_codec
from huffman_tpu_torch import TorchCodec
from huffman_tpu_torch.bench import harness, workloads
from huffman_tpu_torch.models import torch_codec
from huffman_tpu_torch.ops.decode_bits import decode_lanes
from corpus import standard_cases

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry(*args, **env):
    """bench_torch.py (or ``-c`` code) in a subprocess that sees no card
    on any machine."""
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(CUDA_VISIBLE_DEVICES="", **env)
    args = args if args[:1] == ("-c",) else ("bench_torch.py", *args)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=120)


def _one_null_line(r):
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout + r.stderr
    line = json.loads(lines[0])
    assert line["metric"] == "biased 16MiB compress+decompress sustained, 1 chip"
    assert line["value"] is None and line["unit"] == "GiB/s"
    assert "stage" in line and "last_known_good" in line
    assert r.returncode != 0
    return line


@pytest.mark.parametrize("entry", [["--once"], []], ids=["once", "supervisor"])
def test_no_card_prints_one_failure_line(entry):
    r = _entry(*entry)
    line = _one_null_line(r)
    assert "no CUDA device" in line["error"]
    assert line["stage"] == "cuda probe"
    provisional = [json.loads(x) for x in r.stderr.splitlines() if x.startswith("{")]
    assert [p.get("provisional") for p in provisional] == ([True] if not entry else [])


def test_probe_deadline_gives_a_watchdog_line():
    line = _one_null_line(_entry("--once", BENCH_PROBE_DEADLINE_S="0"))
    assert line["error"].startswith("watchdog timeout at stage")


def test_a_whole_run_loads_neither_jax_nor_huffman_tpu(tmp_path):
    code = (
        "import pathlib, sys, bench_torch\n"
        f"bench_torch.LAST_GOOD_PATH = pathlib.Path({str(tmp_path)!r}) / 'record.json'\n"
        "bench_torch.run(device='cpu', n=1 << 16, reps=2, tries=1, max_reps=2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'huffman_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = _entry("-c", code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["detail"]["roundtrip_ok"] is True


def _jax_line(data: np.ndarray) -> dict:
    """bench.py's derivation of the line's exact fields (bench.py:150-158,
    206-224) through TpuCodec on the CPU."""
    n = len(data)
    codec = tpu_codec.TpuCodec()
    comp = codec.encode_device(jnp.asarray(data))
    ok = np.array_equal(np.asarray(codec.decode_device(comp)), data)
    return {
        "ratio": round(n / len(codec.serialize(comp)), 4),
        "ratio_payload": round(n / (int(np.asarray(comp.bit_counts).sum()) / 8), 4),
        "k_lanes": comp.k,
        "roundtrip_ok": bool(ok),
    }


def test_run_on_cpu_matches_bench_py(tmp_path, monkeypatch, capsys):
    n = 1 << 20
    record = tmp_path / "bench_last_good.json"
    jax_record = os.path.join(REPO, "benchmarks", "last_good.json")
    with open(jax_record, "rb") as f:
        before = f.read()
    monkeypatch.setattr(bench_torch, "LAST_GOOD_PATH", record)
    line = bench_torch.run(device="cpu", n=n, reps=2, tries=1, max_reps=8)
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in printed] == [line]
    d = line["detail"]
    assert {k: d[k] for k in ("ratio", "ratio_payload", "k_lanes", "roundtrip_ok")} == (
        _jax_line(workloads.biased_u8(n, 0)))
    assert d["roundtrip_ok"] is True and d["method"] == "host clock" and d["card"] == "cpu"
    for key in ("compress_GiB_s", "decompress_GiB_s"):
        assert math.isfinite(d[key]) and d[key] > 0
    # The combined rate from the two printed rates: each is rounded to
    # four decimals, a few tenths of a percent at CPU rates.
    combined = 1 / (1 / d["compress_GiB_s"] + 1 / d["decompress_GiB_s"])
    assert math.isclose(line["value"], combined, rel_tol=0.02)
    assert math.isclose(line["vs_baseline"], line["value"] / 1.830, rel_tol=0.02)
    saved = json.loads(record.read_text())
    assert saved["detail"] == d and saved["measured_at"].endswith("Z")
    with open(jax_record, "rb") as f:
        assert f.read() == before


def test_mismatch_gives_a_failure_line_with_the_last_good_record(tmp_path, monkeypatch, capsys):
    record = tmp_path / "bench_last_good.json"
    record.write_text(json.dumps({"value": 1.5}))
    monkeypatch.setattr(bench_torch, "LAST_GOOD_PATH", record)
    monkeypatch.setattr(TorchCodec, "decode_device",
                        lambda self, comp: torch.zeros(comp.raw_size, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="round-trip mismatch"):
        bench_torch.run(device="cpu", n=1 << 16, reps=2, tries=1)
    line = json.loads(capsys.readouterr().out)
    assert line["value"] is None and line["last_known_good"] == {"value": 1.5}
    assert line["stage"] == "roundtrip check" and "dispatch_ms" in line["partial"]
    assert json.loads(record.read_text()) == {"value": 1.5}


def _blocks():
    blocks = {name: workloads.make_workload(name) for name in ("biased", "uniform", "sorted", "lorem")}
    blocks.update({f"corpus {name}": raw for name, raw in standard_cases() if raw})
    blocks["constant"] = b"\xa5" * 65536
    return blocks


BLOCKS = _blocks()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_decode_words_match_decode_statics(name):
    """The port's w is decode_statics' on the same block, and the lane
    decode of the first w rows gives the bytes of all W (plain version)."""
    raw = BLOCKS[name]
    data = np.frombuffer(raw, np.uint8)
    comp = TorchCodec(device="cpu").encode_device(torch.from_numpy(data.copy()))
    jcomp = tpu_codec.TpuCodec().encode_device(jnp.asarray(data))
    s = -(-len(raw) // comp.k)
    w = torch_codec.decode_statics(comp.meta(), s)
    assert w == tpu_codec.decode_statics(jcomp.meta(), s)[1]
    assert w <= comp.words.shape[0]
    t = comp.tables
    tabs = (t["e_bound"], t["g_rank"], t["sorted_syms"])
    full = decode_lanes(comp.words, *tabs, s)
    assert torch.equal(decode_lanes(comp.words[: max(w, 1)], *tabs, s), full)
    if comp.meta()["num_syms"] > 1:
        assert full.reshape(-1)[: len(raw)].numpy().tobytes() == raw


def test_decode_body_reads_only_the_scanned_words(monkeypatch):
    """bench.py's decode body: the carried 0 goes onto the first w rows
    alone, and the body sums the block's bytes."""
    data = workloads.biased_u8(1 << 20, 0)
    comp = TorchCodec(device="cpu").encode_device(torch.from_numpy(data))
    s = -(-len(data) // comp.k)
    w = torch_codec.decode_statics(comp.meta(), s)
    assert 0 < w < comp.words.shape[0]
    seen = []

    def spy(words, *args):
        seen.append(tuple(words.shape))
        return decode_lanes(words, *args)

    monkeypatch.setattr("huffman_tpu_torch.ops.decode_bits.decode_lanes", spy)
    acc, step = harness.sustained_step(harness.decode_body(comp), "cpu")
    assert step() is None
    assert seen == [(w, comp.k)]
    assert acc.dtype == torch.float32 and float(acc) == float(data.astype(np.int64).sum())
