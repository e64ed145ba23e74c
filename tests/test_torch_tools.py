"""The port's measurement tools (``huffman_tpu_torch.tools``: the
counterparts of tools/bench_streaming.py, bench_small.py, probe_k.py,
probe_encode_stages.py and probe_batched.py) through their ``main()`` on
the CPU at 1 MiB or less with few reps: every row that has a round trip
holds it, and the JSON lands where ``--out`` says.  Without ``--device``
a tool runs on the card, so here it raises; a failing row raises too.
"""

import json

import pytest
import torch

from huffman_tpu_torch.tools import (
    bench_small,
    bench_streaming,
    probe_batched,
    probe_encode_stages,
    probe_k,
)

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_bench_streaming(tmp_path):
    out = tmp_path / "streaming.json"
    res = bench_streaming.main(["--fast", "--block-mib", "1", "--bs", "1,3", *CPU, "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(res))
    row = res["streaming_shared_table"]
    assert row["block_bytes"] == 1 << 20 and row["roundtrip_ok"] and row["timing"] == "host clock"
    assert 2.0 < row["ratio"] < 2.4
    curve = res["batched_100KiB_curve"]
    assert [r["blocks"] for r in curve] == [1, 3]
    assert [r["reps"] for r in curve] == [8, 8]  # max(2, reps // max(1, B // 8))
    assert all(r["roundtrip_ok"] and r["compress_GiB_s"] > 0 for r in curve)


def test_bench_small_skips_lanes_above_the_size(tmp_path):
    out = tmp_path / "small.json"
    res = bench_small.main(["--sizes", "4096,65536", "--ks", "auto,1024,8192", "--reps", "2",
                            *CPU, "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(res))
    assert [r["k"] for r in res["4096"]] == ["k=32 (auto)", "k=1024"]
    # 1024 is 64 KiB's auto choice: no second row for it.
    assert [r["k"] for r in res["65536"]] == ["k=1024 (auto)", "k=8192"]
    assert all(r["roundtrip_ok"] for rows in res.values() for r in rows)


def test_bench_small_raises_on_a_failing_row(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("kernel shape rejected")

    monkeypatch.setattr(bench_small, "bench_torch_codec", boom)
    with pytest.raises(ValueError, match="rejected"):
        bench_small.main(["--sizes", "4096", *CPU, "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_probe_k(tmp_path):
    out = tmp_path / "k.json"
    rows = probe_k.main(["--ks", "2048,8192", "--size", str(1 << 20), "--reps", "2", *CPU,
                         "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(rows))
    assert [(r["k"], r["s"], r["w32"]) for r in rows] == [(2048, 512, 241), (8192, 128, 61)]
    assert all(r["roundtrip_ok"] for r in rows)


def test_probe_encode_stages(tmp_path):
    out = tmp_path / "stages.json"
    rows = probe_encode_stages.main(["0.25", "--reps", "2", *CPU, "--out", str(out)])
    res = _load(out)
    assert (res["n"], res["k"], res["s"], res["hist_stride"]) == (1 << 18, 2048, 128, 1)
    assert [r["stage"] for r in rows] == ["dep", "hist/1", "hist/1", "table", "kernel", "full"]
    assert all(r["ms"] > 0 for r in rows)


def test_probe_batched(tmp_path):
    out = tmp_path / "batched.json"
    res = probe_batched.main(["--bs", "1,2", "--reps", "2", "--artifact-b", "2", *CPU,
                              "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(res))
    assert [r["blocks"] for r in res["curve"]] == [1, 2]
    r = res["curve"][1]
    assert r["sum_stages_ms"] == r["hist_b_ms"] + r["table_ms"] + r["body_ms"]
    assert res["artifact_check"]["blocks"] == 2 and res["artifact_check"]["reps2_GiB_s"] > 0


def test_probe_batched_skip_artifact_and_max_reps(tmp_path, monkeypatch):
    """``--skip-artifact`` drops the check at ``--artifact-b`` and
    ``--max-reps`` reaches every stage's `sustained_seconds`, as the JAX
    tool's flags do."""
    caps = []
    real = probe_batched.sustained_seconds

    def spy(body, *args, **kwargs):
        caps.append(kwargs["max_reps"])
        return real(body, *args, **kwargs)

    monkeypatch.setattr(probe_batched, "sustained_seconds", spy)
    out = tmp_path / "batched.json"
    res = probe_batched.main(["--bs", "1", "--reps", "2", "--skip-artifact", "--max-reps", "8",
                              *CPU, "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(res))
    assert res["artifact_check"] == {}
    assert caps == [8] * 5  # dep, hist_b, table, body, full at B = 1; no artifact rows
    caps.clear()
    probe_batched.main(["--bs", "1", "--reps", "2", "--artifact-b", "1", "--max-reps", "16",
                        *CPU, "--out", str(out)])
    assert caps == [16] * 7  # the five stages, then full at reps 2 and --reps


TOOLS = {
    "bench_streaming": (bench_streaming.main, ["--fast", "--block-mib", "1", "--bs", "1"]),
    "bench_small": (bench_small.main, ["--sizes", "4096", "--reps", "2"]),
    "probe_k": (probe_k.main, ["--ks", "8192", "--size", str(1 << 20), "--reps", "2"]),
    "probe_encode_stages": (probe_encode_stages.main, ["0.25", "--reps", "2"]),
    "probe_batched": (probe_batched.main, ["--bs", "1", "--reps", "2", "--artifact-b", "1"]),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tools_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    main, argv = TOOLS[name]
    with pytest.raises((AssertionError, RuntimeError)):
        main([*argv, "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
