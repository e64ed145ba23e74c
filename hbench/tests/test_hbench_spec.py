"""BENCHMARK.json and the files it names: the contract's shape, and a
harness that finds every piece by name."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT, make_root

from hbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["hbench"] and bench["command"] == ["python3", "hbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_entries(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_cells_configs_and_files(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert list(cells) == ["block16m.device", "pages100k.b160", "block16m.bytes", "pages100k.b16"]
    assert all(w["chips"] == 1 for w in cells.values())
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("hbench/") and c["reduced"] == []
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    for w in cells.values():
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "hbench", "traffic", f"{w['traffic']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "hbench", "metrics", f"{m['name']}.py")), m["name"]
        for w in m.get("workloads", ()):
            assert w in cells


@pytest.mark.parametrize(
    "cell", ["block16m.device", "pages100k.b160", "block16m.bytes", "pages100k.b16"]
)
def test_load_cell_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "ratio"}
    assert c.per_layer, "every cell reports a per-layer metric"
    reported = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in reported for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_cell_added_as_files_alone_is_found(tmp_path):
    root = make_root(tmp_path)
    c = spec.load_cell("pages8k.b4", root)
    assert c.config["unit_bytes"] == 8192 and c.traffic["request_units"] == 4
    assert {m["name"] for m in c.per_layer} >= {"api.encode_call_ms"}
