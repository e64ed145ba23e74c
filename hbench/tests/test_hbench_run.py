"""Whole runs of small cells on the CPU (the program's plain versions):
the result line, the check against faults planted in the timed path, the
control, and the command's refusals."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT, SMALL_CELLS, make_root

from hbench import harness, spec
from hbench.control import ControlCodec

SEED = 2**31 + 12345
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("hbench"))


def _run(root, cell, *, trace=False, codec=None, seconds=2.0):
    c = spec.load_cell(cell, root)
    if codec is not None:
        codec = codec(c)
    return harness.run_cell(c, SEED, seconds, trace, device="cpu", codec=codec)


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_sound_run_is_correct(root, cell):
    line, checks = _run(root, cell)
    assert list(line) == TOP_KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in spec.load_cell(cell, root).end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["checks"] == {n: {"value": 0, "limit": 0} for n in line["checks"]}
    assert checks == [f"check {n} 0 limit 0" for n in line["checks"]]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics(root):
    line, _ = _run(root, "block4m.bytes", trace=True)
    assert list(line) == TOP_KEYS[:5] + ["breakdown", "checks"]
    assert set(line["metrics"]) == {"serialize.ms_per_block", "deserialize.ms_per_block",
                                    "bytes_api.compress_GiB_s", "bytes_api.decompress_GiB_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_metric_added_as_a_file_is_read(tmp_path):
    root = make_root(tmp_path)
    with open(os.path.join(root, "hbench", "metrics", "harness.requests.py"), "w") as f:
        f.write("def read(run):\n    return float(run.halves['compress'].requests)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "harness.requests", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "compress_GiB_s", "workloads": ["pages8k.b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line, _ = _run(root, "pages8k.b4", trace=True)
    assert line["metrics"]["harness.requests"]["value"] > 0


class Faulty:
    """The program's codec with one fault planted in what a request returns."""

    def __init__(self, codec, fault: str):
        self._codec, self._fault, self._first = codec, fault, {}

    def __getattr__(self, name):
        return getattr(self._codec, name)

    def _stale(self, name, out):
        return self._first.setdefault(name, out) if self._fault == "stale" else out

    def encode_device(self, data):
        out = self._codec.encode_device(data)
        if self._fault == "flip":
            out.words = out.words.clone()
            out.words[0, 0] ^= 1
        return self._stale("enc", out)

    def decode_device(self, comp):
        out = self._codec.decode_device(comp)
        if self._fault == "flip":
            out = out.clone()
            out[len(out) // 2] ^= 1
        return self._stale("dec", out)

    def encode_batch(self, blocks):
        if self._fault == "half":
            words, bits, tables = self._codec.encode_batch(blocks[: len(blocks) // 2])
            twice = lambda t: torch.cat([t, t])  # noqa: E731
            return twice(words), twice(bits), {k: twice(v) for k, v in tables.items()}
        words, bits, tables = self._codec.encode_batch(blocks)
        if self._fault == "flip":
            words = words.clone()
            words[0, 0, 0] ^= 1
        return self._stale("enc", (words, bits, tables))

    def decode_batch(self, *args, **kwargs):
        out = self._codec.decode_batch(*args, **kwargs)
        if self._fault == "half":
            out = out.clone()
            out[len(out) // 2 :] = 0
        elif self._fault == "flip":
            out = out.clone()
            out[-1, 0, 0] ^= 1
        return self._stale("dec", out)

    def compress(self, raw):
        out = self._codec.compress(raw)
        if self._fault == "flip":
            out = bytearray(out)
            out[len(out) // 2] ^= 1
            out = bytes(out)
        return self._stale("enc", out)

    def decompress(self, blob):
        out = self._codec.decompress(blob)
        if self._fault == "flip":
            out = bytearray(out)
            out[len(out) // 3] ^= 1
            out = bytes(out)
        return self._stale("dec", out)


FAULTS = [
    ("block4m.device", "stale"), ("block4m.device", "flip"),
    ("pages8k.b4", "stale"), ("pages8k.b4", "half"), ("pages8k.b4", "flip"),
    ("block4m.bytes", "stale"), ("block4m.bytes", "flip"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(root, cell, fault):
    line, _ = _run(root, cell, codec=lambda c: Faulty(c.profile.make_codec(c.config, "cpu"), fault))
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


def test_failed_requests_are_not_correct(root):
    class Raising(Faulty):
        def decode_device(self, comp):
            raise RuntimeError("planted")

    line, _ = _run(root, "block4m.device",
                   codec=lambda c: Raising(c.profile.make_codec(c.config, "cpu"), "none"))
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_control_is_not_correct(root, cell):
    line, _ = _run(root, cell, codec=lambda c: ControlCodec(c.config, "cpu"))
    assert line["correct"] is False
    assert line["checks"]["table_diff"]["value"] > 0 and line["checks"]["lane_diff"]["value"] > 0
    assert line["checks"]["decode_diff"]["value"] == 0  # lossless, but not the stated tables


def test_no_forbidden_module_in_a_run(root):
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import conftest\n"
        "from hbench import harness, spec\n"
        "line, _ = harness.run_cell(spec.load_cell('pages8k.b4', %r), 7, 0.5, False, device='cpu')\n"
        "print(json.dumps([line['correct'], harness.forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n"
    ) % (ROOT, os.path.join(ROOT, "hbench", "tests"), root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    correct, bad, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert "huffman_tpu_torch" in tops and not {"jax", "jaxlib", "flax", "huffman_tpu"} & set(tops)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "huffman_tpu_torchish", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import hbench.reference, hbench.check\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    tops = set(json.loads(out.stdout.strip()))
    assert not tops & {"huffman_tpu_torch", "huffman_tpu", "jax", "jaxlib", "torch"}


def test_command_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", "block16m.device", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.card
def test_command_without_the_program_fails(card, tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "hbench"), tmp_path / "hbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", "block16m.device", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["block16m.device", "pages100k.b16"])
def test_cell_on_the_card_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", cell, "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["block16m.device", "pages100k.b16"])
def test_control_on_the_card_is_not_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "hbench/control.py", "--workload", cell, "--seed", str(SEED),
         "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0 and json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False


def test_seed_makes_the_pool(root):
    from hbench import traffic

    c = spec.load_cell("pages8k.b4", root)
    a = traffic.make_pool(c.config, c.traffic, SEED, "cpu")
    b = traffic.make_pool(c.config, c.traffic, SEED, "cpu")
    d = traffic.make_pool(c.config, c.traffic, SEED + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert a.shape == (16, 8192)
    c = spec.load_cell("block4m.device", root)
    big = traffic.make_pool(c.config, c.traffic, -5, "cpu").numpy()
    freq = np.bincount(big.reshape(-1), minlength=256) / big.size
    p = 0.8 ** np.arange(256) * 0.2
    assert np.abs(freq[:8] - p[:8] / p.sum()).max() < 1e-3
