"""Fixtures of the benchmark's tests: a checkout root with small cells.

The small cells run the whole harness on the CPU (the program's plain
versions) at sizes a test holds; tests that need a card take the ``card``
fixture, which decides at run time whether there is one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Small configurations: the block one keeps the sampled table (4 MiB is
#: where the program starts sampling) and, for bytes, 3 blocks in a request.
SMALL_CONFIGS = {
    "block4m": {"unit_bytes": 4 << 20, "lanes": 32768, "block_bytes": 4 << 20},
    "pages8k": {"unit_bytes": 8192, "lanes": 64},
}
SMALL_CELLS = {
    "block4m.device": ("block4m", "device", {"pool_units": 2, "check_blobs": 2}),
    "block4m.bytes": ("block4m", "bytes", {"pool_units": 6, "check_blobs": 2}),
    "pages8k.b4": ("pages8k", "b160", {"pool_units": 16, "request_units": 4}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


#: The seed of the tests' runs of the command.
SEED = 2**31 + 777


def run_command(root: str, cell: str, seconds: float = 1.0, timeout: float = 240):
    """``hbench/run.py`` on the CPU from the copy ``root``."""
    return subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", cell, "--seed", str(SEED),
         "--seconds", str(seconds), "--trace", "0", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=timeout,
    )


#: The tests' own parts, each a new file in its directory of a copy
#: (``parts/<kind>/<name>``): the ``zlib`` profile, the ``zbytes`` entry
#: point, the ``ramp`` source, the ``ramp8k`` configuration and the
#: ``zramp`` traffic mix.
PARTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parts")
#: Cells made of those parts alone: (configuration, traffic, changes, chips).
PART_CELLS = {
    "ramp8k.zramp": ("ramp8k", "zramp", {}, 1),
    "ramp8k.zramp2": ("ramp8k", "zramp", {}, 2),
}
#: The real cell whose metric lists a small cell joins, by its traffic.
_LIKE = {"device": "block16m.device", "bytes": "block16m.bytes", "b160": "pages100k.b160"}


def make_root(tmp_path, extra_cells=SMALL_CELLS, program=False) -> str:
    """A copy of the benchmark under ``tmp_path`` whose BENCHMARK.json
    also names the small cells, each made of new files only, and holds
    the tests' own parts (`PARTS`).  A cell is (configuration, traffic,
    changes to the traffic[, chips]).  With ``program`` the copy links the
    program, its native sources and its build, so that ``hbench/run.py``
    runs there."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "hbench"), os.path.join(root, "hbench"),
                    ignore=shutil.ignore_patterns("data", "tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "hbench", "data"), os.path.join(root, "hbench", "data"))
    for kind in os.listdir(PARTS):
        for name in os.listdir(os.path.join(PARTS, kind)):
            if not name.startswith("__"):
                shutil.copy(os.path.join(PARTS, kind, name), os.path.join(root, "hbench", kind, name))
    if program:
        for name in ("huffman_tpu_torch", "native", "build"):
            os.symlink(os.path.join(ROOT, name), os.path.join(root, name))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = {c["name"]: c for c in bench["configs"]}
    for name, sizes in SMALL_CONFIGS.items():
        base = "block16m" if name.startswith("block") else "pages100k"
        with open(os.path.join(ROOT, real[base]["file"])) as f:
            cfg = json.load(f)
        cfg.update(sizes, name=name)
        path = f"hbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append(dict(real[base], name=name, file=path))
    bench["configs"].append({"name": "ramp8k", "source": "https://zlib.net",
                             "file": "hbench/configs/ramp8k.json", "reduced": [],
                             "why": "the tests' own profile, entry point and source"})
    for cell, (cfg, base, changes, *chips) in extra_cells.items():
        with open(os.path.join(root, "hbench", "traffic", f"{base}.json")) as f:
            traffic = json.load(f)
        tname = cell.replace(".", "_")
        with open(os.path.join(root, "hbench", "traffic", f"{tname}.json"), "w") as f:
            json.dump(dict(traffic, **changes), f)
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": tname,
                                   "chips": chips[0] if chips else 1, "why": "small"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if _LIKE.get(base) in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
