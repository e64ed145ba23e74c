"""Fixtures of the benchmark's tests: a checkout root with small cells.

The small cells run the whole harness on the CPU (the program's plain
versions) at sizes a test holds; tests that need a card take the ``card``
fixture, which decides at run time whether there is one.
"""

from __future__ import annotations

import json
import os
import shutil
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


def make_root(tmp_path, extra_cells=SMALL_CELLS) -> str:
    """A copy of the benchmark under ``tmp_path`` whose BENCHMARK.json
    also names the small cells, each made of new files only."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "hbench"), os.path.join(root, "hbench"),
                    ignore=shutil.ignore_patterns("data", "tests", "__pycache__"))
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
    for cell, (cfg, base, changes) in extra_cells.items():
        with open(os.path.join(ROOT, "hbench", "traffic", f"{base}.json")) as f:
            traffic = json.load(f)
        tname = cell.replace(".", "_")
        with open(os.path.join(root, "hbench", "traffic", f"{tname}.json"), "w") as f:
            json.dump(dict(traffic, **changes), f)
        bench["workloads"].append(
            {"name": cell, "config": cfg, "traffic": tname, "chips": 1, "why": "small"}
        )
        for m in bench["end_to_end"] + bench["per_layer"]:
            real_cell = {"device": "block16m.device", "bytes": "block16m.bytes"}.get(base, "pages100k.b160")
            if real_cell in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
