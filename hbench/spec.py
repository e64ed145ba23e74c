"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; the configuration's file is the one its
entry names, the traffic mix is ``hbench/traffic/<traffic>.json``, and
every metric, end to end or per layer, is a reader of its own,
``hbench/metrics/<name>.py`` with a function ``read(run)``.  A later cell,
configuration, traffic mix or metric is new files and entries; nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: str


def _reports(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: it lists the cell, or it has
    no list and the cell reports the end-to-end metric that it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; KeyError where
    there is none."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "hbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, e2e, per_layer, root)


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of ``<root>/hbench/metrics/<metric>.py``."""
    path = os.path.join(root, "hbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("hbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
