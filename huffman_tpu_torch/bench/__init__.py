"""Benchmark harness: workloads, timing, and table rendering.

Counterpart of ``huffman_tpu.bench``: the reference's google-benchmark
harness (codec/huffman_benchmark.cpp) and its offline table generator
(make_table.py), timing the port on its device.
"""

from .harness import run_suite, sustained_seconds
from .table import render_markdown
from .workloads import WORKLOADS, make_workload

__all__ = [
    "WORKLOADS",
    "make_workload",
    "run_suite",
    "sustained_seconds",
    "render_markdown",
]
