"""Run one cell of the benchmark of ``huffman_tpu_torch`` once, on one card.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``.  Prints the result as one JSON line, the last of standard
output, and each number that decides ``correct`` beside its limit as the
last lines of standard error.  Exits 1, printing no result, where there
is no card or fewer than the cell asks for, or where the program under
test is not in the checkout; 3 where a module of JAX or of the JAX
package was loaded.  Set-up is timed from the first line of this file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    chips = next(w["chips"] for w in _workloads() if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA device, or fewer than the {chips} the cell asks for", file=sys.stderr)
        return 1
    try:
        import huffman_tpu_torch
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(huffman_tpu_torch.__file__))) != ROOT:
        print(f"huffman_tpu_torch comes from {huffman_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 1
    line, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    return harness.emit(line, checks)


def _workloads():
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)["workloads"]


if __name__ == "__main__":
    sys.exit(main())
