"""Run one cell of the benchmark of ``huffman_tpu_torch`` once.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``.  Prints the result as one JSON line, the last of standard
output, and each number that decides ``correct`` beside its limit as the
last lines of standard error.  Exits 1, printing no result, where there
is no card or fewer than the cell asks for, or where the program under
test is not in the checkout; 3 where a module of JAX or of the JAX
package was loaded.  Set-up is timed from the first line of this file.

A cell of one chip runs in this process.  A cell of ``chips`` > 1 runs
one process a card (`ranks`): this one is rank 0, and starts the others
as ``... --rank r``; any rank that fails, or a run that passes
``ranks.LIMIT``, ends every rank and exits 1 with no result.
``--device cpu`` runs the cell on the host, with the program's plain
versions: a rehearsal whose numbers are not the card's.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hbench import ranks

    chips = next((w["chips"] for w in _workloads() if w["name"] == args.workload), 1)
    if args.rank:
        ranks.watch_parent(T0)
    # The other ranks start first, so that their imports overlap this one's.
    launcher = ranks.Launcher(argv, chips, T0) if chips > 1 and not args.rank else None
    try:
        if launcher:
            launcher.start()
        code = _run(args, chips, launcher)
    except BaseException:
        if launcher:
            launcher.kill()
        raise
    if code and launcher:
        launcher.kill()
    return code


def _run(args, chips: int, launcher) -> int:
    from hbench import harness, ranks, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
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
    run = functools.partial(harness.run_cell, cell, args.seed, args.seconds, bool(args.trace),
                            t0=T0)
    if chips == 1:
        line, checks = run(device=args.device)
        return harness.emit(line, checks)
    group, dev = ranks.join(args.device)
    print(f"rank {group.rank}: process group up {time.perf_counter() - T0:.3f} s after the start",
          file=sys.stderr)
    line, checks = run(device=dev, group=group)
    if group.rank:
        bad = harness.forbidden_modules()
        if bad:
            print(f"rank {group.rank}: forbidden modules loaded: {bad}", file=sys.stderr)
            return 3
        return 0
    launcher.finish()
    return harness.emit(line, checks)


def _workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)["workloads"]


if __name__ == "__main__":
    sys.exit(main())
