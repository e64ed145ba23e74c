"""A cell of several chips: one process a rank, started by rank 0, over
the default process group (gloo on the CPU), every rank running the same
requests; and the end of a run in which a rank fails."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import PART_CELLS, SEED, make_root, run_command

from hbench import ranks

BALLAST = 1 << 30


def _root(tmp_path, **changes) -> tuple[str, str]:
    record = tmp_path / "record"
    record.mkdir()
    cells = {name: (cfg, tr, dict(changes, record=str(record)), *chips)
             for name, (cfg, tr, _, *chips) in PART_CELLS.items()}
    return make_root(tmp_path, cells, program=True), str(record)


def _left(root: str) -> list[int]:
    """Live processes that run the copy's ``hbench/run.py``."""
    run, left = os.path.join(root, "hbench", "run.py"), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:  # ended while we looked
            continue
        if run in cmd and state not in ("Z", "X"):
            left.append(int(pid))
    return left


def test_two_ranks_make_the_same_requests_and_print_one_line(tmp_path):
    root, record = _root(tmp_path, ballast_rank=1, ballast_bytes=BALLAST)
    out = run_command(root, "ramp8k.zramp2", seconds=2.0)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and out.stdout.strip().splitlines()[-1].startswith("{")
    line = lines[0]
    assert line["correct"] is True and line["attempted"] > 2
    assert line["device"]["count"] == 2
    calls = [json.load(open(os.path.join(record, f"calls.{r}.json"))) for r in (0, 1)]
    assert calls[0]["compress"] == calls[1]["compress"] > 0
    assert calls[0]["decompress"] == calls[1]["decompress"] > 0
    # Rank 1 holds the ballast: the line's peak is its, not rank 0's.
    assert calls[0]["rss"] < BALLAST <= line["device"]["memory_peak_bytes"]
    assert out.stderr.strip().splitlines()[-1] == "check decode_diff 0 limit 0"
    assert _left(root) == []


def test_one_chip_starts_no_process_and_no_group(tmp_path):
    root, _ = _root(tmp_path)
    code = (
        "import json, runpy, subprocess, sys\n"
        "started = []\n"
        "class Recording(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        started.append([str(x) for x in args])\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Recording\n"
        "sys.argv = ['hbench/run.py', '--workload', 'ramp8k.zramp', '--seed', '%d',\n"
        "            '--seconds', '1', '--trace', '0', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_path('hbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "import torch.distributed as dist\n"
        "print(json.dumps({'rc': rc, 'runs': [a for a in started if any('run.py' in x for x in a)],\n"
        "                  'group': dist.is_initialized()}), file=sys.stderr)\n"
    ) % SEED
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=240)
    got = json.loads(out.stderr.strip().splitlines()[-1])
    assert got == {"rc": 0, "runs": [], "group": False}
    assert json.loads(out.stdout.strip().splitlines()[-1])["device"]["count"] == 1


@pytest.mark.parametrize("fail_rank,stall_rank", [(1, None), (0, None), (0, 1)])
def test_rank_that_raises_in_setup_ends_every_rank(tmp_path, fail_rank, stall_rank):
    root, _ = _root(tmp_path, fail_rank=fail_rank, stall_rank=stall_rank)
    t = time.monotonic()
    out = run_command(root, "ramp8k.zramp2", seconds=2.0, timeout=ranks.LIMIT + 60)
    took = time.monotonic() - t
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert took < ranks.LIMIT
    assert f"rank {fail_rank} fails in set-up" in out.stderr
    assert _left(root) == []


@pytest.mark.card
@pytest.mark.parametrize("chips", [1, 2])
def test_ranks_on_the_card(card, tmp_path, chips):
    import torch

    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards, one rank a card")
    root, record = _root(tmp_path)
    cell = "ramp8k.zramp" if chips == 1 else "ramp8k.zramp2"
    out = subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", cell, "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=ranks.LIMIT + 60,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == chips and line["device"]["memory_peak_bytes"] > 0
    calls = [json.load(open(os.path.join(record, f"calls.{r}.json"))) for r in range(chips)]
    assert all(c["compress"] == calls[0]["compress"] > 0 for c in calls)
