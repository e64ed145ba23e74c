"""A run of several ranks: one process a card, all on one host.

A cell whose ``chips`` is more than 1 runs as that many processes, rank r
on ``cuda:r``.  Rank 0 is the process the command started: it starts
ranks 1.. as children (the same command with ``--rank r``) with
torchrun's variables set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1, a free ``MASTER_PORT``),
and in every rank the port's ``parallel.distributed.initialize()`` brings
up the default process group from them (env://: NCCL on the cards, gloo
on the host).  Every rank runs set-up and the same
requests in the same order; rank 0 alone times, traces, checks and prints
(`harness`).

The harness's own agreement between the ranks is two collectives over
that group on the ranks' devices, and none inside a half (`Group`): at the end
of set-up rank 0 broadcasts the request count of each half, which it
draws from set-up's timed calls, and after the window the ranks' peak
device memory is reduced to the largest.

Failure: rank 0 polls its children every `POLL` seconds; a child that
exits with a code other than 0 ends the run at once, and a run whose
ranks have not all ended `LIMIT` seconds after rank 0's start is ended
then.  Rank 0 then kills every child's process group, waits for each, and
exits 1 with no result; a rank 0 that raises does the same.  A child
whose rank 0 is gone exits.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time

#: Seconds from rank 0's start within which a run of several ranks ends,
#: or is ended with no result.
LIMIT = 300.0
#: Seconds between two looks at the other ranks.
POLL = 0.2
RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's rank among ``world``, and the harness's collectives
    on its ``device`` (the default group may have no backend for another)."""

    rank: int = 0
    world: int = 1
    device: object = None  # a torch.device; None is the host

    def broadcast(self, values: list[int]) -> list[int]:
        """Rank 0's ``values`` on every rank."""
        if self.world == 1:
            return values
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return t.tolist()

    def largest(self, value: int) -> int:
        """The largest of every rank's ``value``; the run's last collective,
        after which the process group is taken down."""
        if self.world == 1:
            return value
        import torch
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        value = int(t.item())
        dist.destroy_process_group()
        return value


ONE = Group()


def join(device: str):
    """This rank's `Group` and torch device from torchrun's variables:
    ``cuda:r`` for rank r on a card (made the current device), the host
    otherwise."""
    import torch
    from huffman_tpu_torch.parallel import distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    distributed.initialize()
    return Group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev), dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launcher:
    """Rank 0's side: starts ranks 1.. and ends the run where one fails.
    Made before rank 0 imports torch, so that the ranks' imports overlap."""

    def __init__(self, argv: list[str], world: int, t0: float):
        self.argv, self.world = argv, world
        self.deadline = t0 + LIMIT
        self.procs: list[subprocess.Popen] = []
        self._lock = threading.Lock()
        self._done = threading.Event()

    def start(self) -> None:
        common = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
                  "WORLD_SIZE": str(self.world), "LOCAL_WORLD_SIZE": str(self.world)}
        os.environ.update(common, RANK="0", LOCAL_RANK="0")
        for r in range(1, self.world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
            # A child's standard output goes to standard error: the result
            # is rank 0's line alone.
            self.procs.append(subprocess.Popen(
                [sys.executable, RUN, *self.argv, "--rank", str(r)], env=env,
                stdin=subprocess.DEVNULL, stdout=sys.stderr, start_new_session=True,
            ))
        threading.Thread(target=self._watch, name="hbench-ranks", daemon=True).start()

    def _watch(self) -> None:
        while not self._done.wait(POLL):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    self.fail(f"rank {r} exited with code {code}")
            if time.perf_counter() > self.deadline:
                self.fail(f"the ranks did not end within {LIMIT:.0f} s")

    def finish(self) -> None:
        """Wait for every child to exit with 0, within the limit."""
        for r, p in enumerate(self.procs, 1):
            try:
                code = p.wait(timeout=max(self.deadline - time.perf_counter(), 0.0))
            except subprocess.TimeoutExpired:
                self.fail(f"rank {r} did not end within {LIMIT:.0f} s")
            if code != 0:
                self.fail(f"rank {r} exited with code {code}")
        self._done.set()

    def kill(self) -> None:
        """Kill every child's process group and wait for each child."""
        with self._lock:
            self._done.set()
            for p in self.procs:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            for p in self.procs:
                p.wait()

    def fail(self, why: str) -> None:
        print(f"{why}: every rank is stopped, and the run gives no result",
              file=sys.stderr, flush=True)
        self.kill()
        os._exit(1)


def watch_parent(t0: float) -> None:
    """In a child: exit when rank 0 is gone, or past the limit."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent and time.perf_counter() < t0 + LIMIT:
            time.sleep(POLL)
        os._exit(1)

    threading.Thread(target=watch, name="hbench-parent", daemon=True).start()
