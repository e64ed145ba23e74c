"""Host spans inside the codec, off by default.

A span names a stretch of host time in the program: ``serialize`` and its
stages, ``deserialize`` and its stages, the device API's methods, the
batched statics copy, the pinned uploads, a wait on a copy's event, and
each C launch of a kernel (``launch.<kernel>``).  While the recorder is
off (``ON`` false, the default) a span site tests that one flag: `span`
returns a shared context that does nothing, and the per-launch site in
``ops/_cuda.py`` tests ``tracing.ON`` inline.  Nothing then calls into
``torch`` or reads a clock.

`enable` turns it on.  Each span then does two things:

* it opens ``torch.profiler.record_function("htp.<name>")``, so that
  under a profiler (``utils.debug.profile_trace``, or any other) the span
  is a host range on the same clock as the device's operations;
* it adds its ``time.perf_counter_ns`` duration to a table keyed by
  (the enclosing span's name or None, its name): the count, the total
  and the time inside its own child spans.  Self time is total minus
  child.  `snapshot` returns the table and `reset` clears it.

The recorder keeps one stack of open spans for the process: it is meant
for the thread that calls the codec, and no span site runs on another.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

#: Whether spans record.  Switched by `enable` / `disable` alone.
ON = False

#: The prefix of every span's profiler range.
PREFIX = "htp."


class Stat(NamedTuple):
    """One row of the table: a span's calls under one parent."""

    count: int
    total_ns: int
    child_ns: int

    @property
    def self_ns(self) -> int:
        return self.total_ns - self.child_ns


_table: dict[tuple[str | None, str], list[int]] = {}
_stack: list[_Span] = []


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "child_ns", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self.child_ns = 0
        _stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        _stack.pop()
        parent = _stack[-1] if _stack else None
        if parent is not None:
            parent.child_ns += dt
        row = _table.setdefault((parent.name if parent else None, self.name), [0, 0, 0])
        row[0] += 1
        row[1] += dt
        row[2] += self.child_ns
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the host span ``name`` while `ON`, and a
    shared one that does nothing otherwise."""
    return _Span(name) if ON else _OFF


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def snapshot() -> dict[tuple[str | None, str], Stat]:
    """{(parent name or None, name): `Stat`} of the spans that ended since
    the last `reset`."""
    return {key: Stat(*row) for key, row in _table.items()}


def reset() -> None:
    """Clear the table.  Spans still open record into the new one."""
    _table.clear()
