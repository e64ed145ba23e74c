"""The port's debug helpers (``huffman_tpu_torch.debug``) beside
``huffman_tpu.utils.debug``: dlog's gating on the verbosity, assert_vec_eq's
messages on the same arrays, dprint silent below its level, and
profile_trace's trace file, on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from huffman_tpu.utils import debug as jdebug
from huffman_tpu_torch import debug


@pytest.mark.parametrize("vlog,level,shown", [(0, 1, False), (2, 1, True), (2, 2, True), (2, 3, False)])
def test_dlog_prints_at_or_below_the_verbosity(vlog, level, shown, monkeypatch, capsys):
    monkeypatch.setattr(debug, "VLOG", vlog)
    debug.dlog(level, "block", 3)
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err == (f"[huffman_tpu_torch:{level}] block 3\n" if shown else "")


CASES = {
    "equal": (np.arange(6).reshape(2, 3), np.arange(6).reshape(2, 3)),
    "values": (np.arange(12).reshape(3, 4), np.where(np.arange(12) % 5 == 1, 0, np.arange(12)).reshape(3, 4)),
    "shapes": (np.arange(6), np.arange(6).reshape(2, 3)),
}


def _message(check, a, b, msg):
    try:
        check(a, b, msg)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("msg", ["", "lane words"])
def test_assert_vec_eq_message_equals_jax(case, msg):
    a, b = CASES[case]
    want = _message(jdebug.assert_vec_eq, a, b, msg)
    assert (want is None) == (case == "equal")
    assert _message(debug.assert_vec_eq, a, b, msg) == want
    assert _message(debug.assert_vec_eq, torch.from_numpy(a), torch.from_numpy(b), msg) == want


def test_dprint_copies_nothing_below_its_level(monkeypatch, capsys):
    monkeypatch.setattr(debug, "VLOG", 1)
    # A meta tensor cannot be copied to the host: any copy would raise.
    debug.dprint(2, "x={x}", x=torch.empty(3, device="meta"))
    assert capsys.readouterr().out == ""
    debug.dprint(1, "x={x} n={n}", x=torch.tensor([1, 2, 3]), n=7)
    assert capsys.readouterr().out == "x=[1 2 3] n=7\n"


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with debug.profile_trace(str(tmp_path / "trace"), device="cpu") as path:
        torch.arange(4096).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
