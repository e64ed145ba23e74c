"""The port's process-group initialization (`parallel.distributed`), the
six cases of tests/test_distributed.py with
``torch.distributed.init_process_group`` monkeypatched, plus the
``torchrun`` environment with no kwargs (env://) and `pod_mesh`.
"""

import pytest
import torch.distributed as dist

from huffman_tpu_torch.parallel import distributed
from huffman_tpu_torch.parallel.sharded import LocalMesh

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No state, no process group, no launcher in the environment."""
    monkeypatch.setattr(distributed, "_state", None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)


def _recorder(monkeypatch, fail=None):
    calls = []

    def fake_init(**kwargs):
        calls.append(kwargs)
        if fail is not None:
            raise fail

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    return calls


def test_initialize_single_process_is_noop_and_idempotent(monkeypatch):
    calls = _recorder(monkeypatch)
    distributed.initialize()  # no launcher: fine
    assert distributed._state == "noop"
    distributed.initialize()  # second no-kwargs call must not re-enter
    assert calls == []


def test_initialize_explicit_config_failure_propagates(monkeypatch):
    _recorder(monkeypatch, ValueError("bad init_method"))
    with pytest.raises(ValueError):
        distributed.initialize(backend="gloo", init_method="tcp://10.0.0.1:1234",
                               world_size=2, rank=0)
    assert distributed._state is None


def test_initialize_runtime_failure_propagates(monkeypatch):
    """Under torchrun a failing rendezvous raises; it is no single-process run."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    _recorder(monkeypatch, RuntimeError("rendezvous timed out"))
    with pytest.raises(RuntimeError):
        distributed.initialize()
    assert distributed._state is None


def test_initialize_double_init_elsewhere_is_ok(monkeypatch):
    calls = _recorder(monkeypatch)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    distributed.initialize(backend="gloo")  # a group that is up counts
    assert distributed._state == "initialized"
    assert calls == []


def test_initialize_success_path(monkeypatch):
    calls = _recorder(monkeypatch)
    distributed.initialize(backend="gloo", init_method="tcp://10.0.0.1:1234",
                           world_size=2, rank=1)
    assert distributed._state == "initialized"
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 2, "rank": 1}]
    distributed.initialize(backend="gloo")  # once initialized, a no-op
    assert len(calls) == 1


def test_noop_does_not_latch_explicit_init(monkeypatch):
    """A no-kwargs call that found no launcher must not swallow a LATER
    explicit initialize: that would demote a multi-rank job to one
    process."""
    calls = _recorder(monkeypatch)
    distributed.initialize()
    assert distributed._state == "noop"
    distributed.initialize(backend="gloo", init_method="file:///tmp/store", world_size=2, rank=0)
    assert distributed._state == "initialized"
    assert len(calls) == 1


@pytest.mark.parametrize("var", ["RANK", "WORLD_SIZE", "MASTER_ADDR"])
def test_torchrun_environment_takes_env(monkeypatch, var):
    monkeypatch.setenv(var, "0" if var != "MASTER_ADDR" else "localhost")
    calls = _recorder(monkeypatch)
    distributed.initialize()
    assert calls == [{"init_method": "env://"}]
    assert distributed._state == "initialized"


def test_pod_mesh_without_a_group_is_one_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert isinstance(distributed.pod_mesh(stream_per_host=True), LocalMesh)
    assert isinstance(distributed.pod_mesh(), LocalMesh)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not divide"):
        distributed.pod_mesh(stream_per_host=True)
