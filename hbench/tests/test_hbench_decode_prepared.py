"""The reader of ``api.decode_prepared_share``: the program's count of
``decode_device`` calls on a card by path, as a share, and the cell that
lists it."""

from __future__ import annotations

import pytest

from hbench import spec

NAME = "api.decode_prepared_share"


@pytest.fixture
def paths(monkeypatch):
    """The program's counter, zeroed for the test."""
    from huffman_tpu_torch.ops import _cuda

    for path in ("prepared", "checked"):
        monkeypatch.setitem(_cuda.DECODE_PATHS, path, 0)
    return _cuda.DECODE_PATHS


@pytest.mark.parametrize(
    "prepared, checked, share", [(0, 0, None), (7, 0, 1.0), (3, 1, 0.75), (0, 2, 0.0)]
)
def test_share_of_prepared_calls(prepared, checked, share, paths):
    paths.update(prepared=prepared, checked=checked)
    assert spec.reader(NAME)(None) == share


def test_none_where_the_program_keeps_no_counter(monkeypatch):
    from huffman_tpu_torch.ops import _cuda

    monkeypatch.delattr(_cuda, "DECODE_PATHS")
    assert spec.reader(NAME)(None) is None


@pytest.mark.parametrize(
    "cell", ["block16m.device", "pages100k.b160", "block16m.bytes", "pages100k.b16",
             "sharded.4chip"]
)
def test_listed_in_block16m_device_alone(cell):
    listed = NAME in {m["name"] for m in spec.load_cell(cell).per_layer}
    assert listed == (cell == "block16m.device")
    metric = next(m for m in spec.load_cell("block16m.device").per_layer if m["name"] == NAME)
    assert (metric["unit"], metric["better"], metric["source"], metric["layer"],
            metric["moves"]) == ("share", "higher", "program_counter", "device API",
                                 "decompress_GiB_s")
