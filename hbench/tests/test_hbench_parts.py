"""A configuration made of new files alone: a profile, an entry point and
a source that the harness finds by name, run end to end by the command
on the CPU with no file of the harness edited; and the error a name with
no file gives."""

from __future__ import annotations

import hashlib
import json
import os

import pytest
from conftest import PART_CELLS, ROOT, make_root, run_command

from hbench import spec


def _hashes(root: str) -> dict[str, str]:
    """sha256 of every file of the committed harness (its tests and corpus
    aside), as it lies under ``root``."""
    out = {}
    base = os.path.join(ROOT, "hbench")
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("tests", "data", "__pycache__")]
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), base)
            with open(os.path.join(root, "hbench", rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_cell_of_new_files_runs_through_the_command(tmp_path):
    root = make_root(tmp_path, PART_CELLS, program=True)
    before = _hashes(root)
    assert before == _hashes(ROOT)
    for kind, name in (("profiles", "zlib"), ("entries", "zbytes"), ("sources", "ramp")):
        assert f"{kind}/{name}.py" not in before
        assert os.path.exists(os.path.join(root, "hbench", kind, f"{name}.py"))
    out = run_command(root, "ramp8k.zramp")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"ratio", "setup_s"}
    assert line["metrics"]["ratio"]["value"] > 1  # 16 symbols: 4 bits a byte
    assert line["checks"] == {n: {"value": 0, "limit": 0}
                              for n in ("failed", "blob_diff", "decode_diff")}
    assert line["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1] == "check decode_diff 0 limit 0"
    assert _hashes(root) == before


@pytest.mark.parametrize("kind,key,where", [
    ("profiles", "profile", "config"), ("entries", "api", "traffic"), ("sources", "source", "traffic"),
])
def test_unknown_part_names_the_missing_file(tmp_path, kind, key, where):
    root = make_root(tmp_path, PART_CELLS)
    path = os.path.join(root, "hbench", "configs" if where == "config" else "traffic",
                        "ramp8k.json" if where == "config" else "ramp8k_zramp.json")
    with open(path) as f:
        data = json.load(f)
    data[key] = "nosuch"
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(FileNotFoundError) as e:
        spec.load_cell("ramp8k.zramp", root)
    assert os.path.join(root, "hbench", kind, "nosuch.py") in str(e.value)


def test_parts_of_the_four_cells_are_found_by_name():
    for cell in ("block16m.device", "pages100k.b160", "block16m.bytes", "pages100k.b16"):
        c = spec.load_cell(cell)
        assert c.profile.__file__ == os.path.join(ROOT, "hbench", "profiles", "tpu.py")
        assert c.entry.__file__ == os.path.join(ROOT, "hbench", "entries", f"{c.traffic['api']}.py")
        assert callable(c.profile.make_codec) and callable(c.profile.Tally)
        assert c.entry.Api.returns_blobs is (c.traffic["api"] == "bytes")
