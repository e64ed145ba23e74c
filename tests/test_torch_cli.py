"""The port's CLI in-process on temp files, beside ``huffman_tpu``'s (on
the model of tests/test_cli.py): the same argv writes the same ``ref``
and ``native`` files, each package reads the other's files, the ``tpu``
profile's container round-trips and reads in both, and a corrupt
container exits non-zero; without the host library the ``native``
profile falls back to the numpy oracle in both packages alike.  The port
runs with ``--device cpu``.
"""

import numpy as np
import pytest

from huffman_tpu import cli as jcli
from huffman_tpu import native as jnative
from huffman_tpu_torch import TorchCodec, cli, native

CPU = ["--device", "cpu"]


@pytest.fixture
def sample_file(tmp_path):
    rng = np.random.default_rng(5)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    data = rng.choice(256, size=200_000, p=p).astype(np.uint8).tobytes()
    f = tmp_path / "in.bin"
    f.write_bytes(data)
    return f, data


# 200,000 bytes at K = 64 take the ref profile's device path (n <= 4096 K),
# at K = 32 its host path.
@pytest.mark.parametrize("profile,k", [("ref", 64), ("ref", 32), ("native", 32), ("native", 16)])
def test_same_argv_same_files_and_cross_decode(profile, k, sample_file, tmp_path, capsys):
    f, data = sample_file
    args = ["--profile", profile, "--k", str(k)]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    cli.main(["compress", str(f), str(ours), *args, *CPU])
    jcli.main(["compress", str(f), str(theirs), *args])
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size < len(data)
    back = tmp_path / "back"
    cli.main(["decompress", str(theirs), str(back), *args, *CPU])
    assert back.read_bytes() == data
    jcli.main(["decompress", str(ours), str(back), *args])
    assert back.read_bytes() == data
    out = capsys.readouterr().out
    assert "bytes" in out and "ratio" in out


def test_native_profile_reads_a_bare_ref_blob(sample_file, tmp_path):
    f, data = sample_file
    blob = tmp_path / "ref"
    cli.main(["compress", str(f), str(blob), "--profile", "ref", "--k", "64", *CPU])
    back = tmp_path / "back"
    cli.main(["decompress", str(blob), str(back), "--profile", "native", "--k", "64", *CPU])
    assert back.read_bytes() == data


def test_tpu_profile_roundtrip_and_container_in_both(sample_file, tmp_path, capsys):
    """64 KiB blocks: several blocks and a short tail block."""
    f, data = sample_file
    block = ["--block", str(64 << 10)]
    cli.main(["roundtrip", str(f), *block, *CPU])
    assert "roundtrip OK" in capsys.readouterr().out
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    cli.main(["compress", str(f), str(ours), *block, *CPU])
    jcli.main(["compress", str(f), str(theirs), *block])
    back = tmp_path / "back"
    jcli.main(["decompress", str(ours), str(back)])
    assert back.read_bytes() == data
    cli.main(["decompress", str(theirs), str(back), *CPU])
    assert back.read_bytes() == data


@pytest.mark.parametrize("profile", ["ref", "native"])
def test_roundtrip_ref_and_native(profile, sample_file, capsys):
    f, _ = sample_file
    cli.main(["roundtrip", str(f), "--profile", profile, "--k", "64", *CPU])
    assert "roundtrip OK" in capsys.readouterr().out


def test_corrupt_container_exits_nonzero(sample_file, tmp_path):
    """A flipped payload byte decodes without a structural error; the
    container's crc32 trailer rejects it."""
    f, _ = sample_file
    c = tmp_path / "out"
    cli.main(["compress", str(f), str(c), "--block", str(64 << 10), *CPU])
    blob = bytearray(c.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    c.write_bytes(bytes(blob))
    with pytest.raises(SystemExit) as e:
        cli.main(["decompress", str(c), str(tmp_path / "back"), *CPU])
    assert e.value.code not in (0, None)


def test_unknown_profile_rejected(sample_file, tmp_path):
    f, _ = sample_file
    with pytest.raises(SystemExit):
        cli.main(["compress", str(f), str(tmp_path / "x"), "--profile", "zstd", *CPU])


@pytest.fixture
def small_file(tmp_path):
    """20,000 biased bytes: the numpy oracle decodes a symbol at a time."""
    rng = np.random.default_rng(6)
    p = 0.8 ** np.arange(256) * 0.2
    p /= p.sum()
    data = rng.choice(256, size=20_000, p=p).astype(np.uint8).tobytes()
    f = tmp_path / "small.bin"
    f.write_bytes(data)
    return f, data


def _no_host_library(monkeypatch):
    """Both packages' host-library loaders fail, as without a toolchain."""

    def fail():
        raise RuntimeError("compiler 'g++' is not usable")

    monkeypatch.setattr(jnative, "load", lambda: None)
    monkeypatch.setattr(native, "load", fail)


def test_native_profile_without_host_library_writes_jax_file(small_file, tmp_path, monkeypatch):
    """No library: both CLIs write the same bare ref blob (not a
    container) through the oracle, and each reads the other's."""
    f, data = small_file
    args = ["--profile", "native", "--k", "32"]
    _no_host_library(monkeypatch)
    ours, theirs, back = tmp_path / "ours", tmp_path / "theirs", tmp_path / "back"
    cli.main(["compress", str(f), str(ours), *args, *CPU])
    jcli.main(["compress", str(f), str(theirs), *args])
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes()[:4] != b"HTPC"
    cli.main(["decompress", str(theirs), str(back), *args, *CPU])
    assert back.read_bytes() == data
    jcli.main(["decompress", str(ours), str(back), *args])
    assert back.read_bytes() == data


def test_native_container_reads_without_host_library(small_file, tmp_path, monkeypatch):
    """A pipeline container written with the library decodes without it."""
    f, data = small_file
    c, back = tmp_path / "c", tmp_path / "back"
    cli.main(["compress", str(f), str(c), "--profile", "native", "--block", "8192", *CPU])
    assert c.read_bytes()[:4] == b"HTPC"
    _no_host_library(monkeypatch)
    cli.main(["decompress", str(c), str(back), "--profile", "native", *CPU])
    assert back.read_bytes() == data


def test_tpu_blobs_without_host_library_are_the_same(small_file, monkeypatch):
    """The counts blob (ref codec) and the lane-bit packers fall back to
    their numpy forms with the same bytes."""
    _, data = small_file
    tc = TorchCodec(64, device="cpu")
    want = tc.compress(data)
    _no_host_library(monkeypatch)
    assert tc.compress(data) == want
    assert tc.decompress(want) == data
    assert native.decompress(native.compress(data, 8), 8, len(data)) == data
    with pytest.raises(ValueError, match="at most"):
        native.decompress(native.compress(data, 8), 8, len(data) - 1)
