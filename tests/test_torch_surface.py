"""The port's package surface beside ``huffman_tpu``'s: a counterpart of
every name in ``huffman_tpu.__all__`` (TpuCodec -> TorchCodec, JaxCodec
-> TorchRefCodec), the modules it exports, the codec classes it loads
only when asked for, and ``native.available`` / ``native.histogram``
equal to the JAX package's on the corpus.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import huffman_tpu
import huffman_tpu_torch
from corpus import standard_cases
from huffman_tpu import native as jnative
from huffman_tpu_torch import native

COUNTERPART = {"TpuCodec": "TorchCodec", "JaxCodec": "TorchRefCodec"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", huffman_tpu.__all__)
def test_every_jax_name_has_a_counterpart(name):
    ours = COUNTERPART.get(name, name)
    assert ours in huffman_tpu_torch.__all__
    assert getattr(huffman_tpu_torch, ours) is not None


def test_constants_equal_jax():
    for name in ("MAX_CODE_LEN", "NUM_SYMBOLS", "STREAM_SLOP"):
        assert getattr(huffman_tpu_torch, name) == getattr(huffman_tpu, name)


def test_exported_modules():
    from huffman_tpu_torch import container, debug

    assert huffman_tpu_torch.container is container and huffman_tpu_torch.native is native
    assert huffman_tpu_torch.debug is debug
    assert container.PIPELINE_DEPTH == huffman_tpu.container.PIPELINE_DEPTH


def test_codec_classes_load_when_asked_for():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, huffman_tpu_torch as h\n"
         "assert 'huffman_tpu_torch.parallel' not in sys.modules\n"
         "from huffman_tpu_torch.parallel import ShardedCodec\n"
         "from huffman_tpu_torch.native import NativeCodec\n"
         "assert h.ShardedCodec is ShardedCodec and h.NativeCodec is NativeCodec\n"
         "try:\n    h.JaxCodec\nexcept AttributeError:\n    print('OK')\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stdout + r.stderr


def test_native_available_equals_jax():
    assert native.available() == jnative.available()


@pytest.mark.parametrize("name,raw", standard_cases(), ids=[c[0] for c in standard_cases()])
def test_native_histogram_equals_jax(name, raw):
    want = jnative.histogram(raw)
    got = native.histogram(raw)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.histogram(np.frombuffer(raw, np.uint8)), want)


def test_native_histogram_without_the_library(monkeypatch):
    raw = standard_cases()[3][1]
    monkeypatch.setattr(native, "_lib_or_none", lambda: None)
    assert not native.available()
    np.testing.assert_array_equal(native.histogram(raw), jnative.histogram(raw))
