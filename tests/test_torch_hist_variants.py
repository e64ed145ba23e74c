"""ops/hist_variants.py against the TPU histogram race's kernel.

The same numpy inputs go through ``tools/hist_experiments.py:hist_variant``
(the Pallas kernel, run in interpret mode as the JAX package's own CPU
tests run its kernels), the port's `hist_variant` on a CPU tensor (its
plain version) and ``huffman_tpu.ops.lookup.histogram256``.  Tolerance:
exact (counts).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from huffman_tpu.ops import lookup as jlookup
from huffman_tpu_torch.bench import workloads
from huffman_tpu_torch.ops import _cuda, hist_variants

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_hist_experiments", os.path.join(REPO, "tools", "hist_experiments.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()

INPUTS = {
    "biased 2^19": lambda: workloads.biased_u8(1 << 19, 1),
    "uniform 2^20": lambda: np.random.default_rng(2).integers(0, 256, 1 << 20, dtype=np.uint8),
    "constant 2^19": lambda: np.full(1 << 19, 0x5A, np.uint8),
    "all 0xFF 2^19": lambda: np.full(1 << 19, 0xFF, np.uint8),
}


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("variant", list(hist_variants.VARIANTS))
def test_hist_variant_matches_jax(variant, name):
    x = INPUTS[name]()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JAX_TOOL.hist_variant(jnp.asarray(x), variant))
    got = hist_variants.hist_variant(torch.from_numpy(x), variant)
    assert got.dtype == torch.int32 and tuple(got.shape) == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlookup.histogram256(jnp.asarray(x))))


@pytest.mark.parametrize("mma", hist_variants.MMA_TYPES)
def test_mma_types_count_alike(mma):
    x = np.random.default_rng(3).integers(0, 256, 1 << 19, dtype=np.uint8)
    got = hist_variants.hist_variant(torch.from_numpy(x), mma)
    np.testing.assert_array_equal(got.numpy(), np.bincount(x, minlength=256))


def test_variant_map():
    assert {v: hist_variants.mma_type(v) for v in hist_variants.VARIANTS} == {
        "base": "bf16", "bf16cmp": "bf16", "wide": "bf16", "f32cmp": "tf32", "i8dot": "s8",
    }
    assert all(hist_variants.mma_type(m) == m for m in hist_variants.MMA_TYPES)
    assert hist_variants.CHUNK == JAX_TOOL.CHUNK


@pytest.mark.parametrize("n", [0, (1 << 19) - 1, (1 << 19) + 64, 3 << 18])
def test_length_off_the_chunk_grid_raises(n):
    with pytest.raises(ValueError, match="multiple"):
        hist_variants.hist_variant(torch.zeros(n, dtype=torch.uint8), "base")


@pytest.mark.parametrize("variant", ["fp8", "Base", ""])
def test_unknown_variant_raises(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.uint8), variant)


def test_wrong_dtype_raises():
    with pytest.raises(ValueError, match="uint8"):
        hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.int32), "i8dot")


class _FakeCudaTensor:
    """Stands in for a CUDA tensor on a machine without CUDA."""

    is_cuda = True
    device = torch.device("cuda")
    dtype = torch.uint8

    def __init__(self, n):
        self.shape = (n,)

    def dim(self):
        return 1

    def is_contiguous(self):
        return True


def test_cuda_tensor_takes_the_kernel(monkeypatch):
    """A CUDA tensor goes to the kernel (here: its build, which raises
    without nvcc), never to the plain version."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(hist_variants, "hist_variant_plain", plain)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        hist_variants.hist_variant(_FakeCudaTensor(1 << 19), "i8dot")
    assert _cuda.LAUNCHES == before


def test_cpu_tensor_launches_nothing():
    before = dict(_cuda.LAUNCHES)
    hist_variants.hist_variant(torch.zeros(1 << 19, dtype=torch.uint8), "wide")
    assert _cuda.LAUNCHES == before
