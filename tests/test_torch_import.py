"""huffman_tpu_torch stands alone: it imports neither jax nor huffman_tpu,
its kernel modules import without nvcc, a CUDA tensor never falls back
to the plain versions, and chip_smoke.py refuses to run without a card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from huffman_tpu.bench import workloads as jax_workloads
from huffman_tpu_torch import TorchCodec
from huffman_tpu_torch.bench import fused, workloads
from huffman_tpu_torch.ops import _cuda, decode_bits, encode, hist_variants, lookup, table_build
from huffman_tpu_torch.parallel import sharded

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120,
    )


def test_import_leaves_out_jax_and_huffman_tpu():
    r = _run(
        "import sys, huffman_tpu_torch, chip_smoke, bench_torch\n"
        "import huffman_tpu_torch.convert, huffman_tpu_torch.container\n"
        "import huffman_tpu_torch.bench.harness, huffman_tpu_torch.bench.table\n"
        "import huffman_tpu_torch.bench.fused\n"
        "import huffman_tpu_torch.ops.hist_variants\n"
        "import huffman_tpu_torch.tools.hist_experiments, huffman_tpu_torch.tools.run_benchmarks\n"
        "import huffman_tpu_torch.cli, huffman_tpu_torch.coding, huffman_tpu_torch.format\n"
        "import huffman_tpu_torch.golden, huffman_tpu_torch.ops.tables\n"
        "import huffman_tpu_torch.models.torch_ref_codec, huffman_tpu_torch.tools.kernel_ab\n"
        "import huffman_tpu_torch.parallel, huffman_tpu_torch.parallel.sharded\n"
        "import huffman_tpu_torch.parallel.distributed, huffman_tpu_torch.tools.bench_sharded\n"
        "import huffman_tpu_torch.staging, huffman_tpu_torch.utils.debug\n"
        "import huffman_tpu_torch.tools.bench_streaming, huffman_tpu_torch.tools.bench_small\n"
        "import huffman_tpu_torch.tools.probe_k, huffman_tpu_torch.tools.probe_encode_stages\n"
        "import huffman_tpu_torch.tools.probe_batched\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing the port started a process group'\n"
        "assert not torch.cuda.is_initialized(), 'importing the port initialized CUDA'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'huffman_tpu')]\n"
        "print('BAD', bad)\n"
        "assert not bad\n"
    )
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("seed", [0, 3])
def test_biased_u8_matches_jax_package(seed):
    np.testing.assert_array_equal(
        workloads.biased_u8(1 << 16, seed), jax_workloads.biased_u8(1 << 16, seed)
    )


@pytest.mark.parametrize("name", list(workloads.WORKLOADS))
def test_workloads_match_jax_package(name):
    assert workloads.make_workload(name, 4096) == jax_workloads.make_workload(name, 4096)


class _FakeCudaTensor(torch.Tensor):
    """Stands in for a CUDA tensor on a machine without CUDA: zeros in CPU
    memory that report themselves on a card, so that a wrapper gets as far
    as its `_cuda.launch`."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.zeros(shape, dtype=dtype).as_subclass(cls)

    @property
    def is_cuda(self):
        return True


def _no_nvcc():
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


CUDA_CALLS = {
    "table_hist": lambda: lookup.table_hist(_FakeCudaTensor((4096,), torch.uint8), 32),
    "build_coding": lambda: table_build.build_coding_device(
        _FakeCudaTensor((256,), torch.int32)
    ),
    "encode_lanes": lambda: encode.encode_lanes(
        _FakeCudaTensor((64,), torch.uint8), _FakeCudaTensor((256,), torch.int32), 8, 8, 5
    ),
    "decode_lanes": lambda: decode_bits.decode_lanes(
        _FakeCudaTensor((5, 8), torch.int32),
        _FakeCudaTensor((17,), torch.int32),
        _FakeCudaTensor((16,), torch.int32),
        _FakeCudaTensor((256,), torch.int32),
        8,
    ),
    "encode_lanes_rows": lambda: encode.encode_lanes(
        _FakeCudaTensor((64,), torch.uint8), _FakeCudaTensor((256,), torch.int32), 8, 8, 5,
        lane_rows=_FakeCudaTensor((8,), torch.int32),
    ),
    "histogram256_batch": lambda: lookup.histogram256_batch(
        _FakeCudaTensor((3, 4096), torch.uint8)
    ),
    "build_coding_batch": lambda: table_build.build_coding_device_batch(
        _FakeCudaTensor((3, 256), torch.int32)
    ),
    "encode_lanes_batch": lambda: encode.encode_lanes_batch(
        _FakeCudaTensor((3, 64), torch.uint8), _FakeCudaTensor((3, 256), torch.int32), 8, 8, 5
    ),
    "decode_lanes_batch": lambda: decode_bits.decode_lanes_batch(
        _FakeCudaTensor((3, 5, 8), torch.int32),
        _FakeCudaTensor((3, 17), torch.int32),
        _FakeCudaTensor((3, 16), torch.int32),
        _FakeCudaTensor((3, 256), torch.int32),
        8,
        4,
    ),
    "encode_batch": lambda: TorchCodec(k=8, device="cuda").encode_batch(
        _FakeCudaTensor((3, 64), torch.uint8)
    ),
    "decode_batch": lambda: TorchCodec(k=8, device="cuda").decode_batch(
        _FakeCudaTensor((3, 5, 8), torch.int32),
        _FakeCudaTensor((3, 8), torch.int32),
        {
            "e_bound": _FakeCudaTensor((3, 17), torch.int32),
            "g_rank": _FakeCudaTensor((3, 16), torch.int32),
            "sorted_syms": _FakeCudaTensor((3, 256), torch.int32),
        },
        64,
        statics=(1, 4, 0),
    ),
    "sharded_roundtrip": lambda: sharded.sharded_roundtrip(
        _FakeCudaTensor((3, 64), torch.uint8), mesh=sharded.LocalMesh(), k=8, s=8, w32=5
    ),
    "sharded_decode": lambda: sharded.sharded_decode(
        _FakeCudaTensor((3, 5, 8), torch.int32),
        _FakeCudaTensor((3, 17), torch.int32),
        _FakeCudaTensor((3, 16), torch.int32),
        _FakeCudaTensor((3, 256), torch.int32),
        mesh=sharded.LocalMesh(), k=8, s=8, w=4,
    ),
    "hist_variant": lambda: hist_variants.hist_variant(
        _FakeCudaTensor((1 << 19,), torch.uint8), "base"
    ),
    "carry": lambda: fused.carry(
        _FakeCudaTensor((64,), torch.uint8), _FakeCudaTensor((), torch.float32)
    ),
    "fold": lambda: fused.fold(
        fused.accumulator("cpu").as_subclass(_FakeCudaTensor),
        _FakeCudaTensor((18, 64), torch.int32),
        _FakeCudaTensor((64,), torch.uint8),
    ),
}


@pytest.mark.parametrize("name", list(CUDA_CALLS))
def test_cuda_tensor_without_kernels_raises(name, monkeypatch):
    """No kernel library: the wrapper raises rather than running the
    plain version on a CUDA tensor (the build, in `_cuda.launch`)."""
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_nvcc", _no_nvcc)
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        CUDA_CALLS[name]()
    assert _cuda.LAUNCHES == before


def test_cuda_wrapper_checks_dtype_before_building():
    with pytest.raises(ValueError, match="int32"):
        table_build.build_coding_device(_FakeCudaTensor((256,), torch.int64))


def test_other_devices_raise():
    x = torch.empty(1024, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lookup.table_hist(x, 1)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_CUDA_ROOT", str(tmp_path))
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.load()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
