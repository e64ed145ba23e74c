"""The sustained bodies' two passes around the codec: the carried 0 and
the checksum.

Counterpart: the ``d + pert`` and ``jnp.sum(o.astype(jnp.int32))`` of
the JAX harness bodies (``bench.py:172-190``,
``huffman_tpu/bench/harness.py:127-145`` and the tools' bodies), which
XLA fuses into one pass each.  PyTorch's eager ops take more: its u8 add
is slow, and its int32 sum of u8 writes a widened copy first.  So on a
CUDA tensor `carry` and `checksum` launch the hand-written kernels of
``csrc/bench_ops.cu``; `carry_plain` and `checksum_plain` are their
plain PyTorch versions, which CPU tensors take.
"""

from __future__ import annotations

import torch

from ..ops import _cuda

_ELEM_BYTES = {torch.uint8: 1, torch.int32: 4}


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"expected a uint8 or int32 tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _check_pert(x: torch.Tensor, pert: torch.Tensor) -> None:
    if pert.dtype != torch.uint8 or pert.dim() != 0:
        raise ValueError(f"pert must be a 0-d uint8 tensor, got {pert.dtype} {tuple(pert.shape)}")
    if pert.device != x.device:
        raise ValueError(f"pert lies on {pert.device}, x on {x.device}")


def carry(x: torch.Tensor, pert: torch.Tensor) -> torch.Tensor:
    """``x + pert`` for a contiguous uint8 or int32 tensor ``x`` and a
    0-d uint8 ``pert`` on its device, in ``x``'s dtype (uint8 wraps mod
    256).  ``pert`` is read on the device, so a step that carries it can
    be captured in a CUDA graph.  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    _check(x)
    _check_pert(x, pert)
    if x.is_cuda:
        _cuda.load()
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        _cuda.launch(
            "carry", x.data_ptr(), x.numel() * x.element_size(), x.element_size(),
            pert.data_ptr(), out.data_ptr(), _cuda.stream(x),
        )
        return out
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return carry_plain(x, pert)


def carry_plain(x: torch.Tensor, pert: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `carry`."""
    return x + pert


def checksum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a contiguous uint8 or int32 tensor as a 0-d int32 tensor
    on its device, in int32 arithmetic that wraps mod 2^32, as XLA's
    ``jnp.sum(x.astype(jnp.int32))`` does; one read of ``x``.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    _check(x)
    if x.is_cuda:
        _cuda.load()
        out = torch.empty((), dtype=torch.int32, device=x.device)
        _cuda.launch(
            "checksum", x.data_ptr(), x.numel() * x.element_size(), x.element_size(),
            out.data_ptr(), _cuda.stream(x),
        )
        return out
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return checksum_plain(x)


def checksum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `checksum`: the int64 sum, wrapped to
    int32."""
    _check(x)
    total = x.sum(dtype=torch.int64)
    return (torch.remainder(total + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)
