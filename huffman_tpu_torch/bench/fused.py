"""The sustained loop's device work around the codec: the carried 0 and
the fold of the sums into the accumulator.

Counterpart: one iteration of the JAX harness's loop,
``acc + body(jnp.isnan(acc).astype(jnp.uint8))``
(``huffman_tpu/bench/harness.py:40-42``), around bodies that add the
carried 0 (``d + pert``) and end in an int32 sum converted to float32
(``bench.py:172-190``, ``huffman_tpu/bench/harness.py:127-145`` and the
tools' bodies).  XLA fuses the NaN test, the add, the sums, the
conversion and the float add into the passes around the codec.
PyTorch's eager ops take a launch for each scalar step, its u8 add is
slow, and its int32 sum of u8 writes a widened copy first.  So on a
CUDA tensor `carry` and `fold` launch the hand-written kernels of
``csrc/bench_ops.cu``; `carry_plain` and `fold_plain` are their plain
PyTorch versions, which CPU tensors take.

The accumulator is a 0-d float32 tensor from `accumulator`.  On a card
its storage also holds the 64-bit scratch word of `fold`'s kernel, so a
body needs nothing but ``acc``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _cuda

_ELEM_BYTES = {torch.uint8: 1, torch.int32: 4}
#: The most tensors one `fold` takes (the kernel's parameter slots).
MAX_PARTS = 4
#: The accumulator's storage in 4-byte words: the float32 sum, one spare,
#: then fold's 64-bit scratch word (8-byte aligned: the blocks done and
#: their sums).
_ACC_WORDS = 4
_SCRATCH_OFFSET = 8


def accumulator(device) -> torch.Tensor:
    """A 0-d float32 zero on ``device`` for `carry` and `fold`: a view of
    the first of four zeroed 4-byte words, the last two of which are
    `fold`'s scratch on a card (left 0 by every fold)."""
    words = torch.zeros(_ACC_WORDS, dtype=torch.int32, device=device)
    return words.view(torch.float32)[0]


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"expected a uint8 or int32 tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _check_acc(acc: torch.Tensor, x: torch.Tensor) -> None:
    if acc.dtype != torch.float32 or acc.dim() != 0:
        raise ValueError(f"acc must be a 0-d float32 tensor, got {acc.dtype} {tuple(acc.shape)}")
    if acc.device != x.device:
        raise ValueError(f"acc lies on {acc.device}, x on {x.device}")


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def carry(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``x + isnan(acc)`` for a contiguous uint8 or int32 tensor ``x`` and
    the 0-d float32 accumulator ``acc`` on its device, in ``x``'s dtype
    (uint8 wraps mod 256): the carried 0, which is 1 once ``acc`` is NaN.
    ``acc`` is read on the device, so a step that carries it can be
    captured in a CUDA graph.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    _check(x)
    _check_acc(acc, x)
    if x.is_cuda:
        _cuda.load()
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        _cuda.launch(
            "carry", x.data_ptr(), x.numel() * x.element_size(), x.element_size(),
            acc.data_ptr(), out.data_ptr(), _cuda.stream(x),
        )
        return out
    _check_device(x)
    return carry_plain(x, acc)


def carry_plain(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `carry`."""
    return x + torch.isnan(acc).to(x.dtype)


def fold(acc: torch.Tensor, *xs: torch.Tensor) -> None:
    """``acc += float32(s)`` in place, ``s`` the sum of the elements of
    one to `MAX_PARTS` contiguous uint8 or int32 tensors ``xs`` in int32
    arithmetic that wraps mod 2^32, rounded to nearest: what
    ``acc + (jnp.sum(a) + jnp.sum(b)).astype(jnp.float32)`` gives (one
    total, then one conversion).  ``acc`` is a 0-d float32 tensor on their
    device; on a card it must come from `accumulator`.  One read of each
    tensor and nothing else in one launch on a card; CPU tensors take the
    plain version."""
    if not 1 <= len(xs) <= MAX_PARTS:
        raise ValueError(f"fold takes 1 to {MAX_PARTS} tensors, got {len(xs)}")
    for x in xs:
        _check(x)
        _check_acc(acc, x)
    if acc.is_cuda:
        _cuda.load()
        storage = acc.untyped_storage()
        if acc.storage_offset() != 0 or storage.nbytes() != 4 * _ACC_WORDS:
            raise ValueError("on a card acc must come from fused.accumulator")
        n = len(xs)
        _cuda.launch(
            "fold",
            (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs)),
            (ctypes.c_longlong * n)(*(x.numel() * x.element_size() for x in xs)),
            (ctypes.c_int * n)(*(x.element_size() for x in xs)),
            n, acc.data_ptr(), acc.data_ptr() + _SCRATCH_OFFSET, _cuda.stream(acc),
        )
        return
    _check_device(acc)
    fold_plain(acc, *xs)


def fold_plain(acc: torch.Tensor, *xs: torch.Tensor) -> None:
    """Plain PyTorch version of `fold`: the int64 sum of every element,
    wrapped to int32, converted to float32 and added to ``acc``."""
    total = sum(x.sum(dtype=torch.int64) for x in xs)
    wrapped = (torch.remainder(total + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)
    acc.add_(wrapped.to(torch.float32))
