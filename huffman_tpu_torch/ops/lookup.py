"""Byte histograms: the whole block, or the strided row sample that picks
the table of a large block.

Counterparts: ``huffman_tpu/ops/lookup.py:histogram256`` and
``_table_hist`` in ``huffman_tpu/models/tpu_codec.py``.  The CUDA kernel
is ``csrc/hist256.cu``; `table_hist_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _cuda

#: Sampled run length in bytes: rows 0, stride, 2*stride, ... of this
#: length are counted (``_HIST_ROW`` in the JAX codec).
HIST_ROW = 512


def _geometry(n: int, hist_stride: int) -> tuple[int, int, int, int, int]:
    """(rows, row_len, pitch, last_len, bias) of the bytes to count."""
    if hist_stride <= 1 or n < HIST_ROW * hist_stride:
        rows = -(-n // HIST_ROW)
        return rows, HIST_ROW, HIST_ROW, n - (rows - 1) * HIST_ROW if rows else 0, 0
    # Sampled: every stride-th row, then +1 so every byte value gets a code.
    rows = n // (HIST_ROW * hist_stride)
    return rows, HIST_ROW, HIST_ROW * hist_stride, HIST_ROW, 1


def table_hist(padded: torch.Tensor, hist_stride: int) -> torch.Tensor:
    """(256,) int32 counts that the table of ``padded`` is built from.

    With ``hist_stride > 1`` and at least one full sample row, counts rows
    0, stride, 2*stride, ... of 512 bytes and adds 1 to every bin;
    otherwise counts every byte.  CPU tensors take the plain version, CUDA
    tensors the kernel.
    """
    if padded.is_cuda:
        return _table_hist_cuda(padded, hist_stride)
    if padded.device.type != "cpu":
        raise ValueError(f"unsupported device {padded.device}")
    return table_hist_plain(padded, hist_stride)


def histogram256(x: torch.Tensor) -> torch.Tensor:
    """(256,) int32 counts of every byte of the (n,) uint8 tensor ``x``."""
    return table_hist(x, 1)


def _table_hist_cuda(padded: torch.Tensor, hist_stride: int) -> torch.Tensor:
    n = padded.shape[0]
    _cuda.check(padded, "padded", torch.uint8, (n,))
    _cuda.load()
    rows, row_len, pitch, last_len, bias = _geometry(n, hist_stride)
    out = torch.empty(256, dtype=torch.int32, device=padded.device)
    _cuda.launch(
        "hist256", padded.data_ptr(), rows, row_len, pitch, last_len, bias,
        out.data_ptr(), _cuda.stream(padded),
    )
    return out


def table_hist_plain(padded: torch.Tensor, hist_stride: int) -> torch.Tensor:
    """Plain PyTorch version of `table_hist` (``torch.bincount``)."""
    if padded.dtype != torch.uint8 or padded.dim() != 1:
        raise ValueError("expected a (n,) uint8 tensor")
    n = padded.shape[0]
    rows, row_len, pitch, _, bias = _geometry(n, hist_stride)
    if bias:
        sample = padded[: rows * pitch].view(rows, pitch)[:, :row_len].reshape(-1)
    else:
        sample = padded
    hist = torch.bincount(sample.long(), minlength=256) + bias
    return hist.to(torch.int32)
