"""Byte histograms by nibble one-hot products: the variants of the
histogram race.

Counterpart: ``tools/hist_experiments.py:hist_variant``, which counts
bin ``16*hi + lo`` as entry (hi, lo) of the product of the hi- and
lo-nibble one-hots of every byte, in one of five TPU variants.  The CUDA
kernel is ``csrc/hist256_onehot.cu``; on the card the five variants
become three MMA input types (`VARIANTS`), because there the product's
type, not the compare's, is what differs.  `hist_variant_plain` is its
plain PyTorch version.

Unlike the TPU tool, whose f32 output is exact only below 2^24 per bin,
the result is exact int32 for any length below 2^31.
"""

from __future__ import annotations

import torch

from . import _cuda

#: Bytes per grid step of the TPU kernel; the length must be a multiple.
CHUNK = 1 << 19

#: MMA input types of the card's kernel, in the C entry's numbering.
MMA_TYPES = ("s8", "bf16", "tf32")
#: The TPU variant names and the MMA type each runs as here.
VARIANTS = {
    "base": "bf16",
    "bf16cmp": "bf16",
    "wide": "bf16",
    "f32cmp": "tf32",
    "i8dot": "s8",
}


def mma_type(variant: str) -> str:
    """The MMA type of a TPU variant name, or the MMA type itself."""
    if variant in MMA_TYPES:
        return variant
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown variant {variant!r}: expected one of {sorted(VARIANTS) + list(MMA_TYPES)}"
        )
    return VARIANTS[variant]


def _check(x: torch.Tensor, variant: str) -> str:
    mma = mma_type(variant)
    if x.dtype != torch.uint8 or x.dim() != 1:
        raise ValueError(f"expected a (n,) uint8 tensor, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    if n == 0 or n % CHUNK:
        raise ValueError(f"length {n} is not a positive multiple of {CHUNK}")
    return mma


def hist_variant(x: torch.Tensor, variant: str) -> torch.Tensor:
    """(256,) int32 counts of the (n,) uint8 tensor ``x``, n a positive
    multiple of `CHUNK`, by one-hot products of type ``variant`` (a TPU
    variant name or an MMA type).  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    mma = _check(x, variant)
    if x.is_cuda:
        _cuda.check(x, "x", torch.uint8, tuple(x.shape))
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
        out = torch.empty(256, dtype=torch.int32, device=x.device)
        _cuda.launch(
            "hist256_onehot", x.data_ptr(), x.shape[0], MMA_TYPES.index(mma),
            out.data_ptr(), _cuda.stream(x),
        )
        return out
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return hist_variant_plain(x, variant)


def hist_variant_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version of `hist_variant`: for each `CHUNK` of bytes,
    the (16, CHUNK) hi one-hot times the (CHUNK, 16) lo one-hot, summed
    in int64.  One float32 product serves every variant: the one-hots are
    0 and 1 in every type, and a chunk's counts stay below 2^24, so every
    type's product is the same exact count."""
    _check(x, variant)
    nib = torch.arange(16, dtype=torch.uint8, device=x.device)
    total = torch.zeros((16, 16), dtype=torch.int64, device=x.device)
    for chunk in x.view(-1, CHUNK):
        hi = ((chunk >> 4).view(1, -1) == nib.view(-1, 1)).to(torch.float32)
        lo = ((chunk & 15).view(-1, 1) == nib.view(1, -1)).to(torch.float32)
        total += (hi @ lo).to(torch.int64)
    return total.reshape(256).to(torch.int32)
