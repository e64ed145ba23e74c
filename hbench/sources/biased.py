"""``biased``: bytes drawn from P(c) ~ (1 - p)^c * p over 0..255,
renormalised (``p`` = ``biased_p``), by inverse CDF of float64 uniforms
from a ``torch.Generator`` on the pool's device, one call a unit: the
distribution of the repo's 16 MiB headline block
(``huffman_tpu_torch/bench/workloads.py:biased_u8``, P(c) ~ 0.8^c * 0.2)."""

from __future__ import annotations

import torch


def make_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    units, unit = traffic["pool_units"], config["unit_bytes"]
    dev = torch.device(device)
    pool = torch.empty((units, unit), dtype=torch.uint8, device=dev)
    p = float(traffic["biased_p"])
    w = (1.0 - p) ** torch.arange(256, dtype=torch.float64, device=dev) * p
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for i in range(units):
        u = torch.rand(unit, dtype=torch.float64, generator=gen, device=dev)
        pool[i] = torch.searchsorted(cdf, u, right=True).clamp_(max=255)
    return pool
