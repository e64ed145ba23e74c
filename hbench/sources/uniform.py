"""``uniform``: bytes uniform over 0..255 from a ``torch.Generator`` on the
pool's device seeded from the seed, one call a unit: incompressible input
(already-compressed media, archives, ciphertext), the reference
benchmark's ``uniform`` workload (``huffman_benchmark.cpp``)."""

from __future__ import annotations

import torch


def make_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    units, unit = traffic["pool_units"], config["unit_bytes"]
    dev = torch.device(device)
    pool = torch.empty((units, unit), dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for i in range(units):
        pool[i] = torch.randint(0, 256, (unit,), generator=gen, dtype=torch.uint8, device=dev)
    return pool
