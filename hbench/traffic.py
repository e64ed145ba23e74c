"""The one generator of every traffic mix: a pool of units made from the seed.

A traffic file gives ``source``, ``pool_units`` and ``request_units``;
the unit is the configuration's ``unit_bytes``.  The source is a module
of its own, ``hbench/sources/<source>.py``, whose ``make_pool(config,
traffic, seed, device)`` gives the (pool_units, unit_bytes) uint8 pool:
``biased`` (the headline block's distribution) and ``corpus`` (windows
of the frozen corpus) are there.

Every seed gives the same sizes and the same number of units; only the
bytes differ.
"""

from __future__ import annotations

import torch

from . import spec

_SEED_SPAN = 1 << 64


def make_pool(config: dict, traffic: dict, seed: int, device, root: str = spec.ROOT) -> torch.Tensor:
    """(pool_units, unit_bytes) uint8 on ``device``, from ``seed``."""
    source = spec.part("sources", traffic["source"], root)
    return source.make_pool(config, traffic, seed % _SEED_SPAN, device)
