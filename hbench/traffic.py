"""The one generator of every traffic mix: a pool of units made from the seed.

A traffic file gives ``source``, ``pool_units`` and ``request_units``;
the unit is the configuration's ``unit_bytes``.  Sources:

* ``biased``: bytes drawn from P(c) ~ (1 - p)^c * p over 0..255,
  renormalised (``p`` = ``biased_p``), by inverse CDF of float64 uniforms
  from a ``torch.Generator`` on the pool's device, one call a unit: the
  distribution of the repo's 16 MiB headline block
  (``huffman_tpu_torch/bench/workloads.py:biased_u8``, P(c) ~ 0.8^c * 0.2).
* ``corpus``: each unit a window of the frozen corpus (4 MiB of Python
  standard-library source, ``hbench/data/corpus.bin``), tiled, at an
  offset drawn from the seed.

Every seed gives the same sizes and the same number of units; only the
bytes differ.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "corpus.bin")
CORPUS_SHA256 = "02019a5abb9dfdd31b3aa0bb39a5ee484b50e191d2827ca4c991e44190a5e7d4"
_SEED_SPAN = 1 << 64


def corpus() -> np.ndarray:
    """The frozen corpus; raises where its bytes are not the committed ones."""
    with open(CORPUS, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA256:
        raise RuntimeError(f"{CORPUS} is not the frozen corpus (sha256 differs)")
    return np.frombuffer(data, np.uint8)


def make_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """(pool_units, unit_bytes) uint8 on ``device``, from ``seed``."""
    units, unit = traffic["pool_units"], config["unit_bytes"]
    seed %= _SEED_SPAN
    dev = torch.device(device)
    pool = torch.empty((units, unit), dtype=torch.uint8, device=dev)
    if traffic["source"] == "biased":
        p = float(traffic["biased_p"])
        w = (1.0 - p) ** torch.arange(256, dtype=torch.float64, device=dev) * p
        cdf = torch.cumsum(w, 0)
        cdf /= cdf[-1].clone()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for i in range(units):
            u = torch.rand(unit, dtype=torch.float64, generator=gen, device=dev)
            pool[i] = torch.searchsorted(cdf, u, right=True).clamp_(max=255)
    elif traffic["source"] == "corpus":
        text = corpus()
        offsets = np.random.default_rng(seed).integers(0, len(text), units)
        reps = -(-(unit + len(text)) // len(text))
        tiled = torch.from_numpy(np.tile(text, reps)).to(dev)
        for i, off in enumerate(offsets.tolist()):
            pool[i] = tiled[off : off + unit]
    else:
        raise ValueError(f"unknown traffic source {traffic['source']!r}")
    return pool
