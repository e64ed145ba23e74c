"""``corpus``: each unit a window of the frozen corpus (4 MiB of Python
standard-library source, ``hbench/data/corpus.bin``), tiled, at an offset
drawn from the seed."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "corpus.bin")
CORPUS_SHA256 = "02019a5abb9dfdd31b3aa0bb39a5ee484b50e191d2827ca4c991e44190a5e7d4"


def corpus() -> np.ndarray:
    """The frozen corpus; raises where its bytes are not the committed ones."""
    with open(CORPUS, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA256:
        raise RuntimeError(f"{CORPUS} is not the frozen corpus (sha256 differs)")
    return np.frombuffer(data, np.uint8)


def make_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    units, unit = traffic["pool_units"], config["unit_bytes"]
    dev = torch.device(device)
    pool = torch.empty((units, unit), dtype=torch.uint8, device=dev)
    text = corpus()
    offsets = np.random.default_rng(seed).integers(0, len(text), units)
    reps = -(-(unit + len(text)) // len(text))
    tiled = torch.from_numpy(np.tile(text, reps)).to(dev)
    for i, off in enumerate(offsets.tolist()):
        pool[i] = tiled[off : off + unit]
    return pool
