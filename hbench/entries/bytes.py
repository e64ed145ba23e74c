"""``bytes``: ``compress`` of host bytes (``request_units`` units joined)
and ``decompress`` of the blob."""

from __future__ import annotations

import numpy as np
import torch


class Api:
    #: A compress request returns the blob itself: the ratio is taken over
    #: the window's blobs, and the check reads blobs alone.
    returns_blobs = True

    def __init__(self, codec, pool: torch.Tensor, traffic: dict):
        self.codec = codec
        b = traffic["request_units"]
        host = pool.cpu().numpy()
        self.inputs = [host[i : i + b].tobytes() for i in range(0, host.shape[0] - b + 1, b)]

    def compress(self, raw: bytes) -> bytes:
        return self.codec.compress(raw)

    def decompress(self, blob: bytes) -> bytes:
        return self.codec.decompress(blob)

    def raw(self, i: int) -> np.ndarray:
        return np.frombuffer(self.inputs[i], np.uint8)[None]

    def decoded(self, out: bytes) -> np.ndarray:
        return np.frombuffer(out, np.uint8)[None]

    def blobs(self, blob: bytes) -> list[bytes]:
        return [blob]
