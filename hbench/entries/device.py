"""``device``: ``encode_device`` of a (n,) uint8 tensor on the card and
``decode_device`` of its result.

The adapter holds the request inputs, the set-up's encodings of them (the
decompress requests' inputs), and turns what a request returned into
host arrays for the check.
"""

from __future__ import annotations

import numpy as np
import torch


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


class Api:
    returns_blobs = False

    def __init__(self, codec, pool: torch.Tensor, traffic: dict):
        self.codec = codec
        self.inputs = [pool[i] for i in range(pool.shape[0])]

    def compress(self, x):
        return self.codec.encode_device(x)

    def decompress(self, comp):
        return self.codec.decode_device(comp)

    def raw(self, i: int) -> np.ndarray:
        """(B, n) host bytes of request input ``i`` (B = 1 here)."""
        return self.inputs[i].cpu().numpy()[None]

    def encoded(self, out) -> dict:
        """A compress request's output on the host: words (B, W, K),
        bits (B, K), enc (B, 256), k."""
        return {
            "words": _u32(out.words)[None],
            "bits": out.bit_counts.cpu().numpy()[None].astype(np.int64),
            "enc": out.tables["enc_table"].cpu().numpy()[None].astype(np.int64),
            "k": out.k,
        }

    def bits(self, out) -> np.ndarray:
        """A compress request's bit counts (B, K) on the host."""
        return out.bit_counts.cpu().numpy()[None]

    def decoded(self, out) -> np.ndarray:
        return out.cpu().numpy()[None]

    def blobs(self, comp) -> list[bytes]:
        """HTP3 blobs of one encoding, one a block or page."""
        return [self.codec.serialize(comp)]
