"""``batch``: ``encode_batch`` of ``request_units`` pages, (B, n), and
``decode_batch`` of its three outputs with ``statics=None``, as for a
batch it has not seen."""

from __future__ import annotations

import numpy as np
import torch


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


class Api:
    returns_blobs = False

    def __init__(self, codec, pool: torch.Tensor, traffic: dict):
        self.codec = codec
        b = traffic["request_units"]
        self.inputs = [pool[i : i + b] for i in range(0, pool.shape[0] - b + 1, b)]
        self.n_block = pool.shape[1]

    def compress(self, x):
        return self.codec.encode_batch(x)

    def decompress(self, triple):
        words, bits, tables = triple
        return self.codec.decode_batch(words, bits, tables, self.n_block)

    def raw(self, i: int) -> np.ndarray:
        return self.inputs[i].cpu().numpy()

    def encoded(self, out) -> dict:
        words, bits, tables = out
        return {
            "words": _u32(words),
            "bits": bits.cpu().numpy().astype(np.int64),
            "enc": tables["enc_table"].cpu().numpy().astype(np.int64),
            "k": words.shape[2],
        }

    def bits(self, out) -> np.ndarray:
        return out[1].cpu().numpy()

    def decoded(self, out) -> np.ndarray:
        return out.cpu().numpy().reshape(out.shape[0], -1)[:, : self.n_block]

    def blobs(self, triple) -> list[bytes]:
        from huffman_tpu_torch.models.torch_codec import TorchCompressed

        words, bits, tables = triple
        return [
            self.codec.serialize(
                TorchCompressed(
                    words=words[i], bit_counts=bits[i], raw_size=self.n_block,
                    k=words.shape[2], tables={key: v[i] for key, v in tables.items()},
                )
            )
            for i in range(words.shape[0])
        ]
