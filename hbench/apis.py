"""The program's public entry points that a traffic mix drives.

A traffic file names one ``api``:

* ``device``: ``encode_device`` of a (n,) uint8 tensor on the card and
  ``decode_device`` of its result;
* ``batch``: ``encode_batch`` of ``request_units`` pages, (B, n), and
  ``decode_batch`` of its three outputs with ``statics=None``, as for a
  batch it has not seen;
* ``bytes``: ``compress`` of host bytes (``request_units`` units joined)
  and ``decompress`` of the blob.

Each adapter holds the request inputs, the set-up's encodings of them
(the decompress requests' inputs), and turns what a request returned
into host arrays for the check.
"""

from __future__ import annotations

import numpy as np
import torch


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


class DeviceApi:
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


class BatchApi(DeviceApi):
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


class BytesApi:
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


APIS = {"device": DeviceApi, "batch": BatchApi, "bytes": BytesApi}


def make(codec, pool: torch.Tensor, traffic: dict):
    return APIS[traffic["api"]](codec, pool, traffic)
