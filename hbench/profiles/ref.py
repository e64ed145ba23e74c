"""The ``ref`` profile: ``TorchRefCodec`` at the configuration's lanes, the
reference library's own K-stream blob, one a request (no container).

Its check holds each blob to the plain reference of that format
(`ref_reference`), byte for byte, since the format is the interchange
contract; the numbers are `check`'s, each limit 0:

* ``failed``: requests that raised;
* ``table_diff``: symbols whose code (length or bits) in the blob's
  table differs from the reference's table of the same bytes;
* ``lane_diff``: streams whose region, from the end offsets, differs in
  size from the reference's (``ceil(bits / 8) + 8`` bytes a stream);
* ``blob_diff``: bytes of the blob that differ from the reference's blob
  of the same input (a missing or extra byte counts), plus the bytes the
  reference's reader decodes wrong from it, or every byte plus one where
  it cannot read it;
* ``decode_diff``: bytes of the sampled decompress requests that differ
  from their inputs, and every missing or extra byte.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from hbench import reference as R, ref_reference as RR
from hbench.check import NAMES, _bytes_diff, _diff
from hbench.peaks import decompress_bytes, lane_bytes  # noqa: F401


def make_codec(config: dict, device):
    from huffman_tpu_torch.models.torch_ref_codec import TorchRefCodec

    return TorchRefCodec(config["lanes"], device=device)


class Tally:
    def __init__(self, config: dict):
        self.k = config["lanes"]
        self.n = dict.fromkeys(NAMES, 0)
        self._own: dict[bytes, dict] = {}

    def _reference(self, raw: np.ndarray) -> dict:
        """The reference's blob of ``raw``, worked out once an input."""
        key = hashlib.sha256(np.ascontiguousarray(raw)).digest()
        if key not in self._own:
            self._own[key] = RR.compress(raw, self.k)
        return self._own[key]

    def blob(self, raw: np.ndarray, blob: bytes) -> None:
        """One blob of the (n,) bytes ``raw``."""
        want = self._reference(raw)
        self.n["blob_diff"] += _bytes_diff(np.frombuffer(blob, np.uint8),
                                           np.frombuffer(want["blob"], np.uint8))
        try:
            h = RR.parse(blob, self.k)
            self.n["lane_diff"] += _diff(h["regions"], want["regions"])
            lens, codes = R.canonical_from_counts(h["len_count"], h["ranked"], RR.MAX_LEN)
            self.n["table_diff"] += int(np.count_nonzero(
                (lens != want["lens"]) | (codes != want["codes"])))
            got = RR.decode(h, self.k)
        except (ValueError, IndexError, struct.error):
            self.n["blob_diff"] += len(raw) + 1
            return
        self.n["blob_diff"] += _bytes_diff(got, raw)

    def encoded(self, raw: np.ndarray, got: dict) -> None:
        """A compress request's (B, n) input and its blobs (``got["blobs"]``)."""
        for row, blob in zip(raw, got["blobs"]):
            self.blob(row, blob)

    def decoded(self, raw: np.ndarray, got: np.ndarray) -> None:
        self.n["decode_diff"] += _bytes_diff(got.reshape(-1), raw.reshape(-1))

    def numbers(self) -> dict:
        return {name: {"value": v, "limit": 0} for name, v in self.n.items()}

    def correct(self) -> bool:
        return all(v == 0 for v in self.n.values())


def compress_bytes(n_in: int, bits: np.ndarray) -> int:
    """Least bytes of a compress request on the card: its input read and
    the lane words that hold its codes written."""
    return n_in + lane_bytes(bits)
