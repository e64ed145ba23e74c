"""The comparison that decides ``correct``: what the timed path returned,
held to the plain reference (`reference`), every number exact.

* ``failed``: requests that raised.
* ``table_diff``: symbols whose code (its bits and length) differs from
  the reference's table of the same bytes, in the sampled compress
  requests' tables and in the checked blobs' tables.
* ``lane_diff``: lane words and bit counts of the sampled compress
  requests that differ from the reference's encode of the same bytes,
  and bit counts of the checked blobs that differ from it.
* ``blob_diff``: bytes that the reference's reader of the checked blobs
  gets wrong, and every byte of a blob it cannot read.
* ``decode_diff``: bytes of the sampled decompress requests that differ
  from their inputs, and every missing or extra byte.

Each limit is 0.
"""

from __future__ import annotations

import struct

import numpy as np

from . import reference as R

NAMES = ("failed", "table_diff", "lane_diff", "blob_diff", "decode_diff")


class Tally:
    def __init__(self, config: dict):
        self.config = config
        self.max_len = config["max_code_len"]
        self.n = dict.fromkeys(NAMES, 0)

    def _table(self, block: np.ndarray, n_raw: int) -> dict:
        """The reference's table of an n_raw-byte block, zero-padded to
        whole lane rows as the encode pads it."""
        return R.code_table(
            R.table_histogram(block, n_raw, self.config.get("table_sample")), self.max_len
        )

    def encoded(self, raw: np.ndarray, got: dict) -> None:
        """A compress request's (B, n) input and its host outputs."""
        k = self.config["lanes"]
        padded = R.pad_lanes(raw, k)
        tabs = [self._table(row, raw.shape[1]) for row in padded]
        lens = np.stack([t["lens"] for t in tabs])
        codes = np.stack([t["codes"] for t in tabs])
        words, bits = R.encode_lanes(padded, lens, codes, k, self.max_len)
        enc = np.stack([t["enc"] for t in tabs])
        self.n["table_diff"] += _diff(got["enc"], enc)
        self.n["lane_diff"] += _diff(got["words"], words) + _diff(got["bits"], bits)
        if got["k"] != k:
            self.n["lane_diff"] += bits.size

    def blob(self, raw: np.ndarray, blob: bytes) -> None:
        """One blob (HTP3, or an HTPC container) of the (n,) bytes ``raw``."""
        try:
            if blob[:4] == R.HTPC_MAGIC:
                out, blocks = R.read_container(blob, self.max_len)
            else:
                got = R.read_htp3(blob, self.max_len)
                out, blocks = got["raw"].tobytes(), [dict(got, offset=0, raw_len=len(raw))]
        except (ValueError, IndexError, struct.error):
            self.n["blob_diff"] += len(raw) + 1
            return
        self.n["blob_diff"] += _bytes_diff(np.frombuffer(out, np.uint8), raw)
        k = self.config["lanes"]
        for b in blocks:
            block = np.zeros(len(b["raw"]), np.uint8)
            block[: b["raw_len"]] = raw[b["offset"] : b["offset"] + b["raw_len"]]
            padded = R.pad_lanes(block[None], k)[0]
            tab = self._table(padded, len(block))
            self.n["table_diff"] += _diff(b["lens"], tab["lens"]) + _diff(b["codes"], tab["codes"])
            bits = tab["lens"][padded].reshape(-1, k).sum(0)
            self.n["lane_diff"] += _diff(b["bits"], bits)

    def decoded(self, raw: np.ndarray, got: np.ndarray) -> None:
        self.n["decode_diff"] += _bytes_diff(got.reshape(-1), raw.reshape(-1))

    def numbers(self) -> dict:
        return {name: {"value": v, "limit": 0} for name, v in self.n.items()}

    def correct(self) -> bool:
        return all(v == 0 for v in self.n.values())


def _diff(a: np.ndarray, b: np.ndarray) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a.astype(np.int64) != b.astype(np.int64)))


def _bytes_diff(a: np.ndarray, b: np.ndarray) -> int:
    m = min(len(a), len(b))
    return int(np.count_nonzero(a[:m] != b[:m])) + abs(len(a) - len(b))
