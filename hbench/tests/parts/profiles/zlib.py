"""A profile of the tests: zlib in the program's place, held to
``zlib.decompress`` (every byte back, every blob readable)."""

import zlib

import numpy as np


class Codec:
    def __init__(self, level: int):
        self.level = level

    def compress(self, raw: bytes) -> bytes:
        return zlib.compress(raw, self.level)

    def decompress(self, blob: bytes) -> bytes:
        return zlib.decompress(blob)


def make_codec(config: dict, device):
    return Codec(config["level"])


class Tally:
    def __init__(self, config: dict):
        self.n = {"failed": 0, "blob_diff": 0, "decode_diff": 0}

    def _diff(self, got: np.ndarray, raw: np.ndarray) -> int:
        got, raw = got.reshape(-1), raw.reshape(-1)
        m = min(len(got), len(raw))
        return int(np.count_nonzero(got[:m] != raw[:m])) + abs(len(got) - len(raw))

    def blob(self, raw: np.ndarray, blob: bytes) -> None:
        try:
            self.n["blob_diff"] += self._diff(np.frombuffer(zlib.decompress(blob), np.uint8), raw)
        except zlib.error:
            self.n["blob_diff"] += len(raw) + 1

    def decoded(self, raw: np.ndarray, got: np.ndarray) -> None:
        self.n["decode_diff"] += self._diff(got, raw)

    def numbers(self) -> dict:
        return {name: {"value": v, "limit": 0} for name, v in self.n.items()}

    def correct(self) -> bool:
        return all(v == 0 for v in self.n.values())


def compress_bytes(n_in: int, bits) -> int:
    return n_in


def decompress_bytes(n_out: int, bits) -> int:
    return n_out
