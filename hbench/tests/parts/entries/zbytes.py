"""An entry point of the tests: the bytes API of the ``zlib`` profile.

In a run of several ranks every request all-reduces a 1 on the pool's
device, so ranks whose requests do not pair up hang.  The traffic may ask
that rank ``fail_rank`` raise in set-up, that rank ``stall_rank`` sleep
there for good, or that rank ``ballast_rank``
hold ``ballast_bytes`` more on its device; ``record`` names a directory
where each rank writes its calls and peak resident bytes at exit.
"""

import atexit
import json
import os
import resource
import time

import numpy as np
import torch
import torch.distributed as dist


class Api:
    returns_blobs = True

    def __init__(self, codec, pool: torch.Tensor, traffic: dict):
        self.codec, self.device = codec, pool.device
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.calls = {"compress": 0, "decompress": 0}
        record = traffic.get("record")
        if record:
            atexit.register(self._write, os.path.join(record, f"calls.{self.rank}.json"))
        if traffic.get("fail_rank") == self.rank:
            raise RuntimeError(f"rank {self.rank} fails in set-up, as the traffic asks")
        if traffic.get("stall_rank") == self.rank:
            time.sleep(3600)
        if traffic.get("ballast_rank") == self.rank:
            self.ballast = torch.ones(traffic["ballast_bytes"], dtype=torch.uint8, device=self.device)
        b = traffic["request_units"]
        host = pool.cpu().numpy()
        self.inputs = [host[i : i + b].tobytes() for i in range(0, host.shape[0] - b + 1, b)]

    def _write(self, path: str) -> None:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        with open(path, "w") as f:
            json.dump(dict(self.calls, rss=rss), f)

    def _pair(self, name: str) -> None:
        self.calls[name] += 1
        if dist.is_initialized():
            one = torch.ones(1, device=self.device)
            dist.all_reduce(one)
            if int(one.item()) != self.world:
                raise RuntimeError(f"all_reduce gave {one.item()}, not {self.world}")

    def compress(self, raw: bytes) -> bytes:
        self._pair("compress")
        return self.codec.compress(raw)

    def decompress(self, blob: bytes) -> bytes:
        self._pair("decompress")
        return self.codec.decompress(blob)

    def raw(self, i: int) -> np.ndarray:
        return np.frombuffer(self.inputs[i], np.uint8)[None]

    def decoded(self, out: bytes) -> np.ndarray:
        return np.frombuffer(out, np.uint8)[None]

    def blobs(self, blob: bytes) -> list[bytes]:
        return [blob]
