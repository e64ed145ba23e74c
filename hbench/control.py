"""The control of the check: the reference put in the program's place, one
step below what the configuration states.

The configurations state a table whose Huffman lengths are cut to 15
bits.  The control cuts them to 12, the ``ref`` profile's limit, whose
4096-entry decode tables tempt a faster decode: it codes every byte
losslessly, into other tables, lanes and blobs.  `ControlCodec` offers
the entry points the harness drives (``encode_device``,
``decode_device``, ``encode_batch``, ``decode_batch``, ``serialize``,
``compress``, ``decompress``), computed by `reference` in NumPy; the
check has to find it not correct.  On a card:

    python3 hbench/control.py --workload <cell> --seed <n> --seconds <s>

runs a cell with the control in the program's place and prints the
numbers compared and ``correct``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hbench import reference as R  # noqa: E402

#: The length limit the control codes with.
CONTROL_MAX_LEN = 12


@dataclasses.dataclass
class Coded:
    words: torch.Tensor
    bit_counts: torch.Tensor
    raw_size: int
    k: int
    tables: dict


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.int64).astype(np.uint32).view(np.int32))).to(device)


class ControlCodec:
    def __init__(self, config: dict, device):
        self.config = config
        self.k = config["lanes"]
        self.device = torch.device(device)
        self.block_bytes = config["block_bytes"]

    def _table(self, block: np.ndarray, n_raw: int) -> dict:
        t = R.code_table(R.table_histogram(block, n_raw, self.config.get("table_sample")),
                         CONTROL_MAX_LEN)
        # The program's layout: codes left-aligned in 15 bits.
        t["codes15"] = t["codes"] << (15 - CONTROL_MAX_LEN)
        return t

    def _encode(self, blocks: np.ndarray):
        padded = R.pad_lanes(blocks, self.k)
        tabs = [self._table(row, blocks.shape[1]) for row in padded]
        words, bits = R.encode_lanes(
            padded, np.stack([t["lens"] for t in tabs]), np.stack([t["codes"] for t in tabs]),
            self.k, CONTROL_MAX_LEN,
        )
        ranked = np.zeros((len(tabs), 256), np.int64)
        for i, t in enumerate(tabs):
            ranked[i, : len(t["ranked"])] = t["ranked"]
        tables = {
            "enc_table": np.stack([(t["codes15"] << 4) | t["lens"] for t in tabs]),
            "len_count": np.stack([np.pad(t["len_count"], (0, 15 - CONTROL_MAX_LEN)) for t in tabs]),
            "sorted_syms": ranked,
            "num_syms": np.array([len(t["ranked"]) for t in tabs]),
        }
        dev = self.device
        return _i32(words, dev), _i32(bits, dev), {k: _i32(v, dev) for k, v in tables.items()}

    def _decode(self, words: np.ndarray, tables: dict, n: int) -> np.ndarray:
        """(B, n) bytes of (B, W, K) words with their tables."""
        out = []
        for b in range(words.shape[0]):
            lc = tables["len_count"][b]
            lens, codes = R.canonical_from_counts(lc, tables["sorted_syms"][b], 15)
            sym_of, len_of = R.decode_table(lens, codes, 15)
            stream, starts = R.lane_words_stream(words[b])
            syms, _ = R.decode_streams(stream, starts, -(-n // words.shape[2]), sym_of, len_of, 15)
            out.append(syms.reshape(-1)[:n])
        return np.stack(out)

    @staticmethod
    def _host(tables: dict) -> dict:
        return {k: v.cpu().numpy() for k, v in tables.items()}

    # ---------- the entry points ----------

    def encode_device(self, data: torch.Tensor) -> Coded:
        words, bits, tables = self._encode(data.cpu().numpy()[None])
        return Coded(words[0], bits[0], int(data.shape[0]), self.k, {k: v[0] for k, v in tables.items()})

    def decode_device(self, comp: Coded) -> torch.Tensor:
        tables = {k: v.cpu().numpy()[None] for k, v in comp.tables.items()}
        out = self._decode(comp.words.cpu().numpy().view(np.uint32)[None], tables, comp.raw_size)
        return torch.from_numpy(out[0]).to(self.device)

    def encode_batch(self, blocks: torch.Tensor):
        return self._encode(blocks.cpu().numpy())

    def decode_batch(self, words, bit_counts, tables, n_block, statics=None) -> torch.Tensor:
        out = self._decode(words.cpu().numpy().view(np.uint32), self._host(tables), n_block)
        return torch.from_numpy(out.reshape(out.shape[0], -1, words.shape[2])).to(self.device)

    def serialize(self, comp) -> bytes:
        t = self._host(comp.tables)
        n = int(t["num_syms"])
        table = {"len_count": t["len_count"].astype(np.int64), "ranked": t["sorted_syms"][:n]}
        return R.write_htp3(
            comp.raw_size, comp.k, table, comp.words.cpu().numpy().view(np.uint32),
            comp.bit_counts.cpu().numpy(),
        )

    def compress(self, raw: bytes) -> bytes:
        data = np.frombuffer(raw, np.uint8)
        blobs = []
        for pos in range(0, len(data), self.block_bytes):
            block = data[pos : pos + self.block_bytes]
            blobs.append((len(block), self.serialize(self.encode_device(torch.from_numpy(block.copy())))))
        return R.write_container(blobs, raw, self.block_bytes)

    def decompress(self, blob: bytes) -> bytes:
        return R.read_container(blob)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run a cell with the control in the program's place")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from hbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload, ROOT)
    line, checks = harness.run_cell(
        cell, args.seed, args.seconds, False, codec=ControlCodec(cell.config, "cuda")
    )
    for s in checks:
        print(s, file=sys.stderr)
    print(json.dumps({"control": args.workload, "seed": args.seed, "correct": line["correct"],
                      "attempted": line["attempted"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
