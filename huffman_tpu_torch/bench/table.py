"""Render benchmark results as the reference's README-style markdown
tables (make_table.py:58-67 format parity).  A copy of
``huffman_tpu/bench/table.py``."""

from __future__ import annotations


def _mibs(bps: float) -> str:
    return f"{int(bps / (1 << 20))} MiB/s"


def render_markdown(results: dict) -> str:
    out = []
    for wname, blk in results.items():
        out.append(f"## {wname} ({blk['bytes']} bytes)\n")
        out.append("Method | Streams | Compress | Decompress | Ratio")
        out.append("-------|---------|----------|------------|------")
        for r in blk["rows"]:
            flag = "" if r.get("roundtrip_ok", True) else "  **(MISMATCH!)**"
            out.append(
                f"{r['method']} | {r['streams']} | {_mibs(r['compress_bps'])} | "
                f"{_mibs(r['decompress_bps'])} | {r['ratio']:.3f}{flag}"
            )
        out.append("")
    return "\n".join(out)
