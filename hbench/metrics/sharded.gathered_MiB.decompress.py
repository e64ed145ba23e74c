"""sharded.gathered_MiB.decompress: the MiB that the collectives of one
``ShardedCodec.decompress`` delivered to rank 0 (a tensor collective's
output, an object gather's records; ``huffman_tpu_torch.parallel.sharded.COUNTS``,
over set-up's calls and the window's).  None where the program keeps no
such counter."""


def read(run):
    try:
        from huffman_tpu_torch.parallel import sharded
    except ImportError:
        return None
    c = getattr(sharded, "COUNTS", {}).get("decompress")
    return c["gathered_bytes"] / c["calls"] / 2**20 if c and c["calls"] else None
