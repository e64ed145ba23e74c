"""sharded.collectives.compress: the torch.distributed calls that one
``ShardedCodec.compress`` made on rank 0 (each all_reduce, all_gather and
all_gather_object; ``huffman_tpu_torch.parallel.sharded.COUNTS``, over
set-up's calls and the window's).  None where the program keeps no such
counter."""


def read(run):
    try:
        from huffman_tpu_torch.parallel import sharded
    except ImportError:
        return None
    c = getattr(sharded, "COUNTS", {}).get("compress")
    return c["collectives"] / c["calls"] if c and c["calls"] else None
