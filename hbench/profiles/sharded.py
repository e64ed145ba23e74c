"""The ``sharded`` profile: ``ShardedCodec`` over the configuration's
``mesh`` of ranks (``data`` x ``stream``), at its lanes and block size,
on the process group that `ranks.join` brought up.  Its containers are
the tpu profile's HTPC containers with exact-count tables
(``table_sample: null``), so the check (`check`, `reference`) and the
least bytes a request moves (`peaks`) are the tpu profile's."""

from hbench.check import Tally  # noqa: F401
from hbench.peaks import compress_bytes, decompress_bytes  # noqa: F401


def make_codec(config: dict, device):
    import torch.distributed as dist

    from huffman_tpu_torch.parallel import ShardedCodec, distributed

    mesh = config["mesh"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh["data"] * mesh["stream"]:
        raise ValueError(f"the mesh data {mesh['data']} x stream {mesh['stream']} "
                         f"needs {mesh['data'] * mesh['stream']} ranks, not {world}")
    return ShardedCodec(distributed.pod_mesh(stream=mesh["stream"]), config["block_bytes"],
                        config["lanes"], device=device)
