"""Multi-GPU parallelism: the rank mesh and the sharded block codec, over
``torch.distributed``.

Counterpart: ``huffman_tpu/parallel/``.  Submodules are loaded lazily,
and importing them starts no process group and does not initialize CUDA:
`distributed.initialize()` decides when the group starts.
"""


def __getattr__(name):
    if name in ("ShardedCodec", "make_mesh", "sharded_roundtrip",
                "sharded_encode", "sharded_decode"):
        from . import sharded

        return getattr(sharded, name)
    if name in ("distributed", "sharded"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'huffman_tpu_torch.parallel' has no attribute {name!r}")


__all__ = [
    "ShardedCodec",
    "make_mesh",
    "sharded_roundtrip",
    "sharded_encode",
    "sharded_decode",
    "distributed",
]
