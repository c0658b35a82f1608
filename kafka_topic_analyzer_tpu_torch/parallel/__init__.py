"""Ingest staging, partition-sharded parallel ingest and the device
mesh, with one controller or several (port of the reference's
``parallel`` package).  ``make_mesh`` and ``ShardedTorchBackend`` load on first use,
so that a scan which never builds a mesh (the numpy oracle's) imports no
torch backend."""


def __getattr__(name: str):
    if name == "make_mesh":
        from kafka_topic_analyzer_tpu_torch.parallel.mesh import make_mesh

        return make_mesh
    if name == "ShardedTorchBackend":
        from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend

        return ShardedTorchBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ShardedTorchBackend", "make_mesh"]
