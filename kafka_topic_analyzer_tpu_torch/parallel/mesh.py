"""Partition placement (port of one function of the reference's
``parallel/mesh.py``: the round-robin rule its data shards and the
parallel-ingest workers share; the mesh itself is not ported)."""

from __future__ import annotations

from typing import List


def assign_partitions(partitions: List[int], data_shards: int) -> List[List[int]]:
    """Round-robin partitions over data shards (shard d gets partitions[d::D]).

    Any partition→shard assignment is correct (states merge associatively);
    round-robin balances retained-message skew reasonably without needing
    per-partition sizes up front.
    """
    parts = sorted(partitions)
    return [parts[d::data_shards] for d in range(data_shards)]
