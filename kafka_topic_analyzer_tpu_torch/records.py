"""Structure-of-arrays record batches — the host-side data contract
(port of the reference's ``records.py``).

A source pre-extracts exactly what the reducers need (lengths, null-ness,
timestamps, key hashes) into fixed-width numpy columns; one `RecordBatch`
is the unit the packer turns into a wire row.  Within a partition records
appear in offset order, and valid records form a prefix of the batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecordBatch:
    """One batch of pre-extracted record metadata (host-side numpy).

    All arrays share length ``B``.  Padded records have ``valid=False``.
    """

    #: Partition id of each record (int32).
    partition: np.ndarray
    #: Key length in bytes; 0 when the key is null (int32).
    key_len: np.ndarray
    #: Value length in bytes; 0 when the value is null / tombstone (int32).
    value_len: np.ndarray
    #: True where the record has no key (bool).
    key_null: np.ndarray
    #: True where the record has no value — a tombstone (bool).
    value_null: np.ndarray
    #: Message timestamp in seconds (int64); missing timestamps are 0.
    ts_s: np.ndarray
    #: Bug-compatible fnv32 hash of the key bytes (uint32); 0 for null keys.
    key_hash32: np.ndarray
    #: 64-bit FNV-1a key hash (uint64); feeds HLL.
    key_hash64: np.ndarray
    #: False for padding records.
    valid: np.ndarray

    FIELDS = (
        ("partition", np.int32),
        ("key_len", np.int32),
        ("value_len", np.int32),
        ("key_null", np.bool_),
        ("value_null", np.bool_),
        ("ts_s", np.int64),
        ("key_hash32", np.uint32),
        ("key_hash64", np.uint64),
        ("valid", np.bool_),
    )

    def __post_init__(self) -> None:
        n = len(self.partition)
        for name, dtype in self.FIELDS:
            arr = np.asarray(getattr(self, name))
            if arr.dtype != dtype:
                arr = arr.astype(dtype)
            if arr.shape != (n,):
                raise ValueError(f"{name}: expected shape ({n},), got {arr.shape}")
            setattr(self, name, arr)

    def __len__(self) -> int:
        return len(self.partition)

    @property
    def num_valid(self) -> int:
        return int(np.count_nonzero(self.valid))

    def as_dict(self) -> "dict[str, np.ndarray]":
        return {name: getattr(self, name) for name, _ in self.FIELDS}
