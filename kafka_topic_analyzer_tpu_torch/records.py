"""Structure-of-arrays record batches — the host-side data contract
(port of the reference's ``records.py``).

A source pre-extracts exactly what the reducers need (lengths, null-ness,
timestamps, key hashes) into fixed-width numpy columns; one `RecordBatch`
is the unit the packer turns into a wire row.  Within a partition records
appear in offset order, and valid records form a prefix of the batch.
Sources whose offsets have gaps (a compacted segment dump) attach the
optional host-only ``offsets`` column; it never crosses to the device.
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
    #: Optional host-only per-record Kafka offsets (int64); None for
    #: gapless sources, whose progress is tracked by counting.
    offsets: "np.ndarray | None" = None

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
        if self.offsets is not None:
            self.offsets = np.asarray(self.offsets, dtype=np.int64)
            if self.offsets.shape != (n,):
                raise ValueError("offsets: wrong shape")

    def __len__(self) -> int:
        return len(self.partition)

    @property
    def num_valid(self) -> int:
        return int(np.count_nonzero(self.valid))

    @classmethod
    def empty(cls, n: int = 0) -> "RecordBatch":
        return cls(**{name: np.zeros(n, dtype=dt) for name, dt in cls.FIELDS})

    def _map(self, fn) -> "RecordBatch":
        """A batch of ``fn(column)`` for every column, offsets included."""
        out = RecordBatch(**{name: fn(getattr(self, name)) for name, _ in self.FIELDS})
        if self.offsets is not None:
            out.offsets = fn(self.offsets)
        return out

    @classmethod
    def concat(cls, batches: "list[RecordBatch]") -> "RecordBatch":
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]
        out = cls(**{
            name: np.concatenate([getattr(b, name) for b in batches])
            for name, _ in cls.FIELDS
        })
        if all(b.offsets is not None for b in batches):
            out.offsets = np.concatenate([b.offsets for b in batches])
        return out

    def take(self, idx: np.ndarray) -> "RecordBatch":
        """Rows ``idx`` (an index array), copied."""
        return self._map(lambda a: a[idx])

    def slice(self, lo: int, hi: int) -> "RecordBatch":
        """Zero-copy view of rows ``[lo, hi)``."""
        return self._map(lambda a: a[lo:hi])

    @classmethod
    def resplit(
        cls, pend: "list[RecordBatch]", batch_size: int, force: bool
    ) -> "tuple[list[RecordBatch], list[RecordBatch], int]":
        """Re-batch accumulated chunks to ``batch_size``: one concat, then
        zero-copy slices, and (with ``force``) the short tail as a last
        batch.  Returns ``(full_batches, remainder_list,
        remainder_count)``.  The remainder alone is copied out, so it does
        not pin the concatenated buffer across flushes."""
        full = cls.concat(pend)
        out = []
        lo = 0
        while len(full) - lo >= batch_size or (force and lo < len(full)):
            hi = min(lo + batch_size, len(full))
            out.append(full.slice(lo, hi))
            lo = hi
        rest = full.slice(lo, len(full)).copy()
        return out, ([rest] if len(rest) else []), len(rest)

    def copy(self) -> "RecordBatch":
        """Deep copy of every column (detaches views of a file mapping)."""
        return self._map(np.copy)

    def as_dict(self) -> "dict[str, np.ndarray]":
        return {name: getattr(self, name) for name, _ in self.FIELDS}

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, name).nbytes for name, _ in self.FIELDS)
