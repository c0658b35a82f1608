"""Deterministic synthetic topic generator (port of the reference's
``io/synthetic.py``; records are bit-identical for the same spec).

Every field of record ``(partition p, offset o)`` derives from
``x = splitmix64(splitmix64(seed ^ (p << 40)) + o * GAMMA)``: pure integer
bit-fiddling, order-independent and vectorized in numpy.  Keys are
fixed-width decimal strings ``k%0*d`` of a per-partition disjoint key id
(``key_id = p + P * local``), so a key lives in exactly one partition.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.ops.fnv import (
    fnv1a32_ref_batch,
    fnv1a64_batch,
    splitmix64_np,
)
from kafka_topic_analyzer_tpu_torch.records import RecordBatch


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_partitions: int = 1
    messages_per_partition: int = 1_000_000
    #: Distinct keys *per partition* (key ids are partition-disjoint).
    keys_per_partition: int = 10_000
    #: Per-mille of records with a null key.
    key_null_permille: int = 50
    #: Per-mille of records with a null value (tombstones).
    tombstone_permille: int = 100
    value_len_min: int = 100
    #: The value-length draw uses 24 bits of the record hash, so the
    #: effective spread (value_len_max - value_len_min + 1) caps at 2^24.
    value_len_max: int = 400
    #: Fixed decimal width of the key id inside the key string "k%0*d".
    key_digits: int = 11
    ts_start_ms: int = 1_600_000_000_000
    ts_step_ms: int = 1
    seed: int = 0x5EED

    @property
    def key_len(self) -> int:
        return 1 + self.key_digits

    #: --synthetic key → expected-form hint (doubles as the valid-key set).
    KV_KEYS = {
        "partitions": "a positive integer partition count",
        "messages": "a non-negative integer message count per partition",
        "keys": "a positive integer distinct-key count per partition",
        "key_null": "an integer per-mille in 0..1000 (e.g. 50 = 5%)",
        "tombstones": "an integer per-mille in 0..1000 (e.g. 100 = 10%)",
        "vmin": "a non-negative integer minimum value length in bytes",
        "vmax": "an integer maximum value length in bytes, >= vmin",
        "seed": "an integer (0x… hex accepted)",
    }

    @classmethod
    def from_kv(cls, kv: "dict[str, str]") -> "SyntheticSpec":
        """Build a spec from the CLI's comma-separated k=v surface; every
        rejection names the offending key and the expected form."""
        for key in kv:
            if key and key not in cls.KV_KEYS:  # "" = trailing comma, ignore
                raise ValueError(
                    f"unknown --synthetic key '{key}': valid keys are "
                    + ", ".join(sorted(cls.KV_KEYS))
                )

        def geti(
            key: str, default: int, base: int = 10,
            lo: "int | None" = None, hi: "int | None" = None,
        ) -> int:
            raw = kv.get(key)
            if raw is None:
                return default
            try:
                val = int(raw, base)
            except ValueError:
                val = None
            if val is None or (lo is not None and val < lo) or (
                hi is not None and val > hi
            ):
                raise ValueError(
                    f"bad --synthetic key '{key}': expected "
                    f"{cls.KV_KEYS[key]}, got '{raw}'"
                )
            return val

        vmin = geti("vmin", 100, lo=0)
        # Default vmax tracks a raised vmin.
        vmax = geti("vmax", max(400, vmin), lo=vmin)
        return cls(
            num_partitions=geti("partitions", 1, lo=1),
            messages_per_partition=geti("messages", 1_000_000, lo=0),
            keys_per_partition=geti("keys", 10_000, lo=1),
            key_null_permille=geti("key_null", 50, lo=0, hi=1000),
            tombstone_permille=geti("tombstones", 100, lo=0, hi=1000),
            value_len_min=vmin,
            value_len_max=vmax,
            seed=geti("seed", 0x5EED, base=0),
        )


def synth_fields(
    spec: SyntheticSpec, partition: np.ndarray, offset: np.ndarray
) -> Dict[str, np.ndarray]:
    """Vectorized field derivation for records (partition[i], offset[i]).
    The bit-field layout below is the generator's contract."""
    p64 = partition.astype(np.uint64)
    o64 = offset.astype(np.uint64)
    # The stream base depends only on the partition: mix once per distinct
    # partition, then gather.
    parts_u, inv = np.unique(p64, return_inverse=True)
    bases = splitmix64_np(np.uint64(spec.seed) ^ (parts_u << np.uint64(40)))
    with np.errstate(over="ignore"):
        x = splitmix64_np(bases[inv] + o64 * np.uint64(0x9E3779B97F4A7C15))

    key_null = (x % np.uint64(1000)).astype(np.int64) < spec.key_null_permille
    value_null = (
        ((x >> np.uint64(10)) % np.uint64(1000)).astype(np.int64)
        < spec.tombstone_permille
    )
    local = ((x >> np.uint64(20)) % np.uint64(spec.keys_per_partition)).astype(
        np.uint64
    )
    key_id = p64 + np.uint64(spec.num_partitions) * local
    vspread = np.uint64(spec.value_len_max - spec.value_len_min + 1)
    value_len = (
        spec.value_len_min + ((x >> np.uint64(40)) % vspread).astype(np.int64)
    ).astype(np.int32)
    value_len = np.where(value_null, 0, value_len).astype(np.int32)

    ts_ms = np.int64(spec.ts_start_ms) + offset.astype(np.int64) * np.int64(
        spec.ts_step_ms
    )
    ts_s = ts_ms // 1000  # second granularity

    # Key bytes: b"k" + fixed-width decimal of key_id.
    n = partition.shape[0]
    padded = np.zeros((n, spec.key_len), dtype=np.uint8)
    padded[:, 0] = ord("k")
    rem = key_id.copy()
    for d in range(spec.key_digits - 1, -1, -1):
        padded[:, 1 + d] = (rem % np.uint64(10)).astype(np.uint8) + ord("0")
        rem //= np.uint64(10)
    lengths = np.full(n, spec.key_len, dtype=np.int64)
    h32 = fnv1a32_ref_batch(padded, lengths)
    h64 = fnv1a64_batch(padded, lengths)

    key_len = np.where(key_null, 0, spec.key_len).astype(np.int32)
    h32 = np.where(key_null, np.uint32(0), h32)
    h64 = np.where(key_null, np.uint64(0), h64)

    return {
        "partition": partition.astype(np.int32),
        "key_len": key_len,
        "value_len": value_len,
        "key_null": key_null,
        "value_null": value_null,
        "ts_s": ts_s,
        "key_hash32": h32,
        "key_hash64": h64,
        "valid": np.ones(n, dtype=np.bool_),
    }


class SyntheticSource(RecordSource):
    """Round-robin multiplex of the partitions, like a balanced consumer:
    global index ``g`` maps to partition ``S[g % |S|]`` at offset
    ``g // |S|`` — per-partition offset order by construction."""

    def __init__(self, spec: SyntheticSpec):
        self.spec = spec

    def partitions(self) -> List[int]:
        return list(range(self.spec.num_partitions))

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        start = {p: 0 for p in self.partitions()}
        end = {p: self.spec.messages_per_partition for p in self.partitions()}
        return start, end

    def batches(self, batch_size: int) -> Iterator[RecordBatch]:
        parts = np.array(self.partitions(), dtype=np.int64)
        s = len(parts)
        total = self.spec.messages_per_partition * s
        for lo in range(0, total, batch_size):
            g = np.arange(lo, min(lo + batch_size, total), dtype=np.int64)
            yield RecordBatch(**synth_fields(self.spec, parts[g % s], g // s))
