"""Finalized analysis results and the reference's derived-metric semantics
(port of the reference's ``results.py``: `TopicMetrics`,
`QuantileSummary`, `finalize_extremes`).

The derived metrics reproduce ``src/metric.rs`` of xenji's
kafka-topic-analyzer exactly, quirks included (documented per method).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: Column order of the per-partition counter matrix ``per_partition[P, 7]``.
COUNTER_CHANNELS = (
    "total",
    "tombstones",
    "alive",
    "key_null",
    "key_non_null",
    "key_size_sum",
    "value_size_sum",
)
CH = {name: i for i, name in enumerate(COUNTER_CHANNELS)}

#: Rust's ``u64::MAX`` initialisation of smallest_message — reported as 0
#: when never set.
U64_MAX = (1 << 64) - 1

#: The quantiles every backend reports.
QUANTILE_PROBS = (0.5, 0.9, 0.99)

I64_MAX_NP = np.iinfo(np.int64).max
I64_MIN_NP = np.iinfo(np.int64).min


def _avg(size_sum: int, alive: int) -> int:
    """Floor(sum/alive) — the reference divides by *alive* and guards on
    ``sum > 0``; a partition of keyed tombstones only (sum > 0, alive 0)
    reports 0 instead of the reference's divide-by-zero panic."""
    return size_sum // alive if size_sum > 0 and alive > 0 else 0


@dataclasses.dataclass
class QuantileSummary:
    """Message-size quantiles (not in the reference)."""

    probs: "list[float]"
    values: "list[float]"


@dataclasses.dataclass
class TopicMetrics:
    """Finalized topic metrics.  ``per_partition`` rows follow
    ``partitions``; channels follow `COUNTER_CHANNELS`."""

    partitions: "list[int]"
    per_partition: np.ndarray  # int64[P, 7]
    earliest_ts_s: int
    latest_ts_s: int
    smallest_message: int  # U64_MAX when no sized message was seen
    largest_message: int
    overall_size: int
    overall_count: int
    #: Alive-key count from the reference-compatible fnv32 bitmap (``-c``).
    alive_keys: Optional[int] = None
    #: HLL estimate of distinct keys ever seen.
    distinct_keys_hll: Optional[float] = None
    #: Per-partition HLL estimates, one per `partitions` row.
    distinct_keys_hll_per_partition: "Optional[list[float]]" = None
    #: Message-size quantiles.
    quantiles: Optional[QuantileSummary] = None
    #: Per-partition size quantiles, one per `partitions` row.
    quantiles_per_partition: "Optional[list[QuantileSummary]]" = None
    #: int64[P, 4] (earliest_ts, latest_ts, smallest, largest) with raw
    #: sentinels where a partition never saw a record.
    per_partition_extremes: Optional[np.ndarray] = None
    #: Scan-start time used for the reference's earliest-message fallback.
    init_now_s: Optional[int] = None

    def _row(self, partition: int) -> np.ndarray:
        return self.per_partition[self.partitions.index(partition)]

    def total(self, p: int) -> int:
        return int(self._row(p)[CH["total"]])

    def tombstones(self, p: int) -> int:
        return int(self._row(p)[CH["tombstones"]])

    def alive(self, p: int) -> int:
        return int(self._row(p)[CH["alive"]])

    def key_null(self, p: int) -> int:
        return int(self._row(p)[CH["key_null"]])

    def key_non_null(self, p: int) -> int:
        return int(self._row(p)[CH["key_non_null"]])

    def key_size_sum(self, p: int) -> int:
        return int(self._row(p)[CH["key_size_sum"]])

    def value_size_sum(self, p: int) -> int:
        return int(self._row(p)[CH["value_size_sum"]])

    def key_size_avg(self, p: int) -> int:
        return _avg(self.key_size_sum(p), self.alive(p))

    def value_size_avg(self, p: int) -> int:
        return _avg(self.value_size_sum(p), self.alive(p))

    def message_size_avg(self, p: int) -> int:
        return _avg(self.key_size_sum(p) + self.value_size_sum(p), self.alive(p))

    def dirty_ratio(self, p: int) -> float:
        """Percentage of tombstones, in float32 exactly like
        ``tombstones as f32 / (total as f32 / 100.0)``."""
        total = self.total(p)
        tomb = self.tombstones(p)
        if total > 0 and tomb > 0:
            return float(np.float32(tomb) / (np.float32(total) / np.float32(100.0)))
        return 0.0

    def smallest_message_reported(self) -> int:
        """0 when never set."""
        return 0 if self.smallest_message == U64_MAX else self.smallest_message


def finalize_extremes(
    earliest_raw: int, latest_raw: int, smallest_raw: int, init_now_s: int
) -> "tuple[int, int, int]":
    """Map sentinel-initialized extremes to the reference's reporting
    values: earliest starts at scan-start time and latest at epoch 0, so
    the reported earliest is ``min(now, min_ts)`` and latest
    ``max(0, max_ts)``; smallest keeps u64::MAX until set."""
    earliest = (
        min(init_now_s, earliest_raw) if earliest_raw != I64_MAX_NP else init_now_s
    )
    latest = max(0, latest_raw) if latest_raw != I64_MIN_NP else 0
    smallest = U64_MAX if smallest_raw == I64_MAX_NP else smallest_raw
    return earliest, latest, smallest
