"""RecordSource protocol — the ingestion seam (port of the reference's
``io/source.py``).

A source fixes per-partition watermarks at scan start and then yields
`RecordBatch`es covering ``[start, end)`` in per-partition offset order,
for all partitions or a subset, from the start offsets or from given ones.
"""

from __future__ import annotations

import abc
from typing import Dict, Iterator, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.records import RecordBatch


class RecordSource(abc.ABC):
    @abc.abstractmethod
    def partitions(self) -> List[int]:
        """Sorted partition ids."""

    @abc.abstractmethod
    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(start_offsets, end_offsets) snapshot: the scan covers exactly
        [start, end) per partition."""

    @abc.abstractmethod
    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: Optional[Dict[int, int]] = None,
    ) -> Iterator[RecordBatch]:
        """Yield unpadded batches covering [start, end) of the given
        partitions (all by default), per-partition offset order.
        ``start_at`` overrides the start offsets of the partitions it
        names."""

    #: True for sources whose ``batches`` takes ``sink=`` and can feed a
    #: `packing.FusedPackSink` instead of yielding decoded batches.
    supports_fused_sink = False

    def refresh_watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """Re-poll the end watermarks and return the fresh
        (start_offsets, end_offsets) — the follow-mode tail contract
        (serve/follow.py): each poll widens the scan target to the moving
        head.  Static sources (synthetic, segment files) have nothing to
        refresh, so the default returns the fixed snapshot; the live wire
        source re-queries the brokers through its retry/backoff budget and,
        when the budget is exhausted, keeps the previous snapshot instead
        of failing the service (io/kafka_wire.py)."""
        return self.watermarks()

    def partition_record_counts(self) -> "Dict[int, int] | None":
        """Records per partition when the source knows them up front
        (segment catalogs), else None."""
        return None

    def total_records(self) -> int:
        start, end = self.watermarks()
        return sum(end[p] - start[p] for p in end)

    def is_empty(self) -> bool:
        """True when every end offset is 0 — the reference exits ``-2``."""
        _, end = self.watermarks()
        return all(v == 0 for v in end.values())
