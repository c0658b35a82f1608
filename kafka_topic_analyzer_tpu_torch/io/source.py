"""RecordSource protocol — the ingestion seam (port of the reference's
``io/source.py``, the batch-scan subset).

A source fixes per-partition watermarks at scan start and then yields
`RecordBatch`es covering ``[start, end)`` in per-partition offset order.
"""

from __future__ import annotations

import abc
from typing import Dict, Iterator, List, Tuple

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
    def batches(self, batch_size: int) -> Iterator[RecordBatch]:
        """Yield unpadded batches covering [start, end) of every
        partition, per-partition offset order."""

    def total_records(self) -> int:
        start, end = self.watermarks()
        return sum(end[p] - start[p] for p in end)

    def is_empty(self) -> bool:
        """True when every end offset is 0 — the reference exits ``-2``."""
        _, end = self.watermarks()
        return all(v == 0 for v in end.values())
