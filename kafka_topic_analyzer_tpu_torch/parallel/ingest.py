"""Staging of ingest items on the producing thread (port of the
reference's ``parallel/ingest.py``, its single-stream adapter;
``ParallelIngest`` is not yet ported)."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

from kafka_topic_analyzer_tpu_torch.packing import PackedRow
from kafka_topic_analyzer_tpu_torch.records import RecordBatch


def iter_staged(
    it: "Iterator[RecordBatch | PackedRow]",
    stage: "Callable[[RecordBatch], object]",
) -> "Iterator[Tuple[RecordBatch | PackedRow, object]]":
    """``(item, staged)`` pairs, staged on the thread that iterates: a
    `RecordBatch` goes through ``stage``; a `PackedRow` arrives staged by
    its sink."""
    for b in it:
        if isinstance(b, PackedRow):
            yield b, b.staged
        else:
            yield b, stage(b)
