"""The scan drive loop (port of the reference's ``engine.run_scan``, the
plain sequential path).

One full earliest→latest pass: fix the watermarks, stream every batch
through the backend in per-partition offset order, finalize once.  The
backend's ``update`` is asynchronous on CUDA, so packing batch i+1 on the
host overlaps the device folding batch i.
"""

from __future__ import annotations

import dataclasses
import time

from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics


@dataclasses.dataclass
class ScanResult:
    metrics: TopicMetrics
    duration_secs: int
    start_offsets: "dict[int, int]"
    end_offsets: "dict[int, int]"


def run_scan(
    topic: str,
    source: RecordSource,
    backend: TorchBackend,
    batch_size: int,
) -> ScanResult:
    """Full scan of ``topic`` from ``source`` through ``backend``.  The
    source's partition ids are the state's row indices ``0..P-1`` (the
    synthetic source's ids)."""
    start_offsets, end_offsets = source.watermarks()
    t0 = time.monotonic()
    for batch in source.batches(batch_size):
        backend.update(backend.prepare(batch))
    metrics = backend.finalize()
    return ScanResult(
        metrics=metrics,
        duration_secs=int(time.monotonic() - t0),
        start_offsets=start_offsets,
        end_offsets=end_offsets,
    )
