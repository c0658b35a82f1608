"""The scan drive loop (port of the reference's ``engine.run_scan``, its
single-device, single-stream path).

One full earliest→latest pass: fix the watermarks, stream every batch
through the backend in per-partition offset order, finalize once.

Items are produced and staged on a prefetch worker (``prefetch_depth``
items ahead; 0 runs everything on the calling thread): the source's batch
is packed into a pinned slot and its copy to the device started there, so
the main thread only dispatches folds.  When the source can feed a fused
sink and the backend packs natively with the shim loaded, the source
appends its columns straight into packed rows (`packing.FusedPackSink`,
from the backend) and no decoded batch exists at all; otherwise the
chained path decodes batches and packs them.  Both give the same rows up
to where the batches are cut, and the same report.

Partition ids need not be dense: `PartitionIndex` maps the source's ids to
state rows and the report prints the true ids.

A Kafka wire source may drop partitions (degraded), skip poisoned frames
(corrupt) or see the log move under it (lost): the result carries what
the source booked, for the report's warning blocks and the exit code.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.packing import fused_ingest_enabled
from kafka_topic_analyzer_tpu_torch.parallel.ingest import iter_staged
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics
from kafka_topic_analyzer_tpu_torch.utils.prefetch import prefetch


class PartitionIndex:
    """Bidirectional map between true partition ids and dense row indices."""

    def __init__(self, partition_ids: "list[int]"):
        self.ids = sorted(partition_ids)
        self._sorted = np.array(self.ids, dtype=np.int64)
        #: Dense ids make the remap a no-op.
        self.is_dense = self.ids == list(range(len(self.ids)))
        self.dense_of = {p: i for i, p in enumerate(self.ids)}.__getitem__

    def __len__(self) -> int:
        return len(self.ids)

    def to_dense(self, partition: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._sorted, partition).astype(np.int32)

    def dense_batch(self, batch: RecordBatch) -> RecordBatch:
        """The batch with dense partition ids: itself when ids are dense,
        else a shallow copy (the caller's batch keeps its true ids)."""
        if self.is_dense:
            return batch
        return dataclasses.replace(batch, partition=self.to_dense(batch.partition))


@dataclasses.dataclass
class ScanResult:
    metrics: TopicMetrics
    duration_secs: int
    start_offsets: "dict[int, int]"
    end_offsets: "dict[int, int]"
    #: Records folded.
    records: int = 0
    #: True when the rows came from a fused sink.
    fused: bool = False
    #: The fused sink's records appended as decoded batches, by reason
    #: (`packing.FusedPackSink.fallbacks`); empty on the chained path.
    fallbacks: "dict[str, int]" = dataclasses.field(default_factory=dict)
    #: partition -> reason, for partitions the source dropped after their
    #: retry budget ran out: the metrics undercount their tails.
    degraded_partitions: "dict[int, str]" = dataclasses.field(default_factory=dict)
    #: partition -> {"frames", "records", "bytes", "quarantined", "kinds",
    #: "spans"} for poisoned frames skipped under ``--on-corruption``: the
    #: metrics exclude exactly their records.
    corrupt_partitions: "dict[int, dict]" = dataclasses.field(default_factory=dict)
    #: partition -> {"records", "ranges", "reasons", "authoritative",
    #: "spans"} for offset ranges the log took back during the scan: the
    #: metrics cover the surviving records.
    lost_partitions: "dict[int, dict]" = dataclasses.field(default_factory=dict)


def fused_gate(source: RecordSource, backend: TorchBackend) -> bool:
    """Fused rows need all three: a source whose ``batches`` feeds a
    sink, native packing asked for, and the shim loaded."""
    return source.supports_fused_sink and backend.use_native and fused_ingest_enabled()


def run_scan(
    topic: str,
    source: RecordSource,
    backend: TorchBackend,
    batch_size: int,
    prefetch_depth: int = 2,
    start_at: "dict[int, int] | None" = None,
) -> ScanResult:
    """Full scan of ``topic`` from ``source`` through ``backend``;
    ``start_at`` starts the partitions it names at those offsets (the
    report keeps the source's watermarks)."""
    pindex = PartitionIndex(source.partitions())
    if len(pindex) != backend.config.num_partitions:
        raise ValueError(
            f"source has {len(pindex)} partitions, the backend's config "
            f"{backend.config.num_partitions}"
        )
    start_offsets, end_offsets = source.watermarks()
    fused = fused_gate(source, backend)
    sink = {"sink": backend.make_fused_sink(pindex.dense_of)} if fused else {}
    t0 = time.monotonic()
    records = 0
    items = prefetch(
        iter_staged(
            source.batches(batch_size, start_at=start_at, **sink),
            lambda b: backend.prepare(pindex.dense_batch(b)),
        ),
        prefetch_depth,
    )
    try:
        for item, staged in items:
            # A PackedRow arrives staged by its sink, a batch by `prepare`.
            records += item.num_valid
            backend.update(staged)
    finally:
        if hasattr(items, "close"):
            items.close()
    metrics = backend.finalize()
    metrics.partitions = pindex.ids
    return ScanResult(
        metrics=metrics,
        duration_secs=int(time.monotonic() - t0),
        start_offsets=start_offsets,
        end_offsets=end_offsets,
        records=records,
        fused=fused,
        fallbacks=dict(sink["sink"].fallbacks) if fused else {},
        degraded_partitions=_booked(source, "degraded_partitions"),
        corrupt_partitions=_booked(source, "corruption_stats"),
        lost_partitions=_booked(source, "loss_stats"),
    )


def _booked(source: RecordSource, method: str) -> dict:
    """What a source that books scan issues (the Kafka wire source, or a
    tee of it) reports through ``method``; empty for other sources."""
    fn = getattr(source, method, None)
    return dict(fn()) if fn is not None else {}
