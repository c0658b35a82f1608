"""The scan drive loop (port of the reference's ``engine.run_scan``, its
single-device, single-stream path at superbatch K = 1).

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
to where the batches are cut, and the same report.  The numpy oracle
(`backends.cpu.CpuExactBackend`) packs no rows (`MetricBackend.packs_rows`):
its ``prepare`` is the identity and it folds the decoded batches on the
main thread.

Every wall second of the loop is booked in one `utils.profiling.
ScanProfile` stage: ``ingest`` (waiting on the prefetch queue for the next
item), ``dispatch`` (the backend's dispatch-queue throttle, then its
``update``) and ``finalize``; the scan counters, wire and fused bookings,
per-partition lag/ETA gauges and the lifecycle events go to the default
telemetry registry and event bus (``obs``), which cost nothing until a
sink or exporter reads them.

Partition ids need not be dense: `PartitionIndex` maps the source's ids to
state rows and the report prints the true ids.

A Kafka wire source may drop partitions (degraded), skip poisoned frames
(corrupt) or see the log move under it (lost): the result carries what
the source booked, for the report's warning blocks and the exit code.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Optional

import numpy as np

from kafka_topic_analyzer_tpu_torch.backends.base import MetricBackend
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.packing import PackedRow, fused_ingest_enabled
from kafka_topic_analyzer_tpu_torch.parallel.ingest import iter_staged
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics, WireStats
from kafka_topic_analyzer_tpu_torch.utils.prefetch import prefetch
from kafka_topic_analyzer_tpu_torch.utils.profiling import ScanProfile
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner
from kafka_topic_analyzer_tpu_torch.utils.timefmt import format_utc_seconds

#: Seconds between two refreshes of the lag/ETA gauges and heartbeat events.
HEARTBEAT_EVERY_S = 10.0

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
    #: Registry snapshot taken at scan end (obs.registry format): what
    #: ``--stats`` renders and the scan doctor attributes from.
    telemetry: "Optional[dict]" = None
    #: Ingest streams the scan ran (1: parallel ingest is not ported).
    ingest_workers: int = 1
    #: Bound on in-flight dispatches (``--dispatch-depth``; 1 for the
    #: oracle, which dispatches nothing).
    dispatch_depth: int = 1
    #: Packed wire accounting (`results.WireStats`); None for the oracle.
    wire: Optional[WireStats] = None


def _accepts_sink(source: RecordSource) -> bool:
    """Whether ``source.batches`` takes a ``sink=`` (a wrapper that
    forwards the capability flag may have dropped the parameter)."""
    try:
        return "sink" in inspect.signature(source.batches).parameters
    except (TypeError, ValueError):
        return False


def fused_gate(source: RecordSource, backend: MetricBackend) -> bool:
    """Fused rows need all four: a backend that packs rows, a source whose
    ``batches`` feeds a sink, native packing in use, and the shim loaded
    (with ``KTA_DISABLE_FUSED`` unset)."""
    return (
        backend.packs_rows
        and getattr(source, "supports_fused_sink", False)
        and _accepts_sink(source)
        and backend.use_native
        and fused_ingest_enabled()
    )


def _book_fused_bypass(source: RecordSource, backend: MetricBackend) -> None:
    """Book why a fused-capable source on a fused-capable backend runs
    the chained path (``kta_fused_fallback_total``) — never silent."""
    if not _accepts_sink(source):
        reason = "source-unfusable"
    elif not backend.native_requested:
        reason = "native-off"
    else:
        from kafka_topic_analyzer_tpu_torch.io.native import native_status

        ok, why = native_status()
        reason = "fused-disabled" if ok else f"native-{why}"
    obs_metrics.FUSED_FALLBACK.labels(reason=reason).inc()


def _wire_stats(config) -> WireStats:
    """The wire accounting of a packed backend's config, with the v4 and
    compaction-off bypasses booked once per scan."""
    from kafka_topic_analyzer_tpu_torch.packing import section_byte_split

    per_rec, table = section_byte_split(config, config.batch_size)
    stats = WireStats(
        format=config.wire_format,
        batch_size=config.batch_size,
        per_record_bytes=per_rec,
        table_bytes=table,
        alive_compaction=(
            "on"
            if config.compact_alive
            else (
                f"off ({config.alive_compaction_off_reason})"
                if config.count_alive_keys
                else "n/a"
            )
        ),
    )
    if config.wire_v4_reason is not None:
        obs_metrics.WIRE_V4_FALLBACK.labels(reason=config.wire_v4_reason).inc()
    if config.alive_compaction_off_reason is not None:
        obs_metrics.ALIVE_COMPACTION_OFF.labels(
            reason=config.alive_compaction_off_reason
        ).inc()
    return stats


def run_scan(
    topic: str,
    source: RecordSource,
    backend: MetricBackend,
    batch_size: int,
    prefetch_depth: int = 2,
    start_at: "dict[int, int] | None" = None,
    spinner: Optional[Spinner] = None,
) -> ScanResult:
    """Full scan of ``topic`` from ``source`` through ``backend``;
    ``start_at`` starts the partitions it names at those offsets (the
    report keeps the source's watermarks).  The session's active
    `obs.trace.SpanTracer`, if any, mirrors every stage window into a
    Chrome trace."""
    pindex = PartitionIndex(source.partitions())
    if len(pindex) != backend.config.num_partitions:
        raise ValueError(
            f"source has {len(pindex)} partitions, the backend's config "
            f"{backend.config.num_partitions}"
        )
    start_offsets, end_offsets = source.watermarks()
    profile = ScanProfile(tracer=obs_trace.active())
    spinner = spinner or Spinner(enabled=False)
    heartbeat = obs_events.Heartbeat(HEARTBEAT_EVERY_S)
    t0 = time.monotonic()
    obs_events.emit(
        "scan_start", topic=topic, partitions=len(pindex), batch_size=batch_size
    )
    # Per-partition progress for the lag/ETA gauges: one past the last
    # offset seen where the source carries offsets, else a record count.
    next_offsets = dict(start_offsets)
    if start_at:
        next_offsets.update(start_at)
    records = 0

    def maybe_heartbeat() -> None:
        """Rate-limited telemetry refresh: per-partition lag/ETA gauges +
        one heartbeat event, at most once per interval."""
        if not heartbeat.ready():
            return
        elapsed = time.monotonic() - t0
        rate = records / elapsed if elapsed > 0 else 0.0
        lag_total = 0
        for p, end in end_offsets.items():
            lag = max(0, end - next_offsets.get(p, start_offsets[p]))
            lag_total += lag
            obs_metrics.PARTITION_LAG.labels(partition=p).set(lag)
            obs_metrics.PARTITION_ETA_SECONDS.labels(partition=p).set(
                lag / rate if rate > 0 else -1.0
            )
        obs_events.emit(
            "heartbeat",
            seq=records,
            records_per_sec=round(rate, 1),
            lag_total=lag_total,
        )

    fused = fused_gate(source, backend)
    if (
        not fused
        and backend.packs_rows
        and getattr(source, "supports_fused_sink", False)
    ):
        _book_fused_bypass(source, backend)
    sink = {"sink": backend.make_fused_sink(pindex.dense_of)} if fused else {}
    wire = None
    if backend.packs_rows:
        wire = _wire_stats(backend.config)
        wire_bytes0 = obs_metrics.WIRE_BYTES.value
        pairs_raw0 = obs_metrics.ALIVE_PAIRS_RAW.value
        pairs_emitted0 = obs_metrics.ALIVE_PAIRS_EMITTED.value
    obs_metrics.INGEST_RESOLVED_WORKERS.set(1)
    items = prefetch(
        iter_staged(
            source.batches(batch_size, start_at=start_at, **sink),
            lambda b: backend.prepare(pindex.dense_batch(b)),
        ),
        prefetch_depth,
    )
    try:
        while True:
            with profile.stage("ingest"):
                item = next(items, None)
            if item is None:
                break
            item, staged = item
            nvalid = item.num_valid
            if isinstance(item, PackedRow):
                # A PackedRow arrives staged by its sink.
                for p, o in item.next_offsets.items():
                    next_offsets[p] = max(next_offsets.get(p, 0), o)
                for p, c in item.counts.items():
                    next_offsets[p] = next_offsets.get(p, 0) + c
                last_partition = item.last_partition
                last_offset = (
                    str(item.last_offset) if item.last_offset >= 0 else "~"
                )
                last_ts = item.last_ts_s
            else:
                _observe(next_offsets, item)
                last = len(item) - 1
                last_partition = int(item.partition[last])
                last_offset = (
                    str(int(item.offsets[last]))
                    if item.offsets is not None else "~"
                )
                last_ts = int(item.ts_s[last])
            # nbytes is the decoded batch's size on either path, so the
            # stat compares across backends and fused/chained.
            with profile.stage("dispatch", items=nvalid, nbytes=item.nbytes):
                backend.update(staged)
            records += nvalid
            obs_metrics.SCAN_RECORDS.inc(nvalid)
            obs_metrics.SCAN_BATCHES.inc()
            obs_metrics.SCAN_BYTES.inc(item.nbytes)
            obs_metrics.BATCH_RECORDS.observe(nvalid)
            maybe_heartbeat()
            spinner.set_message(
                f"[Sq: {records} | T: {topic} | P: {last_partition} | "
                f"O: {last_offset} | Ts: {format_utc_seconds(last_ts)}]"
            )
    finally:
        if hasattr(items, "close"):
            items.close()
    degraded = _booked(source, "degraded_partitions")
    corrupt = _booked(source, "corruption_stats")
    lost = _booked(source, "loss_stats")
    with profile.stage("finalize"):
        metrics = backend.finalize()
    metrics.partitions = pindex.ids
    spinner.finish_with_message("done")
    duration_secs = int(time.monotonic() - t0)
    # Final telemetry: drained partitions report zero lag, and the
    # lifecycle closes.
    heartbeat.force()
    maybe_heartbeat()
    obs_metrics.DEGRADED_PARTITIONS.set(len(degraded))
    obs_events.emit(
        "scan_end",
        topic=topic,
        records=records,
        duration_secs=duration_secs,
        degraded=len(degraded),
        corrupt_frames=sum(d.get("frames", 0) for d in corrupt.values()),
        lost_records=sum(d.get("records", 0) for d in lost.values()),
    )
    if wire is not None:
        wire.bytes_total = int(obs_metrics.WIRE_BYTES.value - wire_bytes0)
        wire.records = records
        wire.pairs_raw = int(obs_metrics.ALIVE_PAIRS_RAW.value - pairs_raw0)
        wire.pairs_emitted = int(
            obs_metrics.ALIVE_PAIRS_EMITTED.value - pairs_emitted0
        )
        obs_metrics.WIRE_BYTES_PER_RECORD.set(round(wire.bytes_per_record, 2))
    return ScanResult(
        metrics=metrics,
        duration_secs=duration_secs,
        start_offsets=start_offsets,
        end_offsets=end_offsets,
        records=records,
        fused=fused,
        fallbacks=dict(sink["sink"].fallbacks) if fused else {},
        degraded_partitions=degraded,
        corrupt_partitions=corrupt,
        lost_partitions=lost,
        telemetry=default_registry().snapshot(),
        dispatch_depth=backend.dispatch_depth,
        wire=wire,
    )


def _observe(next_offsets: "dict[int, int]", batch: RecordBatch) -> None:
    """Advance the per-partition progress past a decoded batch: exact
    where the batch carries offsets (compacted topics), by count
    otherwise."""
    valid = batch.valid
    if batch.offsets is not None:
        parts = batch.partition[valid]
        offs = batch.offsets[valid]
        for p in np.unique(parts):
            next_offsets[int(p)] = max(
                next_offsets.get(int(p), 0), int(offs[parts == p].max()) + 1
            )
    else:
        parts, counts = np.unique(batch.partition[valid], return_counts=True)
        for p, c in zip(parts.tolist(), counts.tolist()):
            next_offsets[p] = next_offsets.get(p, 0) + int(c)


def _booked(source: RecordSource, method: str) -> dict:
    """What a source that books scan issues (the Kafka wire source, or a
    tee of it) reports through ``method``; empty for other sources."""
    fn = getattr(source, method, None)
    return dict(fn()) if fn is not None else {}
