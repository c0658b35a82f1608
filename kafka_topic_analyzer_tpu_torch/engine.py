"""The scan drive loop (port of the reference's ``engine.run_scan``, its
single-device path).

One full earliest→latest pass: fix the watermarks, stream every batch
through the backend in per-partition offset order, finalize once.

Items are produced and staged on ingest threads: one prefetch worker
(``prefetch_depth`` items ahead; 0 runs everything on the calling
thread), or with ``ingest_workers`` > 1 a `parallel.ingest.
ParallelIngest` fan-in of N workers, each with a private stream over its
own partitions, merged in a deterministic round-robin.  The source's
batch is packed into a pinned slot and its copy to the device started
there, so the main thread only dispatches folds.  When the source can
feed a fused sink and the backend packs natively with the shim loaded,
the source appends its columns straight into packed rows
(`packing.FusedPackSink`, one per ingest stream, from the backend) and
no decoded batch exists at all; otherwise the chained path decodes
batches and packs them.  Both give the same rows up
to where the batches are cut, and the same report.  The numpy oracle
(`backends.cpu.CpuExactBackend`) packs no rows (`MetricBackend.packs_rows`):
its ``prepare`` is the identity and it folds the decoded batches on the
main thread.

With a backend whose ``superbatch_k`` is K > 1 (``--superbatch``) the
loop accumulates K staged items and hands them to
``backend.update_superbatch`` in one dispatch (`make_superbatch`).  The
fold order is unchanged, and so is the result.  Progress commits, and
so snapshots, happen only at superbatch boundaries; on a failure the
pending tail is flushed first, so the failure snapshot still covers
every batch the loop observed.

Every wall second of the loop is booked in one `utils.profiling.
ScanProfile` stage: ``ingest`` (waiting on the prefetch queue or the
fan-in for the next item), ``dispatch`` (the backend's dispatch-queue
throttle, then its ``update``), ``snapshot`` and ``finalize``; the scan
counters, wire and fused bookings, per-partition lag/ETA gauges and the
lifecycle events go to the default telemetry registry and event bus
(``obs``), which cost nothing until a sink or exporter reads them.

Partition ids need not be dense: `PartitionIndex` maps the source's ids to
state rows and the report prints the true ids.

With ``snapshot_dir`` the state and the per-partition next offsets are
saved (`checkpoint.py`) every ``snapshot_every_s`` seconds, at a fold
boundary (booked as the ``snapshot`` stage); a failing or interrupted
scan writes one last snapshot of what it folded before it re-raises, and
a scan that booked degraded, corrupt or lost partitions writes one
before finalize.  ``resume`` restarts from a compatible snapshot, one
written by this package or by the reference.

A Kafka wire source may drop partitions (degraded), skip poisoned frames
(corrupt) or see the log move under it (lost): the result carries what
the source booked, for the report's warning blocks and the exit code.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time
from typing import Optional

import numpy as np

from kafka_topic_analyzer_tpu_torch import checkpoint
from kafka_topic_analyzer_tpu_torch.backends.base import MetricBackend
from kafka_topic_analyzer_tpu_torch.config import IngestConfig
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.packing import PackedRow, fused_ingest_enabled
from kafka_topic_analyzer_tpu_torch.parallel.ingest import (
    ParallelIngest,
    iter_staged,
    shard_partitions,
)
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics, WireStats
from kafka_topic_analyzer_tpu_torch.utils.prefetch import prefetch
from kafka_topic_analyzer_tpu_torch.utils.profiling import ScanProfile
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner
from kafka_topic_analyzer_tpu_torch.utils.timefmt import format_utc_seconds

#: Seconds between two refreshes of the lag/ETA gauges and heartbeat events.
HEARTBEAT_EVERY_S = 10.0

log = logging.getLogger(__name__)

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
    #: Ingest streams the scan ran (``--ingest-workers``, resolved).
    ingest_workers: int = 1
    #: Batches folded per dispatch (``--superbatch``, resolved; 1 for the
    #: oracle).
    superbatch_k: int = 1
    #: Bound on in-flight dispatches (``--dispatch-depth``; 1 for the
    #: oracle, which dispatches nothing).
    dispatch_depth: int = 1
    #: Packed wire accounting (`results.WireStats`); None for the oracle.
    wire: Optional[WireStats] = None
    #: Per-partition next-unread offsets at scan end (the progress
    #: tracker's); degraded partitions stop early.
    next_offsets: "dict[int, int]" = dataclasses.field(default_factory=dict)


class _ProgressTracker:
    """Per-partition next-offset tracking for snapshot resume.

    Gapless sources are tracked by counting records; sources that attach
    per-record offsets (compacted Kafka topics) are tracked exactly.
    """

    def __init__(self, start_offsets: "dict[int, int]"):
        self.next_offsets = dict(start_offsets)

    def observe(self, batch: RecordBatch) -> None:
        """Advance past a decoded batch (true partition ids)."""
        valid = batch.valid
        if batch.offsets is not None:
            parts = batch.partition[valid]
            offs = batch.offsets[valid]
            for p in np.unique(parts):
                self.next_offsets[int(p)] = max(
                    self.next_offsets.get(int(p), 0),
                    int(offs[parts == p].max()) + 1,
                )
        else:
            parts, counts = np.unique(batch.partition[valid], return_counts=True)
            for p, c in zip(parts.tolist(), counts.tolist()):
                self.next_offsets[p] = self.next_offsets.get(p, 0) + int(c)

    def observe_packed(self, row: PackedRow) -> None:
        """Fused-path twin of ``observe``: a `packing.PackedRow` carries
        the per-partition bookkeeping pre-aggregated (offset-exact
        partitions in ``next_offsets``, offset-less ones as ``counts``)."""
        for p, o in row.next_offsets.items():
            self.next_offsets[p] = max(self.next_offsets.get(p, 0), o)
        for p, c in row.counts.items():
            self.next_offsets[p] = self.next_offsets.get(p, 0) + c


def _note_fetch_streams(source: RecordSource, workers: int) -> None:
    """Tell the process-wide fetch scheduler how many ingest streams this
    scan just resolved: under ``--fetch-concurrency auto`` the shared
    pool grows so every stream can keep a demand fetch plus some
    speculation in flight (an explicit size is never overridden).  Only
    remote segment sources feed the scheduler; for every other source
    this is a no-op."""
    if bool(getattr(getattr(source, "store", None), "is_remote", False)):
        from kafka_topic_analyzer_tpu_torch.io import fetchsched

        fetchsched.note_streams(workers)


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
    snapshot_dir: Optional[str] = None,
    snapshot_every_s: float = 60.0,
    resume: bool = False,
    ingest_workers: "int | str | IngestConfig" = 1,
) -> ScanResult:
    """Full scan of ``topic`` from ``source`` through ``backend``;
    ``start_at`` starts the partitions it names at those offsets (the
    report keeps the source's watermarks; a resumed snapshot's offsets
    take precedence).  ``ingest_workers`` (an int, ``"auto"`` or an
    `config.IngestConfig`) shards the partitions over that many ingest
    workers.  The session's active `obs.trace.SpanTracer`, if any,
    mirrors every stage window into a Chrome trace."""
    ingest_cfg = (
        ingest_workers
        if isinstance(ingest_workers, IngestConfig)
        else IngestConfig(workers=ingest_workers)
    )
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
    # Per-partition progress, for the lag/ETA gauges and the snapshots.
    tracker = _ProgressTracker(start_offsets)
    if start_at:
        tracker.next_offsets.update(start_at)
    seq = 0

    def maybe_heartbeat() -> None:
        """Rate-limited telemetry refresh: per-partition lag/ETA gauges +
        one heartbeat event, at most once per interval."""
        if not heartbeat.ready():
            return
        elapsed = time.monotonic() - t0
        # Rate over this run only: a resume restores seq to the
        # snapshot's count, which elapsed knows nothing about.
        rate = (seq - seq_base) / elapsed if elapsed > 0 else 0.0
        lag_total = 0
        for p, end in end_offsets.items():
            lag = max(0, end - tracker.next_offsets.get(p, start_offsets[p]))
            lag_total += lag
            obs_metrics.PARTITION_LAG.labels(partition=p).set(lag)
            obs_metrics.PARTITION_ETA_SECONDS.labels(partition=p).set(
                lag / rate if rate > 0 else -1.0
            )
        obs_events.emit(
            "heartbeat",
            seq=seq,
            records_per_sec=round(rate, 1),
            lag_total=lag_total,
        )

    can_snapshot = snapshot_dir is not None and backend.snapshots
    if snapshot_dir is not None and not backend.snapshots:
        log.warning(
            "backend %s does not support snapshots; continuing without",
            type(backend).__name__,
        )
    if resume and can_snapshot:
        snap = checkpoint.load_snapshot(snapshot_dir, topic, backend.config)
        if snap is not None:
            state, offsets, records_seen, init_now_s = snap
            backend.set_state(state)
            backend.init_now_s = init_now_s
            tracker.next_offsets.update(offsets)
            start_at = offsets
            seq = records_seen
            if hasattr(source, "seed_corrupt_spans"):
                # Spans a previous run already skipped or quarantined:
                # re-walking one (a skip leaves no records for the tracker
                # to advance past) neither re-counts nor re-quarantines it.
                spans = checkpoint.load_corrupt_spans(snapshot_dir)
                if spans:
                    source.seed_corrupt_spans(spans)
            if hasattr(source, "seed_lost_spans"):
                # Loss a previous run already booked: the logical scan's
                # report names it without booking it again.
                lspans = checkpoint.load_lost_spans(snapshot_dir)
                if lspans:
                    source.seed_lost_spans(lspans)
                if hasattr(source, "validate_resume"):
                    # Each saved cursor against the live log before the
                    # first fetch: a cursor below the log start is a named
                    # retention loss (offsets re-anchor in place), and an
                    # epoch that moved since the save runs the divergence
                    # check.
                    source.validate_resume(
                        offsets, checkpoint.load_partition_meta(snapshot_dir)
                    )
                    tracker.next_offsets.update(offsets)
    seq_base = seq  # resumed records predate t0; the rate excludes them
    last_snap = time.monotonic()
    # Offsets and seq as of the last completed fold.  The tracker observes
    # an item before backend.update folds it, so after a failure between
    # the two the tracker runs ahead of the state: the failure snapshot
    # takes these instead, or a resume would skip the unfolded records.
    committed_offsets = dict(tracker.next_offsets)
    committed_seq = seq

    def maybe_snapshot(
        force: bool = False,
        offsets: "Optional[dict[int, int]]" = None,
        records_seen: Optional[int] = None,
    ) -> None:
        nonlocal last_snap
        if not can_snapshot:
            return
        if not force and time.monotonic() - last_snap < snapshot_every_s:
            return
        with profile.stage("snapshot"):
            checkpoint.save_snapshot(
                snapshot_dir,
                topic,
                backend.config,
                backend.get_state(),
                tracker.next_offsets if offsets is None else offsets,
                seq if records_seen is None else records_seen,
                backend.init_now_s,
                degraded=_booked(source, "degraded_partitions") or None,
                corrupt=_spans(source, "corruption_spans"),
                lost=_spans(source, "lost_spans"),
                partition_meta=_booked(source, "partition_meta") or None,
            )
        obs_metrics.SNAPSHOTS_SAVED.inc()
        obs_events.emit(
            "snapshot_saved",
            records_seen=seq if records_seen is None else records_seen,
        )
        last_snap = time.monotonic()

    fused = fused_gate(source, backend)
    if (
        not fused
        and backend.packs_rows
        and getattr(source, "supports_fused_sink", False)
    ):
        _book_fused_bypass(source, backend)
    sinks = []

    def make_sink():
        """A fresh sink for one ingest stream (a sink is single-threaded
        state, with a staging ring of its own)."""
        sinks.append(backend.make_fused_sink(pindex.dense_of))
        return sinks[-1]

    wire = None
    if backend.packs_rows:
        wire = _wire_stats(backend.config)
        wire_bytes0 = obs_metrics.WIRE_BYTES.value
        pairs_raw0 = obs_metrics.ALIVE_PAIRS_RAW.value
        pairs_emitted0 = obs_metrics.ALIVE_PAIRS_EMITTED.value

    def stage(b: RecordBatch):
        return backend.prepare(pindex.dense_batch(b))

    # Superbatch dispatch: accumulate K staged items and fold them in one
    # dispatch.  Progress commits (and therefore snapshots) happen ONLY at
    # superbatch boundaries: between them the tracker runs ahead of the
    # device state by the pending tail, and a snapshot there would skip
    # those records on resume.  On a failure the pending tail is flushed
    # as a partial superbatch (`fault_flush`), so every observed batch is
    # folded and committed before the failure snapshot.
    super_k = backend.superbatch_k
    pend: dict = {"items": [], "valid": 0, "nbytes": 0,
                  "offsets": None, "seq": 0}

    def add(staged, nvalid: int, nbytes: int) -> None:
        """Append one staged item, recording the tracker's offsets as of
        it: the flush commits the last appended item's offsets, never the
        live tracker, which may already have observed the next item."""
        nonlocal seq
        pend["items"].append(staged)
        pend["valid"] += nvalid
        pend["nbytes"] += nbytes
        seq += nvalid
        pend["offsets"] = dict(tracker.next_offsets)
        pend["seq"] = seq
        # Staging fill level (0..K): the flight recorder's stager track.
        obs_metrics.SUPERBATCH_FILL.set(len(pend["items"]))
        if len(pend["items"]) == super_k:
            flush()

    def flush() -> None:
        """Dispatch the accumulated (possibly partial) superbatch and
        commit its progress: the only point the superbatch path
        snapshots."""
        nonlocal committed_offsets, committed_seq
        if not pend["items"]:
            return
        with profile.stage("dispatch", items=pend["valid"], nbytes=pend["nbytes"]):
            backend.update_superbatch(pend["items"])
        pend["items"] = []
        pend["valid"] = 0
        pend["nbytes"] = 0
        obs_metrics.SUPERBATCH_FILL.set(0)
        committed_offsets = pend["offsets"]
        committed_seq = pend["seq"]
        maybe_snapshot(offsets=committed_offsets, records_seen=committed_seq)

    used_workers = ingest_cfg.resolve(len(pindex))
    obs_metrics.INGEST_RESOLVED_WORKERS.set(used_workers)
    _note_fetch_streams(source, used_workers)
    if used_workers > 1:
        # Partition-sharded parallel ingest: N private streams merged in a
        # deterministic round-robin, yielding the same (item, staged)
        # pairs as the prefetch path below.  Segment catalogs know their
        # per-partition record counts: workers are balanced by records.
        weigher = getattr(source, "partition_record_counts", None)
        items = ParallelIngest(
            source,
            batch_size,
            shard_partitions(
                pindex.ids,
                used_workers,
                weights=weigher() if weigher is not None else None,
            ),
            start_at=start_at,
            stage=stage,
            depth=max(prefetch_depth, 1),
            sink_factory=make_sink if fused else None,
        )
    else:
        items = prefetch(
            iter_staged(
                source.batches(
                    batch_size,
                    start_at=start_at,
                    **({"sink": make_sink()} if fused else {}),
                ),
                stage,
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
                tracker.observe_packed(item)
                last_partition = item.last_partition
                last_offset = (
                    str(item.last_offset) if item.last_offset >= 0 else "~"
                )
                last_ts = item.last_ts_s
            else:
                tracker.observe(item)
                last = len(item) - 1
                last_partition = int(item.partition[last])
                last_offset = (
                    str(int(item.offsets[last]))
                    if item.offsets is not None else "~"
                )
                last_ts = int(item.ts_s[last])
            if super_k > 1:
                add(staged, nvalid, item.nbytes)
            else:
                # nbytes is the decoded batch's size on either path, so
                # the stat compares across backends and fused/chained.
                with profile.stage("dispatch", items=nvalid, nbytes=item.nbytes):
                    backend.update(staged)
                seq += nvalid
                committed_offsets = dict(tracker.next_offsets)
                committed_seq = seq
                maybe_snapshot()
            obs_metrics.SCAN_RECORDS.inc(nvalid)
            obs_metrics.SCAN_BATCHES.inc()
            obs_metrics.SCAN_BYTES.inc(item.nbytes)
            obs_metrics.BATCH_RECORDS.observe(nvalid)
            maybe_heartbeat()
            spinner.set_message(
                f"[Sq: {seq} | T: {topic} | P: {last_partition} | "
                f"O: {last_offset} | Ts: {format_utc_seconds(last_ts)}]"
            )
        flush()  # the partial superbatch tail at stream end
    except BaseException:
        # A failure or an interrupt mid-scan: fold the pending superbatch
        # tail, retire the in-flight folds, then save what was folded so
        # a rerun with --resume continues here instead of rescanning from
        # earliest.  Best effort — the original failure is what must
        # surface.
        try:
            flush()
        except Exception:
            log.exception(
                "pending superbatch tail could not be flushed; the "
                "failure snapshot falls back to the last committed "
                "superbatch boundary"
            )
        try:
            backend.drain_dispatch()
        except Exception:
            log.exception(
                "in-flight dispatches could not be drained before the "
                "failure snapshot"
            )
        try:
            maybe_snapshot(
                force=True, offsets=committed_offsets, records_seen=committed_seq
            )
        except Exception:
            log.exception("final failure snapshot could not be written")
        raise
    finally:
        if hasattr(items, "close"):
            items.close()
    degraded = _booked(source, "degraded_partitions")
    corrupt = _booked(source, "corruption_stats")
    lost = _booked(source, "loss_stats")
    if degraded or corrupt or lost:
        # Degraded partitions carry an unscanned tail, corrupt ones
        # skipped spans the tracker never saw, lost ones booked spans a
        # resume must inherit: snapshot so a rerun resumes correctly.
        maybe_snapshot(force=True)
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
        records=seq,
        duration_secs=duration_secs,
        degraded=len(degraded),
        corrupt_frames=sum(d.get("frames", 0) for d in corrupt.values()),
        lost_records=sum(d.get("records", 0) for d in lost.values()),
    )
    if wire is not None:
        wire.bytes_total = int(obs_metrics.WIRE_BYTES.value - wire_bytes0)
        wire.records = seq - seq_base
        wire.pairs_raw = int(obs_metrics.ALIVE_PAIRS_RAW.value - pairs_raw0)
        wire.pairs_emitted = int(
            obs_metrics.ALIVE_PAIRS_EMITTED.value - pairs_emitted0
        )
        obs_metrics.WIRE_BYTES_PER_RECORD.set(round(wire.bytes_per_record, 2))
    fallbacks: "dict[str, int]" = {}
    for sink in sinks:
        for reason, n in sink.fallbacks.items():
            fallbacks[reason] = fallbacks.get(reason, 0) + n
    return ScanResult(
        metrics=metrics,
        duration_secs=duration_secs,
        start_offsets=start_offsets,
        end_offsets=end_offsets,
        records=seq - seq_base,
        fused=fused,
        fallbacks=fallbacks,
        degraded_partitions=degraded,
        corrupt_partitions=corrupt,
        lost_partitions=lost,
        telemetry=default_registry().snapshot(),
        ingest_workers=used_workers,
        superbatch_k=super_k,
        dispatch_depth=backend.dispatch_depth,
        wire=wire,
        next_offsets=dict(tracker.next_offsets),
    )


def _booked(source: RecordSource, method: str) -> dict:
    """What a source that books scan issues (the Kafka wire source, or a
    tee of it) reports through ``method``; empty for other sources."""
    fn = getattr(source, method, None)
    return dict(fn()) if fn is not None else {}


def _spans(source: RecordSource, method: str) -> "list | None":
    """A span list the source books through ``method`` (corrupt or lost
    spans), or None when it books none."""
    fn = getattr(source, method, None)
    return (fn() or None) if fn is not None else None
