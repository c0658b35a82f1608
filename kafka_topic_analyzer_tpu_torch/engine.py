"""The scan drive loop (port of the reference's ``engine.run_scan``).

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

A sharded backend (``--mesh D[,S]``, `parallel.sharded.ShardedTorchBackend`)
takes one round at a time: each data row's partitions
(`parallel.mesh.assign_partitions`) stream through a pipeline of their
own — one staged prefetch stream, or a fan-in of the row's share of the
ingest workers (`parallel.ingest.allocate_row_workers`) — and every round
carries the next item of each row (None once the row has drained) into
``backend.update_shards``, or K rounds into
``update_shards_superbatch``.

Under several controllers (``--distributed``: `parallel.mesh`) each
process feeds only the rows it owns (``backend.local_rows``), and the
processes keep the same rounds: every round ends in one agreement
(``backend.global_any``: does any process still have data?), so each
reaches the same superbatch flushes and stops at the same round.  A
failing process's pending superbatch tail is not flushed, as in the
reference, where that flush would be a collective its peers never join:
its failure snapshot falls back to the last committed boundary.  After
the stream, one agreement per scan issue (degraded, corrupt, lost, in
that order) names an issue another process booked
(`_issues_elsewhere`), finalize merges every process's rows, and
``backend.gather_telemetry`` gives every process's registry snapshot:
the merged ``telemetry`` and ``ingest_workers_per_controller``.
Snapshots are per process (``backend.snapshot_scope``).

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

The follow service (``serve/follow.py``) calls `run_scan` once per poll
on the same backend, from the previous pass's ``next_offsets``: the
backend's state keeps accumulating, its staging rings come back to it at
every pass end (`MetricBackend.release_staging`) and serve the next pass,
and the pass hooks (``initial_seq``, ``heartbeat``, ``emit_lifecycle``,
``book_once``, ``final_snapshot``) make a chain of passes book and
report as one scan.
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
from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.obs.registry import merge_snapshots
from kafka_topic_analyzer_tpu_torch.packing import PackedRow, fused_ingest_enabled
from kafka_topic_analyzer_tpu_torch.parallel.ingest import (
    ParallelIngest,
    allocate_row_workers,
    iter_staged,
    shard_partitions,
)
from kafka_topic_analyzer_tpu_torch.parallel.mesh import assign_partitions
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
    #: Ingest streams the scan ran (``--ingest-workers``, resolved) in this
    #: process.
    ingest_workers: int = 1
    #: Ingest streams of every controller, in process order (one entry
    #: with one controller): each resolves ``--ingest-workers`` against
    #: its own rows' partitions.
    ingest_workers_per_controller: "list[int]" = dataclasses.field(
        default_factory=list
    )
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


def _wire_stats(config, batch_size: int, book: bool = True) -> WireStats:
    """The wire accounting of a packed backend's config at the row size it
    packs (``batch_size``; a sharded backend's chunk size), with the v4
    and compaction-off bypasses booked once per scan (``book``)."""
    from kafka_topic_analyzer_tpu_torch.packing import section_byte_split

    per_rec, table = section_byte_split(config, batch_size)
    stats = WireStats(
        format=config.wire_format,
        batch_size=batch_size,
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
    if config.wire_v4_reason is not None and book:
        obs_metrics.WIRE_V4_FALLBACK.labels(reason=config.wire_v4_reason).inc()
    if config.alive_compaction_off_reason is not None and book:
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
    initial_seq: int = 0,
    heartbeat: "Optional[obs_events.Heartbeat]" = None,
    emit_lifecycle: bool = True,
    book_once: bool = True,
    final_snapshot: bool = False,
    lease_epoch: "Optional[int]" = None,
) -> ScanResult:
    """Full scan of ``topic`` from ``source`` through ``backend``;
    ``start_at`` starts the partitions it names at those offsets (the
    report keeps the source's watermarks; a resumed snapshot's offsets
    take precedence).  ``ingest_workers`` (an int, ``"auto"`` or an
    `config.IngestConfig`) shards the partitions over that many ingest
    workers.  The session's active `obs.trace.SpanTracer`, if any,
    mirrors every stage window into a Chrome trace.

    Follow-mode pass hooks (serve/follow.py reruns this function per
    poll on the SAME backend, so its state accumulates and its staging
    rings, dispatch queue and superbatch stager serve every pass):
    ``initial_seq`` seeds the record sequence so pass N+1's spinner,
    heartbeat and snapshot counts continue pass N's; ``heartbeat`` shares
    one rate limiter across passes (a fresh one per pass would fire on
    every poll at the head); ``emit_lifecycle=False`` suppresses the
    per-pass scan_start/scan_end events, the closing heartbeat and the
    spinner's finish line (the service emits one lifecycle pair for its
    run); ``book_once=False`` suppresses the once-per-scan bypass
    bookings (wire v4, compaction off, fused fallback) on every pass after
    the first; ``final_snapshot`` forces a snapshot once the stream has
    drained, at a superbatch boundary (the pending tail is flushed at
    every pass end) — the service's checkpoint-interval and clean-shutdown
    commits.

    ``lease_epoch`` (fleet/lease.py): the caller's topic-ownership epoch,
    stamped on every snapshot this pass saves and checked against every
    snapshot it loads: a pass under a lost lease raises
    `checkpoint.StaleLeaseEpochError` instead of overwriting (or resuming
    from) its successor's checkpoint."""
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
    # The scan's number rides on every span of this thread and of the
    # ingest threads it starts (obs/trace.py).
    obs_trace.begin_scan()
    profile = ScanProfile(tracer=obs_trace.active())
    spinner = spinner or Spinner(enabled=False)
    if heartbeat is None:
        heartbeat = obs_events.Heartbeat(HEARTBEAT_EVERY_S)
    t0 = time.monotonic()
    if emit_lifecycle:
        obs_events.emit(
            "scan_start", topic=topic, partitions=len(pindex),
            batch_size=batch_size,
        )
    # Per-partition progress, for the lag/ETA gauges and the snapshots.
    tracker = _ProgressTracker(start_offsets)
    if start_at:
        tracker.next_offsets.update(start_at)
    seq = initial_seq
    # Under several controllers a process feeds only its rows' partitions,
    # and its lag gauges name only those: the gathered registries then
    # hold each partition once.
    feed_rows = backend.local_rows if backend.sharded else []
    multiproc = backend.sharded and len(feed_rows) < backend.config.data_shards
    fed_partitions = list(end_offsets)
    if multiproc:
        parts = assign_partitions(pindex.ids, backend.config.data_shards)
        fed_partitions = [p for r in feed_rows for p in parts[r]]

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
        for p in fed_partitions:
            end = end_offsets[p]
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
        # Health evaluation rides the heartbeat boundary so a plain batch
        # scan gets a live /healthz too; the engine rate-limits itself
        # (HealthConfig.eval_interval_s) and only reads registry
        # snapshots, so the scan is the same with it on or off.
        health = obs_health.active()
        if health is not None:
            health.maybe_evaluate()

    can_snapshot = snapshot_dir is not None and backend.snapshots
    if snapshot_dir is not None and not backend.snapshots:
        log.warning(
            "backend %s does not support snapshots; continuing without",
            type(backend).__name__,
        )
    # Several controllers snapshot per process: its own rows, its own file.
    scope = backend.snapshot_scope if multiproc else None
    get_state = backend.get_state_local if multiproc else backend.get_state
    set_state = backend.set_state_local if multiproc else backend.set_state
    if resume and can_snapshot:
        snap = checkpoint.load_snapshot(
            snapshot_dir, topic, backend.config, lease_epoch=lease_epoch,
            scope=scope,
        )
        if snap is not None:
            state, offsets, records_seen, init_now_s = snap
            set_state(state)
            backend.init_now_s = init_now_s
            tracker.next_offsets.update(offsets)
            start_at = offsets
            seq = records_seen
            if hasattr(source, "seed_corrupt_spans"):
                # Spans a previous run already skipped or quarantined:
                # re-walking one (a skip leaves no records for the tracker
                # to advance past) neither re-counts nor re-quarantines it.
                spans = checkpoint.load_corrupt_spans(snapshot_dir, scope=scope)
                if spans:
                    source.seed_corrupt_spans(spans)
            if hasattr(source, "seed_lost_spans"):
                # Loss a previous run already booked: the logical scan's
                # report names it without booking it again.
                lspans = checkpoint.load_lost_spans(snapshot_dir, scope=scope)
                if lspans:
                    source.seed_lost_spans(lspans)
                if hasattr(source, "validate_resume"):
                    # Each saved cursor against the live log before the
                    # first fetch: a cursor below the log start is a named
                    # retention loss (offsets re-anchor in place), and an
                    # epoch that moved since the save runs the divergence
                    # check.
                    source.validate_resume(
                        offsets,
                        checkpoint.load_partition_meta(snapshot_dir, scope=scope),
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
                get_state(),
                tracker.next_offsets if offsets is None else offsets,
                seq if records_seen is None else records_seen,
                backend.init_now_s,
                scope=scope,
                degraded=_booked(source, "degraded_partitions") or None,
                corrupt=_spans(source, "corruption_spans"),
                lost=_spans(source, "lost_spans"),
                partition_meta=_booked(source, "partition_meta") or None,
                lease_epoch=lease_epoch,
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
        and book_once
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
        wire = _wire_stats(
            backend.config,
            backend.config.chunk_size if backend.sharded
            else backend.config.batch_size,
            book=book_once,
        )
        wire_bytes0 = obs_metrics.WIRE_BYTES.value
        pairs_raw0 = obs_metrics.ALIVE_PAIRS_RAW.value
        pairs_emitted0 = obs_metrics.ALIVE_PAIRS_EMITTED.value

    def stage(b: RecordBatch):
        return backend.prepare(pindex.dense_batch(b))

    def stage_shard(b: RecordBatch):
        return backend.prepare_shard(pindex.dense_batch(b))

    # Superbatch dispatch: accumulate K staged items and fold them in one
    # dispatch.  Progress commits (and therefore snapshots) happen ONLY at
    # superbatch boundaries: between them the tracker runs ahead of the
    # device state by the pending tail, and a snapshot there would skip
    # those records on resume.  On a failure the pending tail is flushed
    # as a partial superbatch (`fault_flush`), so every observed batch is
    # folded and committed before the failure snapshot.
    super_k = backend.superbatch_k
    dispatch_items = (
        backend.update_shards_superbatch if backend.sharded
        else backend.update_superbatch
    )
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
            dispatch_items(pend["items"])
        pend["items"] = []
        pend["valid"] = 0
        pend["nbytes"] = 0
        obs_metrics.SUPERBATCH_FILL.set(0)
        committed_offsets = pend["offsets"]
        committed_seq = pend["seq"]
        maybe_snapshot(offsets=committed_offsets, records_seen=committed_seq)

    def fold(staged, nvalid: int, nbytes: int, update) -> None:
        """Fold one staged item (a batch, or a round of data-row shards)
        through ``update``, or into the pending superbatch at K > 1; then
        the scan counters and the heartbeat."""
        nonlocal seq, committed_offsets, committed_seq
        if super_k > 1:
            add(staged, nvalid, nbytes)
        else:
            with profile.stage("dispatch", items=nvalid, nbytes=nbytes):
                update(staged)
            seq += nvalid
            committed_offsets = dict(tracker.next_offsets)
            committed_seq = seq
            maybe_snapshot()
        obs_metrics.SCAN_RECORDS.inc(nvalid)
        obs_metrics.SCAN_BATCHES.inc()
        obs_metrics.SCAN_BYTES.inc(nbytes)
        obs_metrics.BATCH_RECORDS.observe(nvalid)
        maybe_heartbeat()

    streams: list = []
    if backend.sharded:
        used_workers, streams = _row_streams(
            source, backend, pindex, ingest_cfg, batch_size, prefetch_depth,
            start_at, stage_shard, make_sink if fused else None,
            label_prefix=f"c{backend.controller_index}." if multiproc else "",
        )
    else:
        used_workers = ingest_cfg.resolve(len(pindex))
        obs_metrics.INGEST_RESOLVED_WORKERS.set(used_workers)
        _note_fetch_streams(source, used_workers)
        if used_workers > 1:
            # Partition-sharded parallel ingest: N private streams merged
            # in a deterministic round-robin, yielding the same (item,
            # staged) pairs as the prefetch path below.  Segment catalogs
            # know their per-partition record counts: workers are balanced
            # by records.
            weigher = getattr(source, "partition_record_counts", None)
            streams.append(ParallelIngest(
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
            ))
        else:
            streams.append(prefetch(
                iter_staged(
                    source.batches(
                        batch_size,
                        start_at=start_at,
                        **({"sink": make_sink()} if fused else {}),
                    ),
                    stage,
                ),
                prefetch_depth,
            ))
    try:
        if backend.sharded:
            d = backend.config.data_shards
            live = [True] * len(feed_rows)
            while True:
                # One round: the next item of every fed data row that has
                # one (None for the others).
                shards: list = [None] * d
                nvalid = nbytes = 0
                with profile.stage("ingest"):
                    for j, r in enumerate(feed_rows):
                        item = next(streams[j], None) if live[j] else None
                        if item is None:
                            live[j] = False
                            continue
                        item, shards[r] = item
                        nvalid += item.num_valid
                        nbytes += item.nbytes
                        if isinstance(item, PackedRow):
                            tracker.observe_packed(item)
                        else:
                            tracker.observe(item)
                have_data = nvalid > 0
                if multiproc:
                    # Every process keeps the same rounds: it goes on while
                    # any process has data (an all-None round folds nothing).
                    have_data = backend.global_any(have_data)
                if not have_data:
                    break
                fold(shards, nvalid, nbytes, backend.update_shards)
                spinner.set_message(f"[Sq: {seq} | T: {topic} | shards: {d}]")
        else:
            items = streams[0]
            while True:
                with profile.stage("ingest"):
                    item = next(items, None)
                if item is None:
                    break
                item, staged = item
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
                # nbytes is the decoded batch's size on either path, so
                # the stat compares across backends and fused/chained.
                fold(staged, item.num_valid, item.nbytes, backend.update)
                spinner.set_message(
                    f"[Sq: {seq} | T: {topic} | P: {last_partition} | "
                    f"O: {last_offset} | Ts: {format_utc_seconds(last_ts)}]"
                )
        flush()  # the partial superbatch tail at stream end
    except BaseException:
        # A failure or an interrupt mid-scan: fold the pending superbatch
        # tail (not under several controllers, whose rounds are agreed),
        # retire the in-flight folds, then save what was folded so a
        # rerun with --resume continues here instead of rescanning from
        # earliest.  Best effort — the original failure is what must
        # surface.
        try:
            if not multiproc:
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
        for it in streams:
            if hasattr(it, "close"):
                it.close()
        # The pass's ingest threads have ended: their staging rings go
        # back to the backend for the next pass (follow mode).
        backend.release_staging()
    degraded = _booked(source, "degraded_partitions")
    corrupt = _booked(source, "corruption_stats")
    lost = _booked(source, "loss_stats")
    if multiproc:
        # Process 0 renders the report and every process picks the exit
        # code: whether the scan met an issue is agreed, one collective per
        # issue, in this order on every process.
        degraded, corrupt, lost = _issues_elsewhere(backend, degraded, corrupt, lost)
    if degraded or corrupt or lost or final_snapshot:
        # Degraded partitions carry an unscanned tail, corrupt ones
        # skipped spans the tracker never saw, lost ones booked spans a
        # resume must inherit: snapshot so a rerun resumes correctly.
        # ``final_snapshot`` forces the same commit for a clean drain.
        maybe_snapshot(force=True)
    with profile.stage("finalize"):
        metrics = backend.finalize()
    metrics.partitions = pindex.ids
    if emit_lifecycle:
        spinner.finish_with_message("done")
    duration_secs = int(time.monotonic() - t0)
    # Final telemetry: drained partitions report zero lag, and the
    # lifecycle closes.  Follow passes skip the forced refresh: the
    # service refreshes the lag gauges against the moving head every
    # poll, and a forced heartbeat per pass would flood the event log.
    if emit_lifecycle:
        heartbeat.force()
    maybe_heartbeat()
    # Locally booked issues only: another process's (key -1) is its own
    # to book, and its gauge merges by sum.
    local_degraded = sum(1 for p in degraded if p >= 0)
    obs_metrics.DEGRADED_PARTITIONS.set(local_degraded)
    if emit_lifecycle:
        obs_events.emit(
            "scan_end",
            topic=topic,
            records=seq,
            duration_secs=duration_secs,
            degraded=local_degraded,
            corrupt_frames=sum(
                d.get("frames", 0) for p, d in corrupt.items() if p >= 0
            ),
            lost_records=sum(
                d.get("records", 0) for p, d in lost.items() if p >= 0
            ),
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
    # A collective under several controllers: every process reaches it.
    snaps = backend.gather_telemetry()
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
        telemetry=merge_snapshots(snaps),
        ingest_workers=used_workers,
        # Each process's snapshot carries its resolved worker gauge (read
        # only then: a fleet's concurrent topics share the gauge).
        ingest_workers_per_controller=[
            max(1, int(_metric_value(s, "kta_ingest_resolved_workers")))
            for s in snaps
        ] if multiproc else [used_workers],
        superbatch_k=super_k,
        dispatch_depth=backend.dispatch_depth,
        wire=wire,
        next_offsets=dict(tracker.next_offsets),
    )


def _row_streams(source, backend, pindex, ingest_cfg, batch_size: int,
                 prefetch_depth: int, start_at, stage, make_sink,
                 label_prefix: str = ""):
    """``(workers, streams)`` of a sharded scan: one pipeline per data row
    this process feeds (``backend.local_rows``) over its partitions
    (`parallel.mesh.assign_partitions`), each a staged prefetch stream, or
    a fan-in of the row's share of the worker budget
    (`parallel.ingest.allocate_row_workers`, resolved against the fed
    rows' partitions; the rows' workers numbered apart, their labels
    after ``label_prefix``).  A row without partitions gets an empty
    stream."""
    parts = assign_partitions(pindex.ids, backend.config.data_shards)
    rows = backend.local_rows
    fed = sum(len(parts[r]) for r in rows)
    row_workers = allocate_row_workers(
        ingest_cfg.resolve(max(1, fed)), {r: len(parts[r]) for r in rows},
    )
    used = max(1, sum(row_workers.values()))
    obs_metrics.INGEST_RESOLVED_WORKERS.set(used)
    _note_fetch_streams(source, used)
    weights = None
    if any(n > 1 for n in row_workers.values()):
        weigher = getattr(source, "partition_record_counts", None)
        weights = weigher() if weigher is not None else None
    streams = []
    wid_base = 0
    for r in rows:
        n = row_workers.get(r, 0)
        if not parts[r]:
            streams.append(iter(()))
        elif n > 1:
            streams.append(ParallelIngest(
                source, batch_size, shard_partitions(parts[r], n, weights=weights),
                start_at=start_at, stage=stage, depth=max(prefetch_depth, 1),
                sink_factory=make_sink, wid_base=wid_base,
                label_prefix=label_prefix,
            ))
        else:
            streams.append(prefetch(
                iter_staged(
                    source.batches(
                        batch_size, partitions=parts[r], start_at=start_at,
                        **({"sink": make_sink()} if make_sink else {}),
                    ),
                    stage,
                ),
                prefetch_depth,
            ))
        wid_base += n
    return used, streams


def _issues_elsewhere(backend, degraded: dict, corrupt: dict, lost: dict):
    """Each scan issue another process booked and this one did not, as the
    reference's one-entry stand-in (key -1, "... on another process (see
    its log)"); the agreement runs on every process, flag set or not."""
    if backend.global_any(bool(degraded)) and not degraded:
        degraded = {-1: "partition(s) degraded on another process (see its log)"}
    if backend.global_any(bool(corrupt)) and not corrupt:
        corrupt = {-1: {
            "frames": 0, "records": 0, "bytes": 0, "quarantined": 0,
            "kinds": {}, "spans": [],
            "note": "corrupt frame(s) on another process (see its log)",
        }}
    if backend.global_any(bool(lost)) and not lost:
        lost = {-1: {
            "records": 0, "ranges": 0, "reasons": {}, "authoritative": True,
            "spans": [], "note": "data loss on another process (see its log)",
        }}
    return degraded, corrupt, lost


def _metric_value(snapshot: dict, name: str) -> float:
    """The first sample of metric ``name`` in a registry snapshot (0 when
    it has none)."""
    samples = (snapshot.get(name) or {}).get("samples") or []
    return samples[0]["value"] if samples else 0


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
