"""Finalized analysis results and the reference's derived-metric semantics
(port of the reference's ``results.py``: `TopicMetrics`,
`QuantileSummary`, `finalize_extremes`, and the telemetry digests the
``--stats`` report renders — `StageDigest`, `WireStats`, `FusedStats`,
`IngestStats`, `SegmentStats`, `FollowStats`, `LossStats`,
`DispatchStats`, and `slice_rows`, the multi-topic fan-in's per-topic
projection) — with the ``--json`` document's pieces
(`TopicMetrics.to_dict` and the digests' ``as_dict``).

The derived metrics reproduce ``src/metric.rs`` of xenji's
kafka-topic-analyzer exactly, quirks included (documented per method).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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

    def as_dict(self) -> Dict[float, float]:
        return dict(zip(self.probs, self.values))


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
    #: Exact distinct keys (the numpy oracle, with ``--distinct-keys``).
    distinct_keys_exact: Optional[int] = None
    #: Exact per-partition distinct keys (the oracle, per partition).
    distinct_keys_exact_per_partition: "Optional[list[int]]" = None
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

    def extremes_decoded(self):
        """Per-partition extremes with sentinels decoded to None: the
        earliest/smallest sentinel is I64_MAX, latest's I64_MIN, and
        largest's 0 means "never set" exactly when smallest is the
        sentinel (tombstone-only partitions).  Yields (partition,
        earliest|None, latest|None, smallest|None, largest|None)."""
        if self.per_partition_extremes is None:
            return
        for p, (e, l, s, g) in zip(
            self.partitions, self.per_partition_extremes.tolist()
        ):
            no_sized = s == I64_MAX_NP
            yield (
                p,
                None if e == I64_MAX_NP else e,
                None if l == I64_MIN_NP else l,
                None if no_sized else s,
                None if no_sized else g,
            )

    def to_dict(
        self,
        start_offsets: "Optional[Dict[int, int]]" = None,
        end_offsets: "Optional[Dict[int, int]]" = None,
    ) -> dict:
        """Machine-readable report (``--json``): the same numbers as the
        terminal report, keyed by name."""
        out: dict = {
            "overall": {
                "count": self.overall_count,
                "size_bytes": self.overall_size,
                "earliest_ts": self.earliest_ts_s,
                "latest_ts": self.latest_ts_s,
                "largest_message": self.largest_message,
                "smallest_message": self.smallest_message_reported(),
            },
            "partitions": {},
        }
        for p in self.partitions:
            row = {
                name: int(self._row(p)[i])
                for name, i in CH.items()
            }
            row["dirty_ratio"] = self.dirty_ratio(p)
            row["key_size_avg"] = self.key_size_avg(p)
            row["value_size_avg"] = self.value_size_avg(p)
            row["message_size_avg"] = self.message_size_avg(p)
            if start_offsets is not None:
                row["start_offset"] = start_offsets[p]
            if end_offsets is not None:
                row["end_offset"] = end_offsets[p]
            out["partitions"][str(p)] = row
        if self.alive_keys is not None:
            out["alive_keys"] = self.alive_keys
        if self.distinct_keys_hll is not None:
            out["distinct_keys_hll"] = self.distinct_keys_hll
        if self.distinct_keys_exact is not None:
            out["distinct_keys_exact"] = self.distinct_keys_exact
        if self.distinct_keys_hll_per_partition is not None:
            out["distinct_keys_hll_per_partition"] = {
                str(p): est
                for p, est in zip(self.partitions, self.distinct_keys_hll_per_partition)
            }
        if self.distinct_keys_exact_per_partition is not None:
            out["distinct_keys_exact_per_partition"] = {
                str(p): n
                for p, n in zip(
                    self.partitions, self.distinct_keys_exact_per_partition
                )
            }
        if self.quantiles is not None:
            out["size_quantiles"] = self.quantiles.as_dict()
        if self.quantiles_per_partition is not None:
            out["size_quantiles_per_partition"] = {
                str(p): q.as_dict()
                for p, q in zip(self.partitions, self.quantiles_per_partition)
            }
        if self.per_partition_extremes is not None:
            out["extremes_per_partition"] = {
                str(p): {
                    "earliest_ts": e,
                    "latest_ts": l,
                    "smallest": s,
                    "largest": g,
                }
                for p, e, l, s, g in self.extremes_decoded()
            }
        return out



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


def _metric(snapshot: "Optional[dict]", name: str) -> "list[dict]":
    metric = (snapshot or {}).get(name)
    return metric["samples"] if metric else []


def _total(snapshot: "Optional[dict]", name: str) -> float:
    return float(sum(s.get("value", 0.0) for s in _metric(snapshot, name)))


def _by_label(snapshot: "Optional[dict]", name: str, label: str) -> "Dict[str, float]":
    out: "Dict[str, float]" = {}
    for s in _metric(snapshot, name):
        key = s.get("labels", {}).get(label)
        if key is not None:
            out[key] = out.get(key, 0.0) + s.get("value", 0.0)
    return out


@dataclasses.dataclass
class IngestStats:
    """Parallel-ingest accounting from a telemetry snapshot: per-worker
    record counts and backpressure stalls.  Empty (``workers == {}``)
    after a sequential scan, which never touches the per-worker
    instruments."""

    #: worker label -> valid records that worker produced.
    workers: "Dict[str, int]"
    #: worker label -> seconds blocked on a full fan-in queue.
    stalls: "Dict[str, float]"

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "IngestStats":
        return cls(
            workers={
                w: int(v)
                for w, v in _by_label(
                    snapshot, "kta_ingest_worker_records_total", "worker"
                ).items()
            },
            stalls=_by_label(
                snapshot, "kta_ingest_worker_stall_seconds_total", "worker"
            ),
        )


@dataclasses.dataclass
class FusedStats:
    """Fused decode→pack accounting from a telemetry snapshot: rows and
    records that took the one-pass native path, plus per-reason records
    that fell back to the decoded chain (compressed, legacy or salvaged
    frames, a missing shim...).  The ``--stats`` digest renders it so a
    bypassed fused path is never silent; empty for chained scans."""

    rows: int
    records: int
    #: fallback reason label -> records (or stream-level bypass events).
    fallbacks: "Dict[str, int]"

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "FusedStats":
        return cls(
            rows=int(_total(snapshot, "kta_fused_batches_total")),
            records=int(_total(snapshot, "kta_fused_records_total")),
            fallbacks={
                s["labels"].get("reason", "?"): int(s["value"])
                for s in _metric(snapshot, "kta_fused_fallback_total")
            },
        )


@dataclasses.dataclass
class WireStats:
    """Packed host→device wire accounting for one scan (the ``--stats``
    wire lines), built by the engine from the backend's config
    (``packing.section_byte_split``) plus the scan's
    ``kta_wire_bytes_total`` delta; None for the oracle, which ships no
    packed rows."""

    #: Wire format the scan's packed rows used (4 or 5).
    format: int
    #: Records per packed row.
    batch_size: int
    #: Bytes of one packed row in per-record sections (scale with B).
    per_record_bytes: int
    #: Bytes of one packed row in fold-table sections + header.
    table_bytes: int
    #: Packed bytes this scan dispatched.
    bytes_total: int = 0
    #: Valid records the scan folded (denominator for bytes/record).
    records: int = 0
    #: Alive-pair compaction: ``on``, ``off (<reason>)``, or ``n/a`` for
    #: scans without the alive bitmap.
    alive_compaction: str = "n/a"
    #: Per-batch LWW pairs entering the compaction merge (delta).
    pairs_raw: int = 0
    #: Merged pairs shipped in the per-dispatch tables (delta).
    pairs_emitted: int = 0

    @property
    def packed_nbytes(self) -> int:
        return self.per_record_bytes + self.table_bytes

    @property
    def bytes_per_record(self) -> float:
        return self.bytes_total / self.records if self.records else 0.0

    @property
    def compaction_ratio(self) -> float:
        """emitted/raw pairs (0.0 when the compacted path saw none)."""
        return self.pairs_emitted / self.pairs_raw if self.pairs_raw else 0.0

    def as_dict(self) -> dict:
        doc = {
            "format": self.format,
            "batch_size": self.batch_size,
            "per_record_bytes": self.per_record_bytes,
            "table_bytes": self.table_bytes,
            "packed_nbytes": self.packed_nbytes,
            "bytes_total": self.bytes_total,
            "bytes_per_record": round(self.bytes_per_record, 2),
            "alive_compaction": self.alive_compaction,
        }
        if self.alive_compaction == "on":
            doc["alive_pairs_raw"] = self.pairs_raw
            doc["alive_pairs_emitted"] = self.pairs_emitted
            doc["alive_compaction_ratio"] = round(self.compaction_ratio, 4)
        return doc



@dataclasses.dataclass
class SegmentStats:
    """Cold-path accounting from a telemetry snapshot: segment chunks the
    catalog opened, bytes it mapped (or, remotely, catalogued), and the
    records/batches read from them; empty (``files == 0``) for scans that
    read no segment store.  The remote tier adds its object-store GETs,
    bytes fetched and retries, and the segment cache's hits, misses and
    evictions (all zero for local scans)."""

    files: int
    bytes_mapped: int
    records: int
    batches: int
    gets: int = 0
    bytes_fetched: int = 0
    retries: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "SegmentStats":
        t = lambda name: int(_total(snapshot, name))  # noqa: E731
        return cls(
            files=t("kta_segment_files_opened_total"),
            bytes_mapped=t("kta_segment_bytes_mapped_total"),
            records=t("kta_segment_records_total"),
            batches=t("kta_segment_batches_total"),
            gets=t("kta_segstore_gets_total"),
            bytes_fetched=t("kta_segstore_bytes_fetched_total"),
            retries=t("kta_segstore_retries_total"),
            cache_hits=t("kta_segstore_cache_hits_total"),
            cache_misses=t("kta_segstore_cache_misses_total"),
            cache_evictions=t("kta_segstore_cache_evictions_total"),
        )

    def as_dict(self) -> dict:
        doc = {
            "files": self.files,
            "bytes_mapped": self.bytes_mapped,
            "records": self.records,
            "batches": self.batches,
        }
        if self.gets:
            # The remote block only when the scan spoke to an object
            # store: local cold scans keep the local shape.
            doc["store_gets"] = self.gets
            doc["store_bytes_fetched"] = self.bytes_fetched
            doc["store_retries"] = self.retries
            doc["cache_hits"] = self.cache_hits
            doc["cache_misses"] = self.cache_misses
            doc["cache_evictions"] = self.cache_evictions
        return doc


@dataclasses.dataclass
class FollowStats:
    """Follow-service accounting extracted from a telemetry snapshot
    (`ScanResult.telemetry`): watermark polls, fold passes, refresh
    give-ups, and published report snapshots.  Consumed by the ``--stats``
    digest (report.py) and the report document's ``follow`` block
    (serve/follow.py layers the live cursor on top); empty
    (``polls == 0``) for batch scans, which never touch the follow
    instruments."""

    #: Watermark re-polls the service took at the head.
    polls: int
    #: Fold passes (initial catch-up + one per productive poll + final).
    passes: int
    #: Re-polls that exhausted the retry budget and kept the old snapshot.
    refresh_failures: int
    #: Report documents published for /report.json.
    report_snapshots: int

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "FollowStats":
        def total(name: str) -> int:
            metric = (snapshot or {}).get(name)
            if not metric:
                return 0
            return int(sum(s.get("value", 0.0) for s in metric["samples"]))

        return cls(
            polls=total("kta_follow_polls_total"),
            passes=total("kta_follow_passes_total"),
            refresh_failures=total("kta_watermark_refresh_failures_total"),
            report_snapshots=total("kta_report_snapshots_total"),
        )

    def as_dict(self) -> dict:
        return {
            "polls": self.polls,
            "passes": self.passes,
            "watermark_refresh_failures": self.refresh_failures,
            "report_snapshots": self.report_snapshots,
        }


@dataclasses.dataclass
class LossStats:
    """Log-mutation accounting from a telemetry snapshot: records/ranges
    the log took back under the scan, by reason, plus the epoch-fencing
    machinery's activity; empty for scans of a stable log."""

    records: int
    ranges: int
    by_reason: "Dict[str, int]"
    fences: int
    divergence_checks: int
    watermark_regressions: int

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "LossStats":
        return cls(
            records=int(_total(snapshot, "kta_log_lost_records_total")),
            ranges=int(_total(snapshot, "kta_log_lost_ranges_total")),
            by_reason={
                k: int(v)
                for k, v in _by_label(
                    snapshot, "kta_log_lost_records_total", "reason"
                ).items()
            },
            fences=int(_total(snapshot, "kta_log_epoch_fences_total")),
            divergence_checks=int(
                _total(snapshot, "kta_log_divergence_checks_total")
            ),
            watermark_regressions=int(
                _total(snapshot, "kta_log_watermark_regressions_total")
            ),
        )


@dataclasses.dataclass
class DispatchStats:
    """Dispatch-queue accounting from a telemetry snapshot: dispatches
    launched, batches folded through them, and launch-to-retire latency
    totals (a superbatch dispatch folds up to K batches); empty for the
    oracle, which has no device dispatch."""

    dispatches: int
    batches: int
    latency_count: int
    latency_seconds: float

    @property
    def mean_latency_ms(self) -> float:
        if not self.latency_count:
            return 0.0
        return (self.latency_seconds / self.latency_count) * 1e3

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "DispatchStats":
        def agg(name: str) -> "tuple[float, float]":
            samples = _metric(snapshot, name)
            return (
                sum(s.get("count", 0.0) for s in samples),
                sum(s.get("sum", 0.0) for s in samples),
            )

        n_dispatch, n_batches = agg("kta_superbatch_size")
        lat_n, lat_s = agg("kta_dispatch_seconds")
        return cls(
            dispatches=int(n_dispatch),
            batches=int(n_batches),
            latency_count=int(lat_n),
            latency_seconds=lat_s,
        )


@dataclasses.dataclass
class StageDigest:
    """Per-stage drive-loop accounting from a telemetry snapshot: the
    live-booked ``kta_stage_{seconds,records,bytes}_total`` counters
    (utils/profiling.ScanProfile books them at every stage window exit).
    The one stage-timings source of the ``--stats`` digest and the scan
    doctor."""

    #: stage -> (seconds, records, bytes), canonical pipeline order.
    stages: "Dict[str, tuple]"

    @classmethod
    def from_telemetry(cls, snapshot: "Optional[dict]") -> "StageDigest":
        from kafka_topic_analyzer_tpu_torch.utils.profiling import STAGE_ORDER

        secs = _by_label(snapshot, "kta_stage_seconds_total", "stage")
        recs = _by_label(snapshot, "kta_stage_records_total", "stage")
        byts = _by_label(snapshot, "kta_stage_bytes_total", "stage")
        rank = {name: i for i, name in enumerate(STAGE_ORDER)}
        ordered = sorted(secs, key=lambda s: (rank.get(s, len(STAGE_ORDER)), s))
        return cls(
            stages={
                s: (secs[s], int(recs.get(s, 0)), int(byts.get(s, 0)))
                for s in ordered
                # The flight recorder creates zero-valued stage children
                # eagerly; an all-zero stage never ran.
                if secs[s] or recs.get(s) or byts.get(s)
            }
        )


def slice_rows(
    metrics: TopicMetrics,
    rows: "list[int]",
    partition_ids: "list[int]",
) -> TopicMetrics:
    """Project a multi-topic (fan-in) result onto one topic's rows.

    Exact for everything derived from per-row state (counters, extremes,
    overall sums); cross-topic merged sketches (alive bitmap, HLL,
    quantiles) cannot be un-merged and are dropped from the slice — they
    live in the fan-in union report.
    """
    if metrics.per_partition_extremes is None:
        raise ValueError("slice_rows needs per-partition extremes")
    per = metrics.per_partition[rows]
    ext = metrics.per_partition_extremes[rows]
    earliest_raw = int(ext[:, 0].min()) if len(rows) else I64_MAX_NP
    latest_raw = int(ext[:, 1].max()) if len(rows) else I64_MIN_NP
    smallest_raw = int(ext[:, 2].min()) if len(rows) else I64_MAX_NP
    largest = int(ext[:, 3].max()) if len(rows) else 0
    now = metrics.init_now_s if metrics.init_now_s is not None else 0
    earliest, latest, smallest = finalize_extremes(
        earliest_raw, latest_raw, smallest_raw, now
    )
    overall_size = int(
        per[:, CH["key_size_sum"]].sum() + per[:, CH["value_size_sum"]].sum()
    )
    overall_count = int(per[:, CH["total"]].sum())
    qpp = None
    if metrics.quantiles_per_partition is not None:
        # Per-partition sketches are per-row state — sliceable like extremes.
        qpp = [metrics.quantiles_per_partition[r] for r in rows]
    hpp = None
    if metrics.distinct_keys_hll_per_partition is not None:
        hpp = [metrics.distinct_keys_hll_per_partition[r] for r in rows]
    epp = None
    if metrics.distinct_keys_exact_per_partition is not None:
        epp = [metrics.distinct_keys_exact_per_partition[r] for r in rows]
    return TopicMetrics(
        partitions=list(partition_ids),
        per_partition=per,
        earliest_ts_s=earliest,
        latest_ts_s=latest,
        smallest_message=smallest,
        largest_message=largest,
        overall_size=overall_size,
        overall_count=overall_count,
        quantiles_per_partition=qpp,
        distinct_keys_hll_per_partition=hpp,
        distinct_keys_exact_per_partition=epp,
        per_partition_extremes=ext,
        init_now_s=metrics.init_now_s,
    )
