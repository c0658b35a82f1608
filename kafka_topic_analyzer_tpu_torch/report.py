"""Terminal report renderer, byte-compatible with the reference (port of
the reference's ``report.py``: `render_report` and its extension lines,
`render_extremes_table`, and the ``--stats`` digests `render_stage_stats`,
`render_telemetry_stats` and `render_bottleneck`, each with the lines of
the features the port has, and `build_json_doc`, which assembles the
``--json`` document).

Reproduces the report block of xenji/kafka-topic-analyzer's
``src/main.rs:123-179``: the global lines, the optional alive-keys block,
the legend and the 15-column per-partition table.  HLL and quantile lines
follow after the reference-compatible block.  A Kafka scan that degraded,
skipped corrupt frames or lost records prints the reference's warning
blocks after the report (`render_degraded_block`, `render_corrupt_block`,
`render_data_loss_block`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from kafka_topic_analyzer_tpu_torch.results import TopicMetrics
from kafka_topic_analyzer_tpu_torch.utils.table import render_table
from kafka_topic_analyzer_tpu_torch.utils.timefmt import format_utc_seconds

#: Header row of the per-partition table.
TABLE_HEADER = [
    "P", "< OS", "> OS", "Total", "Alive", "Tmb", "DR", "K Null", "K !Null",
    "P-Bytes", "K-Bytes", "V-Bytes", "A K-Sz", "A V-Sz", "A M-Sz",
]

LEGEND = (
    "| K = Key, V = Value, P = Partition, Tmb = Tombstone(s), Sz = Size\n"
    "| DR = Dirty Ratio, A = Average, Lst = last, < OS = start offset, > OS = end offset\n"
)


def render_report(
    topic: str,
    metrics: TopicMetrics,
    start_offsets: Dict[int, int],
    end_offsets: Dict[int, int],
    duration_secs: int,
    show_alive_keys: bool = False,
    show_extensions: bool = True,
) -> str:
    """Render the full post-scan report."""
    eq = "=" * 120
    dash = "-" * 120
    out: List[str] = []
    out.append("")
    out.append(eq)
    out.append("Calculating statistics...")
    out.append(f"Topic {topic}")
    out.append(f"Scanning took: {duration_secs} seconds")
    # Integer division, denominator clamped to >= 1.
    out.append(f"Estimated Msg/s: {metrics.overall_count // max(duration_secs, 1)}")
    out.append(dash)
    out.append(f"Earliest Message: {format_utc_seconds(metrics.earliest_ts_s)}")
    out.append(f"Latest Message: {format_utc_seconds(metrics.latest_ts_s)}")
    out.append(dash)
    out.append(f"Largest Message: {metrics.largest_message} bytes")
    out.append(f"Smallest Message: {metrics.smallest_message_reported()} bytes")
    out.append(f"Topic Size: {metrics.overall_size} bytes")
    if show_alive_keys and metrics.alive_keys is not None:
        out.append(dash)
        out.append(f"Alive keys: {metrics.alive_keys}")
        out.append(dash)
    out.append(eq)

    rows: List[List[str]] = [TABLE_HEADER]
    for p in metrics.partitions:
        rows.append([
            f"{p}",
            f"{start_offsets[p]}",
            f"{end_offsets[p]}",
            f"{metrics.total(p)}",
            f"{metrics.alive(p)}",
            f"{metrics.tombstones(p)}",
            f"{metrics.dirty_ratio(p):.4f}",
            f"{metrics.key_null(p)}",
            f"{metrics.key_non_null(p)}",
            f"{metrics.key_size_sum(p) + metrics.value_size_sum(p)}",
            f"{metrics.key_size_sum(p)}",
            f"{metrics.value_size_sum(p)}",
            f"{metrics.key_size_avg(p)}",
            f"{metrics.value_size_avg(p)}",
            f"{metrics.message_size_avg(p)}",
        ])

    body = "\n".join(out) + "\n"
    # The legend comes *before* the table in the reference.
    body += LEGEND
    body += render_table(rows)
    body += "\n" + eq + "\n"
    body += _render_extensions(metrics) if show_extensions else ""
    return body


def _render_extensions(metrics: TopicMetrics) -> str:
    """Sketch lines, outside the reference-compatible block."""
    lines: List[str] = []
    if metrics.distinct_keys_hll is not None:
        lines.append(f"Distinct keys (HLL est.): {round(metrics.distinct_keys_hll)}")
    if metrics.distinct_keys_exact is not None:
        lines.append(f"Distinct keys (exact): {metrics.distinct_keys_exact}")
    if metrics.distinct_keys_hll_per_partition is not None:
        for p, est in zip(metrics.partitions, metrics.distinct_keys_hll_per_partition):
            lines.append(f"  partition {p} distinct keys (HLL est.): {round(est)}")
    if metrics.distinct_keys_exact_per_partition is not None:
        for p, n in zip(metrics.partitions, metrics.distinct_keys_exact_per_partition):
            lines.append(f"  partition {p} distinct keys (exact): {n}")
    if metrics.quantiles is not None:
        qs = " ".join(
            f"p{int(p * 100)}={v:.0f}B"
            for p, v in zip(metrics.quantiles.probs, metrics.quantiles.values)
        )
        lines.append(f"Message size quantiles: {qs}")
    if metrics.quantiles_per_partition is not None:
        for p, summary in zip(metrics.partitions, metrics.quantiles_per_partition):
            if any(math.isnan(v) for v in summary.values):
                # No sized (non-tombstone) messages in this partition.
                lines.append(f"  partition {p} size quantiles: n/a")
                continue
            qs = " ".join(
                f"p{int(q * 100)}={v:.0f}B"
                for q, v in zip(summary.probs, summary.values)
            )
            lines.append(f"  partition {p} size quantiles: {qs}")
    return ("\n".join(lines) + "\n") if lines else ""


def render_extremes_table(metrics: TopicMetrics) -> str:
    """``--extremes-table``: per-partition first/last timestamp and
    min/max sized message bytes; sentinel rows (no records / no sized
    records) show n/a."""
    if metrics.per_partition_extremes is None:
        return ""
    rows: List[List[str]] = [["P", "First Ts", "Last Ts", "Min-Sz", "Max-Sz"]]
    for p, e, l, s, g in metrics.extremes_decoded():
        rows.append([
            f"{p}",
            format_utc_seconds(e) if e is not None else "n/a",
            format_utc_seconds(l) if l is not None else "n/a",
            f"{s}" if s is not None else "n/a",
            f"{g}" if g is not None else "n/a",
        ])
    return "Per-partition extremes:\n" + render_table(rows)


def render_degraded_block(degraded: "Dict[int, str]") -> str:
    """Post-table warning block for partitions dropped mid-scan after
    exhausting their transport retry budget.  Rendered OUTSIDE the
    reference-compatible report (which stays byte-identical for clean
    scans): their table rows undercount, so the reader must see why."""
    if not degraded:
        return ""
    bang = "!" * 120
    lines = [bang, f"WARNING: {len(degraded)} partition(s) DEGRADED — "
                   "metrics below undercount their unscanned tails"]
    for p in sorted(degraded):
        lines.append(f"  partition {p}: {degraded[p]}")
    lines.append(
        "Rerun with --resume (snapshot written) once the cluster recovers."
    )
    lines.append(bang)
    return "\n".join(lines) + "\n"


def render_corrupt_block(corrupt: "Dict[int, dict]") -> str:
    """Post-table block for poisoned frames skipped/quarantined under
    --on-corruption.  Like the degraded block, rendered OUTSIDE the
    reference-compatible report: the scan COMPLETED, but the metrics
    exclude exactly the unreadable frames' records, and the reader must
    see what was lost and where the evidence went."""
    if not corrupt:
        return ""
    bar = "%" * 120
    frames = sum(d.get("frames", 0) for d in corrupt.values())
    quarantined = sum(d.get("quarantined", 0) for d in corrupt.values())
    lines = [
        bar,
        f"CORRUPT: {frames} unreadable frame(s) across "
        f"{len(corrupt)} partition(s) — skipped; metrics exclude exactly "
        "their records",
    ]
    for p in sorted(corrupt):
        d = corrupt[p]
        kinds = ", ".join(
            f"{k} x{n}" for k, n in sorted(d.get("kinds", {}).items())
        )
        where = f"partition {p}" if p >= 0 else "another process"
        lines.append(
            f"  {where}: {d.get('frames', 0)} frame(s), "
            f"{d.get('records', 0)} record(s), {d.get('bytes', 0)} bytes"
            + (f" [{kinds}]" if kinds else "")
            + (" — quarantined" if d.get("quarantined") else "")
        )
    if quarantined:
        lines.append(
            "Raw frames + JSON sidecars are spooled in --quarantine-dir."
        )
    else:
        lines.append(
            "Rerun with --on-corruption=quarantine --quarantine-dir to "
            "preserve the raw frames."
        )
    lines.append(bar)
    return "\n".join(lines) + "\n"


def render_data_loss_block(lost: "Dict[int, dict]") -> str:
    """Post-table block for offset ranges the log mutated out from under
    the scan (retention races, truncation after unclean election,
    resume-below-log-start).  Like the corrupt block, rendered OUTSIDE
    the reference-compatible report: the metrics describe exactly the
    surviving records, and the reader must see what the log took back —
    a truncation additionally marks the partition's fold
    non-authoritative (records already folded were replaced under the
    scan)."""
    if not lost:
        return ""
    bar = "#" * 120
    records = sum(d.get("records", 0) for d in lost.values())
    lines = [
        bar,
        f"DATA-LOSS: {records} record(s) across {len(lost)} partition(s) "
        "mutated out from under the scan — metrics cover exactly the "
        "surviving records",
    ]
    for p in sorted(lost):
        d = lost[p]
        reasons = ", ".join(
            f"{k} x{n}" for k, n in sorted(d.get("reasons", {}).items())
        )
        where = f"partition {p}" if p >= 0 else "another process"
        spans = ", ".join(
            f"[{s['start']}, {s['end']})" for s in d.get("spans", [])
        )
        lines.append(
            f"  {where}: {d.get('records', 0)} record(s) in "
            f"{d.get('ranges', 0)} range(s)"
            + (f" [{reasons}]" if reasons else "")
            + (f" at {spans}" if spans else "")
            + (
                ""
                if d.get("authoritative", True)
                else " — FOLD NON-AUTHORITATIVE (truncation replaced "
                     "already-counted records)"
            )
        )
    lines.append(bar)
    return "\n".join(lines) + "\n"


def _metric_total(snapshot: Optional[Dict], name: str) -> float:
    metric = (snapshot or {}).get(name)
    if metric is None:
        return 0.0
    return sum(s.get("value", 0.0) for s in metric["samples"])


def render_stage_stats(snapshot: Optional[Dict]) -> str:
    """``--stats`` per-stage digest from the registry snapshot — the same
    source the scan doctor attributes from (`results.StageDigest`)."""
    from kafka_topic_analyzer_tpu_torch.results import StageDigest

    digest = StageDigest.from_telemetry(snapshot)
    if not digest.stages:
        return ""
    lines = ["scan stages:"]
    for name, (secs, items, nbytes) in digest.stages.items():
        line = f"  {name}: {secs:.3f}s, {items} records"
        if items and secs > 0:
            line += f" ({items / secs:,.0f}/s)"
        if nbytes:
            line += f", {nbytes / 1e6:,.1f} MB"
            if secs > 0:
                line += f" ({nbytes / secs / 1e6:,.1f} MB/s)"
        lines.append(line)
    return "\n".join(lines) + "\n"


def render_bottleneck(diagnosis) -> str:
    """``--stats`` BOTTLENECK digest from an `obs.doctor.Diagnosis`: the
    verdict, the per-stage occupancy it was computed from, the evidence,
    and (when a flight recorder ran) the windowed verdict shares."""
    if diagnosis is None:
        return ""
    pct = lambda v: f"{v * 100.0:.0f}%"  # noqa: E731
    lines = [f"BOTTLENECK: {diagnosis.verdict} — {diagnosis.rationale}"]
    if diagnosis.stages:
        lines.append(
            "  occupancy: "
            + " | ".join(f"{s} {pct(v)}" for s, v in diagnosis.stages.items())
        )
    if diagnosis.evidence:
        lines.append(
            "  evidence: "
            + " | ".join(
                f"{k.replace('_', '-')} {pct(v)}"
                for k, v in sorted(diagnosis.evidence.items())
            )
        )
    if diagnosis.window_share:
        lines.append(
            "  windows: "
            + " | ".join(
                f"{v} {pct(share)}"
                for v, share in sorted(
                    diagnosis.window_share.items(), key=lambda kv: -kv[1]
                )
            )
        )
    return "\n".join(lines) + "\n"


def render_health(doc: "Optional[Dict]") -> str:
    """``--stats`` HEALTH digest from an alert-engine document
    (obs/health.HealthEngine.doc()): the verdict line plus one line per
    ACTIVE alert with its evidence — the same document /healthz serves,
    rendered once, so the operator's terminal and the liveness probe can
    never disagree."""
    if not doc:
        return ""
    firing = doc.get("firing") or []
    if not firing:
        return (
            f"HEALTH: ok ({doc.get('evaluations', 0)} evaluations, "
            "no active alerts)\n"
        )
    lines = [
        f"HEALTH: {len(firing)} active alert(s) "
        f"({doc.get('evaluations', 0)} evaluations)"
    ]
    for r in firing:
        where = f" [{r['topic']}]" if r.get("topic") else ""
        ev = r.get("evidence") or {}
        ev_text = ", ".join(f"{k}={v}" for k, v in sorted(ev.items()))
        lines.append(
            f"  {r['rule']}{where}: {r['state']} "
            f"{r.get('firing_s', 0) or 0:.0f}s — {r['summary']}"
            + (f" ({ev_text})" if ev_text else "")
        )
    return "\n".join(lines) + "\n"


def render_trends(findings: "Optional[List[dict]]") -> str:
    """``--stats`` TRENDS digest from the trend doctor's findings
    (obs/doctor.diagnose_trends over a history window) — empty string
    when the window is healthy or too short to judge."""
    if not findings:
        return ""
    lines = ["TRENDS:"]
    for f in findings:
        lines.append(f"  {f['summary']}")
    return "\n".join(lines) + "\n"


def _worker_sort_key(label: str):
    """Natural order of worker labels: numeric runs compare as numbers
    (``w2`` before ``w10``), as the reference sorts them."""
    return [int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", label)]


def render_telemetry_stats(
    snapshot: Optional[Dict],
    ingest_workers: int = 1,
    superbatch_k: int = 1,
    dispatch_depth: int = 1,
    wire=None,
    ingest_workers_per_controller: "Optional[List[int]]" = None,
) -> str:
    """``--stats`` telemetry section from a registry snapshot: the
    reference's counter digest, with the lines of the features the port
    has; under several controllers (``ingest_workers_per_controller``
    longer than one) the ingest line gives the fleet's workers and each
    controller's."""
    from kafka_topic_analyzer_tpu_torch.results import (
        DispatchStats,
        FollowStats,
        FusedStats,
        IngestStats,
        LossStats,
        SegmentStats,
    )

    if not snapshot:
        return ""
    t = lambda name: _metric_total(snapshot, name)  # noqa: E731
    lines = [
        "telemetry:",
        (
            f"  scan: {t('kta_scan_records_total'):,.0f} records, "
            f"{t('kta_scan_batches_total'):,.0f} batches, "
            f"{t('kta_scan_bytes_total') / 1e6:,.1f} MB"
        ),
        (
            f"  wire: {t('kta_fetch_requests_total'):,.0f} fetches "
            f"({t('kta_fetch_bytes_total') / 1e6:,.1f} MB), "
            f"{t('kta_fetch_errors_total'):,.0f} fetch errors, "
            f"{t('kta_metadata_reloads_total'):,.0f} metadata reloads"
        ),
        (
            f"  faults: {t('kta_transport_failures_total'):,.0f} transport "
            f"failures, {t('kta_connection_evictions_total'):,.0f} "
            f"evictions, {t('kta_backoff_sleeps_total'):,.0f} backoff "
            f"sleeps ({t('kta_backoff_sleep_seconds_total'):.2f}s), "
            f"{t('kta_retry_budget_exhaustions_total'):,.0f} budget "
            f"exhaustions"
        ),
        (
            f"  corruption: {t('kta_corrupt_frames_total'):,.0f} corrupt "
            f"frames ({t('kta_corrupt_records_total'):,.0f} records, "
            f"{t('kta_corrupt_bytes_total'):,.0f} B), "
            f"{t('kta_corrupt_quarantined_total'):,.0f} quarantined, "
            f"{t('kta_corrupt_refetches_total'):,.0f} disambiguation "
            f"re-fetches"
        ),
        (
            f"  state: {t('kta_snapshots_saved_total'):,.0f} snapshots "
            f"saved, {t('kta_scan_degraded_partitions'):,.0f} degraded "
            f"partitions"
        ),
    ]
    # Log-mutation digest: only when the log moved (or the fencing
    # machinery fired).
    loss = LossStats.from_telemetry(snapshot)
    if loss.ranges or loss.fences or loss.divergence_checks \
            or loss.watermark_regressions:
        reasons = ", ".join(
            f"{k}={v:,}" for k, v in sorted(loss.by_reason.items())
        )
        lines.append(
            f"  log-mutation: {loss.records:,} records lost in "
            f"{loss.ranges:,} range(s)"
            + (f" ({reasons})" if reasons else "")
            + f", {loss.fences:,} epoch fences, "
            f"{loss.divergence_checks:,} divergence checks, "
            f"{loss.watermark_regressions:,} watermark regressions"
        )
    seg = SegmentStats.from_telemetry(snapshot)
    if seg.files:
        lines.append(
            f"  segments: {seg.files:,} chunk(s) "
            f"({seg.bytes_mapped / 1e6:,.1f} MB mapped), "
            f"{seg.records:,.0f} records in {seg.batches:,.0f} batches"
        )
    # Remote-tier digest: what the object-store client fetched, retried
    # and served from the local cache (only when the scan spoke to one).
    if seg.gets:
        line = (
            f"  segstore: {seg.gets:,} GETs "
            f"({seg.bytes_fetched / 1e6:,.1f} MB fetched), "
            f"{seg.retries:,} retries"
        )
        if seg.cache_hits or seg.cache_misses or seg.cache_evictions:
            line += (
                f", cache {seg.cache_hits:,} hit(s) / "
                f"{seg.cache_misses:,} miss(es) / "
                f"{seg.cache_evictions:,} eviction(s)"
            )
        lines.append(line)
    if wire is not None:
        lines.append(
            f"  wire-format: v{wire.format}, "
            f"{wire.bytes_total / 1e6:,.1f} MB packed "
            f"({wire.bytes_per_record:,.1f} B/record), buffer split "
            f"{wire.per_record_bytes:,} B per-record + "
            f"{wire.table_bytes:,} B fold-table per {wire.batch_size:,}"
            f"-record buffer"
        )
        if wire.alive_compaction == "on":
            lines.append(
                f"  alive-compaction: on — {wire.pairs_raw:,} raw pairs "
                f"→ {wire.pairs_emitted:,} emitted "
                f"(ratio {wire.compaction_ratio:.3f})"
            )
        elif wire.alive_compaction != "n/a":
            lines.append(f"  alive-compaction: {wire.alive_compaction}")
    fused = FusedStats.from_telemetry(snapshot)
    if fused.rows or fused.fallbacks:
        line = (
            f"  fused: {fused.records:,.0f} records in {fused.rows:,} "
            f"row(s) via native decode→pack"
        )
        if fused.fallbacks:
            per = ", ".join(
                f"{r} {int(n):,}" for r, n in sorted(fused.fallbacks.items())
            )
            line += f" — fallbacks: {per}"
        lines.append(line)
    ingest = IngestStats.from_telemetry(snapshot)
    per_ctrl = ingest_workers_per_controller or []
    if len(per_ctrl) > 1:
        line = (
            f"  ingest: {sum(per_ctrl)} worker(s) across "
            f"{len(per_ctrl)} controller(s) "
            f"({'+'.join(str(v) for v in per_ctrl)})"
        )
    else:
        line = f"  ingest: {ingest_workers} worker(s)"
    if ingest.workers:
        per = ", ".join(
            # Controller-prefixed labels ("c0.3") carry their own letter.
            (f"w{w}" if w.isdigit() else w) + f" {n:,}" + (
                f" (stalled {ingest.stalls[w]:.1f}s)"
                if ingest.stalls.get(w, 0) >= 0.05 else ""
            )
            for w, n in sorted(
                ingest.workers.items(), key=lambda kv: _worker_sort_key(kv[0])
            )
        )
        line += f" — records {per}"
    lines.append(line)
    dispatch = DispatchStats.from_telemetry(snapshot)
    if dispatch.dispatches:
        lines.append(
            f"  dispatch: {dispatch.dispatches:,} superbatch dispatches "
            f"(K={superbatch_k}, depth={dispatch_depth}), "
            f"{dispatch.batches:,} batches folded, "
            f"{dispatch.mean_latency_ms:.1f} ms mean dispatch latency"
        )
    # Follow-service digest: polls/passes at the head plus the two
    # never-silent failure counters (only for --follow runs).
    follow = FollowStats.from_telemetry(snapshot)
    if follow.polls or follow.passes:
        lines.append(
            f"  follow: {follow.polls:,} watermark polls, "
            f"{follow.passes:,} fold passes, "
            f"{follow.report_snapshots:,} report snapshots published, "
            f"{follow.refresh_failures:,} refresh give-ups"
        )
    return "\n".join(lines) + "\n"


def attach_scan_digests(doc: dict, result, diagnosis=None) -> None:
    """The digest blocks every ``--json`` document carries: ``segments``
    when the scan read a segment store, ``wire`` for backends that pack
    rows, ``flight`` when a diagnosis was computed."""
    from kafka_topic_analyzer_tpu_torch.results import SegmentStats

    seg = SegmentStats.from_telemetry(result.telemetry)
    if seg.files:
        doc["segments"] = seg.as_dict()
    if result.wire is not None:
        doc["wire"] = result.wire.as_dict()
    if diagnosis is not None:
        doc["flight"] = diagnosis.as_dict()


def attach_issue_blocks(doc: dict, result) -> None:
    """The str-keyed ``corrupt_partitions``/``degraded_partitions``/
    ``data_loss`` maps of what the scan booked."""
    if result.corrupt_partitions:
        doc["corrupt_partitions"] = {
            str(p): d for p, d in result.corrupt_partitions.items()
        }
    if result.degraded_partitions:
        doc["degraded_partitions"] = {
            str(p): r for p, r in result.degraded_partitions.items()
        }
    if result.lost_partitions:
        doc["data_loss"] = {str(p): d for p, d in result.lost_partitions.items()}


def build_json_doc(
    topic: str,
    result,
    diagnosis=None,
    follow: "Optional[dict]" = None,
    windows: "Optional[dict]" = None,
    fleet: "Optional[dict]" = None,
    health: "Optional[dict]" = None,
) -> dict:
    """The machine-readable report document (``--json``), the reference's
    schema: ``result`` is an `engine.ScanResult`, ``diagnosis`` the scan
    doctor's verdict (`obs.doctor.diagnose_scan`); ``follow``,
    ``windows``, ``fleet`` and ``health`` are the service layer's blocks,
    which no batch scan carries."""
    doc = result.metrics.to_dict(result.start_offsets, result.end_offsets)
    doc["topic"] = topic
    doc["duration_secs"] = result.duration_secs
    doc["ingest_workers"] = result.ingest_workers
    doc["ingest_workers_per_controller"] = result.ingest_workers_per_controller
    doc["superbatch_k"] = result.superbatch_k
    doc["dispatch_depth"] = result.dispatch_depth
    doc["telemetry"] = result.telemetry
    attach_scan_digests(doc, result, diagnosis)
    if follow is not None:
        doc["follow"] = follow
    if windows is not None:
        doc["windows"] = windows
    if fleet is not None:
        doc["fleet"] = fleet
    if health is not None:
        doc["health"] = health
    attach_issue_blocks(doc, result)
    return doc


def render_fleet_status(rollup: dict) -> str:
    """The fleet status table and totals block of a rollup document
    (`fleet.report.build_fleet_rollup`): what ``--fleet`` prints after
    the per-topic reports and ``--stats`` writes to stderr.  The same
    document ``/report.json`` serves, so table and JSON agree."""
    fleet = rollup.get("fleet") or {}
    statuses: Dict[str, dict] = fleet.get("statuses") or {}
    eq = "=" * 120
    lines: List[str] = [eq]
    totals = fleet.get("totals") or {}
    lines.append(
        f"FLEET: {fleet.get('topics', 0)} topic(s) "
        f"(of {fleet.get('topics_discovered', 0)} discovered) — "
        f"{totals.get('records', 0)} records, "
        f"{totals.get('bytes', 0)} bytes, "
        f"lag {totals.get('lag', 0)}, "
        f"{totals.get('passes', 0)} pass(es)"
    )
    rows: List[List[str]] = [
        ["Topic", "Status", "P", "Records", "Bytes", "Lag", "W", "Passes",
         "Verdict"],
    ]
    for t in sorted(statuses):
        s = statuses[t]
        rows.append([
            t,
            s.get("status", "?"),
            f"{s.get('partitions', 0)}",
            f"{s.get('records', 0)}",
            f"{s.get('bytes', 0)}",
            f"{s.get('lag', 0)}",
            f"{s.get('workers', 0)}",
            f"{s.get('passes', 0)}",
            s.get("verdict", "") or "-",
        ])
    body = "\n".join(lines) + "\n" + render_table(rows)
    issues = [
        (t, statuses[t].get("error"))
        for t in sorted(statuses)
        if statuses[t].get("status") == "failed"
    ]
    if issues:
        bang = "!" * 120
        body += bang + "\n"
        body += (
            f"WARNING: {len(issues)} topic(s) FAILED — their rows above "
            "are partial; every other topic's results are unaffected\n"
        )
        for t, err in issues:
            body += f"  topic {t}: {err}\n"
        body += bang + "\n"
    return body + eq + "\n"
