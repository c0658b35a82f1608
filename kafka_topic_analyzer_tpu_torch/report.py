"""Terminal report renderer, byte-compatible with the reference (port of
the reference's ``report.py``: `render_report` and its extension lines).

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
from typing import Dict, List

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
    if metrics.distinct_keys_hll_per_partition is not None:
        for p, est in zip(metrics.partitions, metrics.distinct_keys_hll_per_partition):
            lines.append(f"  partition {p} distinct keys (HLL est.): {round(est)}")
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
