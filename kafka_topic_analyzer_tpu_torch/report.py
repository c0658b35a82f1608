"""Terminal report renderer, byte-compatible with the reference (port of
the reference's ``report.py``: `render_report` and its extension lines).

Reproduces the report block of xenji/kafka-topic-analyzer's
``src/main.rs:123-179``: the global lines, the optional alive-keys block,
the legend and the 15-column per-partition table.  HLL and quantile lines
follow after the reference-compatible block.
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
