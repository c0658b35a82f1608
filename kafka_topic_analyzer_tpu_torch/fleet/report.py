"""The cluster rollup document (port of the reference's
``fleet/report.py``): the totals, the top topics by records, bytes and
lag, and the per-topic status rows above the per-topic documents (which
stay the solo ``--json`` schema, `report.build_json_doc`).  ``--fleet
--json`` prints it, ``--stats`` tabulates it (`report.
render_fleet_status`), and the bare ``/report.json`` serves it while a
fleet runs.
"""

from __future__ import annotations

from typing import Dict, List

#: Rows in each "top topics by X" list.
TOP_N = 5


def _top(statuses: "Dict[str, object]", key: str) -> "List[dict]":
    ranked = sorted(
        ((t, getattr(s, key)) for t, s in statuses.items()),
        key=lambda kv: (-kv[1], kv[0]),
    )
    return [{"topic": t, key: v} for t, v in ranked[:TOP_N] if v > 0]


def build_fleet_rollup(
    statuses: "Dict[str, object]",
    discovered: int,
    duration_secs: int,
    health: "dict | None" = None,
    instance: "str | None" = None,
    instances: "List[str] | None" = None,
) -> dict:
    """``statuses`` maps topic -> `fleet.service.TopicStatus`; ``health``
    is the alert engine's latest document; ``instance`` names the analyzer
    that built this rollup and ``instances`` every instance the lease
    store shows (a rollup covers only its own instance's topics)."""
    counts: "Dict[str, int]" = {}
    verdicts: "Dict[str, int]" = {}
    for s in statuses.values():
        counts[s.status] = counts.get(s.status, 0) + 1
        if getattr(s, "verdict", ""):
            verdicts[s.verdict] = verdicts.get(s.verdict, 0) + 1
    doc = {
        "fleet": {
            "topics_discovered": discovered,
            "topics": len(statuses),
            "status_counts": dict(sorted(counts.items())),
            "verdict_counts": dict(sorted(verdicts.items())),
            "totals": {
                "records": sum(s.records for s in statuses.values()),
                "bytes": sum(s.bytes for s in statuses.values()),
                "lag": sum(s.lag for s in statuses.values()),
                "passes": sum(s.passes for s in statuses.values()),
            },
            "top_topics": {
                "by_records": _top(statuses, "records"),
                "by_bytes": _top(statuses, "bytes"),
                "by_lag": _top(statuses, "lag"),
            },
            "statuses": {t: statuses[t].as_dict() for t in sorted(statuses)},
        },
        "duration_secs": duration_secs,
    }
    if instance is not None:
        doc["fleet"]["instance"] = instance
    if instances is not None:
        doc["fleet"]["instances"] = list(instances)
    if health is not None:
        doc["health"] = health
    return doc
