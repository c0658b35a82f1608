"""Hold a report document against the reference's.

Each number compared is the worst over the documents judged, and each has
a limit of its own in the cell's workload file:

- ``counters_mismatch``: per-partition fields (the seven counters, the
  dirty ratio, the three averages, start and end offsets) and the overall
  count and bytes that differ; exact.
- ``extremes_mismatch``: the overall time and size extremes and the
  per-partition ones that differ; exact.
- ``alive_keys_gap``: |alive keys - reference| (``-c`` only).
- ``hll_rel_gap``: the largest relative gap of the global and
  per-partition distinct-key estimates (with HLL only).
- ``quantile_rel_gap``: the largest relative gap of the global and
  per-partition size quantiles (with quantiles only).
"""

from __future__ import annotations

import math

from benchmark.reference.report import CHANNELS

ROW_FIELDS = CHANNELS + ("dirty_ratio", "key_size_avg", "value_size_avg",
                         "message_size_avg", "start_offset", "end_offset")
OVERALL_COUNTERS = ("count", "size_bytes")
OVERALL_EXTREMES = ("earliest_ts", "latest_ts", "largest_message", "smallest_message")


def _rel_gap(got, want) -> float:
    if got is None or want is None:
        return math.inf
    got, want = float(got), float(want)
    if got == want:  # also inf == inf
        return 0.0
    if math.isnan(got) and math.isnan(want):
        return 0.0
    return abs(got - want) / max(abs(want), 1e-300)


def compare(doc: dict, ref: dict) -> "dict[str, float]":
    out = {}
    bad = 0
    parts = doc.get("partitions", {})
    if set(parts) != set(ref["partitions"]):
        bad += len(set(parts) ^ set(ref["partitions"]))
    for p, want in ref["partitions"].items():
        got = parts.get(p, {})
        bad += sum(got.get(f) != want[f] for f in ROW_FIELDS)
    overall = doc.get("overall", {})
    bad += sum(overall.get(f) != ref["overall"][f] for f in OVERALL_COUNTERS)
    out["counters_mismatch"] = bad
    bad = sum(overall.get(f) != ref["overall"][f] for f in OVERALL_EXTREMES)
    got_ext = doc.get("extremes_per_partition", {})
    for p, want in ref["extremes_per_partition"].items():
        got = got_ext.get(p, {})
        bad += sum(got.get(f) != v for f, v in want.items())
    out["extremes_mismatch"] = bad
    if "alive_keys" in ref:
        got = doc.get("alive_keys")
        out["alive_keys_gap"] = math.inf if got is None else abs(got - ref["alive_keys"])
    if "distinct_keys_hll" in ref:
        gaps = [_rel_gap(doc.get("distinct_keys_hll"), ref["distinct_keys_hll"])]
        got_pp = doc.get("distinct_keys_hll_per_partition", {})
        for p, want in ref.get("distinct_keys_hll_per_partition", {}).items():
            gaps.append(_rel_gap(got_pp.get(p), want))
        out["hll_rel_gap"] = max(gaps)
    if "size_quantiles" in ref:
        rows = [(doc.get("size_quantiles", {}), ref["size_quantiles"])]
        got_pp = doc.get("size_quantiles_per_partition", {})
        for p, want in ref.get("size_quantiles_per_partition", {}).items():
            rows.append((got_pp.get(p, {}), want))
        out["quantile_rel_gap"] = max(
            _rel_gap(got.get(q), v) for got, want in rows for q, v in want.items())
    return out


def worst(readings: "list[dict[str, float]]") -> "dict[str, float]":
    """The largest reading of each number over several documents."""
    out: "dict[str, float]" = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: "dict[str, float]", limits: "dict[str, float]") -> bool:
    """Every number at or under its limit; a number without a limit fails."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
