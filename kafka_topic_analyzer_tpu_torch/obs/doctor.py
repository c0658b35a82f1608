"""Scan doctor: automated bottleneck attribution from telemetry (port of
the reference's ``obs/doctor.py``: `diagnose`, `diagnose_scan` and the
trend doctor `diagnose_trends` over the disk-backed telemetry history of
``obs/history.py``).

On CUDA the ``dispatch`` stage is host time: the throttle's real wait for
a CUDA event plus the enqueue of the fold's kernels.  A device that falls
behind therefore shows as throttle wait, as the reference's does.

Converts the manual BENCH_NOTES ledger procedure (rounds 7/9/10/11:
reconstruct per-stage seconds from counters, argue which stage gated the
scan) into computed, tested verdicts.  Inputs are the SAME merged
registry snapshot ``--json`` embeds and ``gather_telemetry`` aggregates
across controllers — so the fleet-wide verdict on a mesh scan falls out
of the counter merge algebra, with no extra collective.

The model is the engine drive loop (engine.run_scan): every wall second
of the scan is spent in exactly one stage window — ``ingest`` (blocked
waiting for the fan-in/prefetch to yield the next staged batch),
``dispatch`` (staging + launching the device fold, INCLUDING the
DispatchQueue throttle wait), ``snapshot``, or ``finalize``.  Per-stage
occupancy is each stage's share of the total accounted drive seconds
(self-normalizing, so merged multi-controller counters need no wall-clock
denominator).  Queue-theory evidence then separates the two interesting
verdicts:

- **ingest-bound** — the drive loop waits on ingest; the ingest workers
  are busy, not stalled (their queues are EMPTY: the consumer outruns
  them), and the dispatch throttle never engages.  The producers are the
  bottleneck.
- **dispatch-bound** — the drive loop sits in dispatch, and decisively in
  the throttle wait (``kta_dispatch_throttle_seconds_total``); the
  ingest workers stall on FULL queues.  The device (or the dispatch
  tunnel) is the bottleneck, and ingest parallelism cannot help.
- **balanced** — neither stage dominates (the pipeline overlap is doing
  its job), or too little was booked to call it.

Attribution rules (DESIGN.md §17): a stage verdict needs its occupancy
to clear ``DOMINANT`` (0.5) or to lead the runner-up by ``LEAD`` (2x).
Windowed verdicts apply the same rule to per-window deltas of a flight
recorder series, so a scan that changes regime mid-run (cold catalog
warmup, a broker fault, a device stall) shows the timeline instead of
one smeared average.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: Occupancy share that makes a stage the verdict on its own.
DOMINANT = 0.5
#: Or: lead over the runner-up stage that makes it the verdict.
LEAD = 2.0
#: Below this much booked drive time, refuse to attribute (an empty or
#: sub-millisecond scan has no signal worth a verdict).
MIN_ACCOUNTED_S = 1e-4


def _samples(snapshot: "Optional[dict]", name: str) -> "List[dict]":
    metric = (snapshot or {}).get(name)
    return metric["samples"] if metric else []


def _total(snapshot: "Optional[dict]", name: str) -> float:
    return float(sum(s.get("value", 0.0) for s in _samples(snapshot, name)))


def _by_label(snapshot: "Optional[dict]", name: str, label: str) -> "Dict[str, float]":
    return {
        s["labels"][label]: float(s["value"])
        for s in _samples(snapshot, name)
        if label in s.get("labels", {})
    }


@dataclasses.dataclass
class Diagnosis:
    """One scan's attribution: the ranked verdict plus the occupancy and
    evidence numbers it was computed from (never a bare label — the
    digest must be checkable against the same snapshot it came from)."""

    #: "ingest-bound" / "dispatch-bound" / "snapshot-bound" /
    #: "finalize-bound" / "balanced" / "no-signal".
    verdict: str
    #: One-line human rationale ("ingest-bound: workers 94% busy,
    #: dispatch queue empty 88% of samples").
    summary: str
    #: The evidence clause alone, without the leading verdict label —
    #: what renderers compose their own "BOTTLENECK: <verdict> — ..."
    #: line from (never re-parsed out of ``summary``).
    rationale: str
    #: stage -> fraction of accounted drive seconds, canonical order.
    stages: "Dict[str, float]"
    #: stage -> booked drive seconds (fleet totals under multi-controller).
    stage_seconds: "Dict[str, float]"
    #: Named evidence fractions (throttle_wait, worker_busy, ...).
    evidence: "Dict[str, float]"
    #: verdict -> share of flight-recorder windows ({} without a series).
    window_share: "Dict[str, float]"
    #: Per-window verdicts [{"t0", "t1", "verdict"}, ...] ([] without).
    windows: "List[dict]"
    #: Controllers the merged snapshot aggregates (1 = single process).
    controllers: int = 1

    def as_dict(self) -> dict:
        return {
            "verdict": self.verdict,
            "summary": self.summary,
            "rationale": self.rationale,
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
            "stage_seconds": {
                k: round(v, 6) for k, v in self.stage_seconds.items()
            },
            "evidence": {k: round(v, 4) for k, v in self.evidence.items()},
            "window_share": {
                k: round(v, 4) for k, v in self.window_share.items()
            },
            "windows": self.windows,
            "controllers": self.controllers,
        }


def _rank(stages: "Dict[str, float]") -> str:
    """Apply the dominance rule to a stage-occupancy map."""
    if not stages:
        return "no-signal"
    ordered = sorted(stages.items(), key=lambda kv: -kv[1])
    top_name, top = ordered[0]
    runner = ordered[1][1] if len(ordered) > 1 else 0.0
    if top >= DOMINANT or (runner > 0 and top / runner >= LEAD) or (
        runner == 0 and top > 0
    ):
        return f"{top_name}-bound"
    return "balanced"


def _window_verdicts(flight: "Optional[dict]") -> "List[dict]":
    """Per-window verdicts from a flight recorder series: the dominance
    rule over per-tick deltas of the live stage counters.

    Stage counters book at stage-window EXIT, so a single stage window
    longer than the sampling interval (a cold jit compile inside the
    first dispatch, a multi-second collective) reads as ``idle`` until
    it closes and then attributes its whole duration to the closing
    window.  The headline verdict is immune (it uses totals); read a
    large ``idle`` share next to a decisive headline as "few, long
    windows", not "nothing happening"."""
    if not flight:
        return []
    t = flight.get("t") or []
    tracks = flight.get("tracks") or {}
    stage_tracks = {
        name.split("stage_", 1)[1].rsplit("_s", 1)[0]: tracks[name]
        for name in tracks
        if name.startswith("stage_") and name.endswith("_s")
    }
    if len(t) < 2 or not stage_tracks:
        return []
    out: "List[dict]" = []
    for i in range(1, len(t)):
        deltas = {
            stage: max(0.0, series[i] - series[i - 1])
            for stage, series in stage_tracks.items()
            if len(series) == len(t)
        }
        accounted = sum(deltas.values())
        if accounted < MIN_ACCOUNTED_S:
            verdict = "idle"
        else:
            verdict = _rank(
                {s: d / accounted for s, d in deltas.items()}
            )
        out.append(
            {"t0": round(t[i - 1], 3), "t1": round(t[i], 3),
             "verdict": verdict}
        )
    return out


def diagnose(
    snapshot: "Optional[dict]",
    controllers: int = 1,
    dispatch_depth: int = 1,
    flight: "Optional[dict]" = None,
) -> Diagnosis:
    """Attribute the scan's bottleneck from a (merged) registry snapshot.

    ``snapshot`` is ``ScanResult.telemetry`` — already the cluster-wide
    merge under multi-controller, so every total below is a fleet total
    and the occupancy fractions are fleet averages.  ``flight`` is an
    optional ``FlightRecorder.series()`` dict; it adds the windowed
    timeline and the queue-empty/-full sample evidence, but the headline
    verdict never requires it (the counters are always booked)."""
    stage_seconds = {
        s: v
        for s, v in _by_label(
            snapshot, "kta_stage_seconds_total", "stage"
        ).items()
        # The flight recorder creates zero-valued stage children eagerly;
        # a stage that never ran carries no signal and no occupancy row.
        if v > 0
    }
    accounted = sum(stage_seconds.values())
    stages = (
        {s: v / accounted for s, v in stage_seconds.items()}
        if accounted > 0
        else {}
    )

    evidence: "Dict[str, float]" = {}
    throttle_s = _total(snapshot, "kta_dispatch_throttle_seconds_total")
    if accounted > 0:
        evidence["throttle_wait"] = throttle_s / accounted
        # fetch/decode run CONCURRENTLY on N ingest worker threads, so
        # these fractions are thread-seconds per accounted drive second
        # and legitimately exceed 1.0 on parallel scans — e.g. fetch 2.1
        # with 4 workers means the fleet of streams spent ~2 socket-wait
        # seconds per drive-loop second, i.e. ~0.5 per worker.
        evidence["fetch"] = (
            _total(snapshot, "kta_fetch_seconds_total") / accounted
        )
        evidence["decode"] = (
            _total(snapshot, "kta_decode_seconds_total") / accounted
        )
    stall = _by_label(
        snapshot, "kta_ingest_worker_stall_seconds_total", "worker"
    )
    active = _by_label(
        snapshot, "kta_ingest_worker_active_seconds_total", "worker"
    )
    active_total = sum(active.values())
    if active_total > 0:
        stall_total = sum(stall.get(w, 0.0) for w in active)
        evidence["worker_stall"] = min(1.0, stall_total / active_total)
        evidence["worker_busy"] = 1.0 - evidence["worker_stall"]

    # Sample-level evidence from the flight series: how often the fan-in
    # queues sat empty (consumer outran producers) and how often the
    # dispatch queue sat full (device outrun by everything else).
    if flight:
        tracks = flight.get("tracks") or {}
        qd = tracks.get("ingest_queue_depth") or []
        if qd:
            evidence["queue_empty"] = sum(
                1 for v in qd if v <= 0
            ) / len(qd)
        infl = tracks.get("dispatch_inflight") or []
        if infl and dispatch_depth >= 1:
            evidence["inflight_full"] = sum(
                1 for v in infl if v >= dispatch_depth
            ) / len(infl)

    if accounted < MIN_ACCOUNTED_S:
        verdict = "no-signal"
        rationale = "too little booked drive time to attribute"
    else:
        verdict = _rank(stages)
        rationale = _summarize(verdict, stages, evidence)

    windows = _window_verdicts(flight)
    window_share: "Dict[str, float]" = {}
    if windows:
        for w in windows:
            window_share[w["verdict"]] = (
                window_share.get(w["verdict"], 0.0) + 1
            )
        n = len(windows)
        window_share = {k: v / n for k, v in window_share.items()}

    return Diagnosis(
        verdict=verdict,
        summary=f"{verdict}: {rationale}",
        rationale=rationale,
        stages=dict(
            sorted(stages.items(), key=lambda kv: -kv[1])
        ),
        stage_seconds=stage_seconds,
        evidence=evidence,
        window_share=window_share,
        windows=windows,
        controllers=max(1, int(controllers)),
    )


def _summarize(
    verdict: str,
    stages: "Dict[str, float]",
    evidence: "Dict[str, float]",
) -> str:
    """The one-line rationale (evidence clause only — callers prepend
    the verdict label themselves)."""
    pct = lambda v: f"{v * 100.0:.0f}%"  # noqa: E731
    parts: "List[str]" = []
    if verdict == "ingest-bound":
        parts.append(
            f"drive loop waited on ingest {pct(stages.get('ingest', 0))} "
            "of accounted time"
        )
        if "worker_busy" in evidence:
            parts.append(f"workers {pct(evidence['worker_busy'])} busy")
        if "queue_empty" in evidence:
            parts.append(
                f"dispatch queue empty {pct(evidence['queue_empty'])} "
                "of samples"
            )
    elif verdict == "dispatch-bound":
        parts.append(
            f"device dispatch occupied {pct(stages.get('dispatch', 0))} "
            "of accounted time"
        )
        if evidence.get("throttle_wait", 0) > 0:
            parts.append(
                f"backpressure throttle {pct(evidence['throttle_wait'])}"
            )
        if "worker_stall" in evidence and evidence["worker_stall"] > 0.05:
            parts.append(
                f"workers stalled {pct(evidence['worker_stall'])} on "
                "full queues"
            )
        if "inflight_full" in evidence:
            parts.append(
                f"dispatch queue full {pct(evidence['inflight_full'])} "
                "of samples"
            )
    elif verdict == "balanced":
        top = sorted(stages.items(), key=lambda kv: -kv[1])[:2]
        parts.append(
            "no stage dominates ("
            + ", ".join(f"{s} {pct(v)}" for s, v in top)
            + ") — the pipeline overlap is working"
        )
    else:
        top = sorted(stages.items(), key=lambda kv: -kv[1])[:1]
        parts.extend(f"{s} {pct(v)} of accounted time" for s, v in top)
    return "; ".join(parts)


# -- trend doctor (DESIGN.md §22) ---------------------------------------------
#
# `diagnose` answers "what is the bottleneck RIGHT NOW" from the live
# ring; these verdicts answer "is this service getting WORSE" from a
# disk-backed history window (obs/history.HistoryStore.window format) —
# throughput droop vs the run's own trailing baseline, lag divergence
# (ETA ∞), retry/corruption storms, segstore fallback and cache-poison
# spikes, and the warm-cache verify residual.  Same evidence discipline
# as the live doctor: every finding carries the numbers it was computed
# from, never a bare label.  Epoch-aware: counter deltas difference only
# within a process lifetime (obs/history.track_delta), while rates keep
# the FULL wall denominator — a restart's dead time counts as quiet
# time, it is never collapsed out of the window.

#: Recent fraction of the window the droop/storm comparisons treat as
#: "now" (the leading 1-RECENT_FRAC is the trailing baseline).
RECENT_FRAC = 0.25
#: A recent rate below this multiple of the baseline is a droop.
DROOP_RATIO = 0.5
#: A recent fault rate above this multiple of the baseline is a storm
#: (with at least MIN_STORM_EVENTS recent events — a 0→2 blip on an
#: otherwise-silent counter is noise, not a storm).
STORM_RATIO = 3.0
MIN_STORM_EVENTS = 3
#: Verify-bound: sha-verify seconds per wall second above this share.
VERIFY_BOUND_SHARE = 0.25
#: Fetch-bound: scheduler queue-wait seconds per wall second above this
#: share flags the remote tier; queue depth vs in-flight then attributes
#: it (starved pool vs saturated wire).
FETCH_WAIT_SHARE = 0.25


def _split_window(window: dict) -> "Optional[tuple]":
    t = window.get("t") or []
    if len(t) < 4:
        return None
    t0, t1 = t[0], t[-1]
    if t1 <= t0:
        return None
    split = t1 - (t1 - t0) * RECENT_FRAC
    return t0, split, t1


def _sub(window: dict, lo: float, hi: float) -> dict:
    """Restrict a window dict to [lo, hi] (same shape)."""
    t = window.get("t") or []
    idx = [i for i, ts in enumerate(t) if lo <= ts <= hi]
    return {
        "t": [t[i] for i in idx],
        "epoch": [(window.get("epoch") or [1] * len(t))[i] for i in idx],
        "tracks": {
            name: [series[i] for i in idx]
            for name, series in (window.get("tracks") or {}).items()
        },
    }


def _rate_pair(window: dict, name: str) -> "Optional[tuple]":
    """(baseline_rate, recent_rate, recent_delta) across the split, or
    None when the window is too short to compare."""
    from kafka_topic_analyzer_tpu_torch.obs.history import (
        track_delta,
        track_rate,
    )

    parts = _split_window(window)
    if parts is None:
        return None
    t0, split, t1 = parts
    base = _sub(window, t0, split)
    recent = _sub(window, split, t1)
    if len(base.get("t") or []) < 2 or len(recent.get("t") or []) < 2:
        return None
    return (
        track_rate(base, name),
        track_rate(recent, name),
        track_delta(recent, name),
    )


def _storm(window: dict, track: str, kind: str, what: str) -> "Optional[dict]":
    pair = _rate_pair(window, track)
    if pair is None:
        return None
    base_rate, recent_rate, recent_events = pair
    if recent_events < MIN_STORM_EVENTS:
        return None
    if base_rate > 0 and recent_rate < STORM_RATIO * base_rate:
        return None
    return {
        "kind": kind,
        "summary": (
            f"{kind}: {what} at {recent_rate:.2f}/s in the recent window "
            f"vs {base_rate:.2f}/s baseline"
        ),
        "evidence": {
            "recent_per_s": round(recent_rate, 3),
            "baseline_per_s": round(base_rate, 3),
            "recent_events": int(recent_events),
        },
    }


def diagnose_trends(window: dict) -> "List[dict]":
    """Trend verdicts over one history window.  Returns [] for a healthy
    (or too-short) window; each finding is ``{"kind", "summary",
    "evidence"}`` with the evidence numbers the verdict was computed
    from.  Callers: the ``--stats`` TRENDS digest (cli._print_stats)
    and anything reading ``/history`` offline."""
    from kafka_topic_analyzer_tpu_torch.obs.history import track_points

    findings: "List[dict]" = []
    parts = _split_window(window)
    if parts is None:
        return findings
    t0, split, t1 = parts
    wall = t1 - t0

    # Throughput droop vs the run's own trailing baseline.
    pair = _rate_pair(window, "records")
    if pair is not None:
        base_rate, recent_rate, _ = pair
        if base_rate > 1.0 and recent_rate < DROOP_RATIO * base_rate:
            findings.append({
                "kind": "throughput-droop",
                "summary": (
                    f"throughput-droop: recent fold rate "
                    f"{recent_rate:,.0f}/s is "
                    f"{recent_rate / base_rate:.0%} of the trailing "
                    f"baseline {base_rate:,.0f}/s"
                ),
                "evidence": {
                    "recent_per_s": round(recent_rate, 1),
                    "baseline_per_s": round(base_rate, 1),
                    "ratio": round(recent_rate / base_rate, 3),
                },
            })

    # Lag divergence: the gap to the head grew over the window — at this
    # rate the scan never catches up (ETA ∞).
    lag_pts = track_points(window, "follow_lag")
    if len(lag_pts) >= 2:
        first, last = lag_pts[0], lag_pts[-1]
        growth = last[2] - first[2]
        if last[2] > 0 and growth > 0:
            findings.append({
                "kind": "lag-divergence",
                "summary": (
                    f"lag-divergence: lag grew {growth:,.0f} records over "
                    f"{wall:.0f}s ({growth / wall:,.1f}/s) — at this rate "
                    "the scan never catches up (ETA ∞)"
                ),
                "evidence": {
                    "lag": int(last[2]),
                    "lag_then": int(first[2]),
                    "growth_per_s": round(growth / wall, 2),
                    "eta": "inf",
                },
            })

    storm = _storm(window, "backoff_sleeps", "retry-storm",
                   "transport retries backing off")
    if storm:
        findings.append(storm)
    storm = _storm(window, "corrupt_frames", "corruption-storm",
                   "frames classifying corrupt")
    if storm:
        findings.append(storm)
    storm = _storm(window, "segstore_fallbacks", "segstore-fallback-spike",
                   "segment-store fallbacks (cache poison/stale/IO) booking")
    if storm:
        findings.append(storm)

    # Warm-cache verify residual: sha-verify on cache hits eating a
    # material share of the window, attributable from telemetry alone.
    # (The summary text is the reference's, word for word.)
    from kafka_topic_analyzer_tpu_torch.obs.history import track_delta

    verify_s = track_delta(window, "cache_verify_s")
    hit_bytes = track_delta(window, "cache_hit_bytes")
    if wall > 0 and hit_bytes > 0 and verify_s / wall >= VERIFY_BOUND_SHARE:
        findings.append({
            "kind": "verify-bound",
            "summary": (
                f"verify-bound: sha256 verification of cache hits consumed "
                f"{verify_s / wall:.0%} of the window "
                f"({hit_bytes / max(verify_s, 1e-9) / 1e6:,.0f} MB/s "
                "verified) — the warm re-audit is paying the "
                "verify-on-every-hit cost (BENCH round 14 residual)"
            ),
            "evidence": {
                "verify_seconds": round(verify_s, 3),
                "verify_share": round(verify_s / wall, 4),
                "hit_bytes": int(hit_bytes),
            },
        })

    # Fetch-bound attribution (io/fetchsched.py): requests spending a
    # material share of the window queued in the scheduler.  The queue
    # depth vs in-flight comparison says WHICH resource ran out —
    # scheduler starvation (queue persistently deeper than the worker
    # pool: --fetch-concurrency is too small for this stream count) vs
    # wire saturation (pool busy but the queue stays shallow: the link,
    # not the admission layer, is the limit).
    wait_s = track_delta(window, "fetch_sched_wait_s")
    if wall > 0 and wait_s / wall >= FETCH_WAIT_SHARE:
        queue_pts = track_points(window, "fetch_sched_queue")
        inflight_pts = track_points(window, "fetch_sched_inflight")
        mean_queue = (
            sum(p[2] for p in queue_pts) / len(queue_pts)
            if queue_pts else 0.0
        )
        mean_inflight = (
            sum(p[2] for p in inflight_pts) / len(inflight_pts)
            if inflight_pts else 0.0
        )
        starved = mean_queue > max(mean_inflight, 1.0)
        attribution = (
            "scheduler-starvation" if starved else "wire-saturation"
        )
        advice = (
            "raise --fetch-concurrency"
            if starved
            else "the wire is the limit — more workers will not help"
        )
        findings.append({
            "kind": "fetch-bound",
            "summary": (
                f"fetch-bound ({attribution}): requests spent "
                f"{wait_s / wall:.0%} of the window queued in the fetch "
                f"scheduler (mean queue {mean_queue:.1f} vs "
                f"{mean_inflight:.1f} in flight) — {advice}"
            ),
            "evidence": {
                "wait_seconds": round(wait_s, 3),
                "wait_share": round(wait_s / wall, 4),
                "mean_queue_depth": round(mean_queue, 2),
                "mean_inflight": round(mean_inflight, 2),
                "attribution": attribution,
            },
        })
    return findings


def diagnose_scan(result) -> Diagnosis:
    """`diagnose` over a finished (or in-flight follow) `ScanResult`,
    with the flight recorder folded in when one is active — the shared
    entry point for the CLI's --stats/--json paths and the follow
    service's /report.json publisher (serve/follow.py), so every surface
    attributes from the same evidence."""
    from kafka_topic_analyzer_tpu_torch.obs import flight as _flight

    rec = _flight.active()
    if rec is not None:
        # Close the timeline before reading it: the session-owned recorder
        # is still sampling (teardown stops it later), and a scan shorter
        # than the sampling interval would otherwise diagnose from an
        # empty series.
        rec.sample_once()
    return diagnose(
        result.telemetry,
        controllers=max(1, len(result.ingest_workers_per_controller)),
        dispatch_depth=result.dispatch_depth,
        flight=rec.series() if rec is not None else None,
    )
