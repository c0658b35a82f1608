"""Scan doctor: automated bottleneck attribution from telemetry (port of
the reference's ``obs/doctor.py``: `diagnose` and `diagnose_scan`.  The
trend doctor — ``diagnose_trends`` and its droop/storm rules — reads the
disk-backed telemetry history of ``obs/history.py``, which is not ported
yet, and is left out with it).

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


def diagnose_scan(result) -> Diagnosis:
    """`diagnose` over a finished (or in-flight follow) `ScanResult`,
    with the flight recorder folded in when one is active — the shared
    entry point for the CLI's --stats/--json paths and the follow
    service's /report.json publisher once follow mode is ported, so every
    surface attributes from the same evidence."""
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
        controllers=1,  # the port runs one controller
        dispatch_depth=result.dispatch_depth,
        flight=rec.series() if rec is not None else None,
    )
