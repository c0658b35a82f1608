"""Declarative alert-rule engine: automated health verdicts (port of the
reference's ``obs/health.py``; DESIGN.md §22).  The fleet-only rules
(``fleet-topic-failure``, ``lease_lost``, ``failover``) read what the
fleet service (fleet/service.py) and its lease manager (fleet/lease.py)
book: the failed topics of each poll, ``kta_lease_losses_total`` and
``kta_fleet_failovers_total``.

The scan doctor answers "what is the bottleneck"; nothing in the system
answers "is this service HEALTHY" without a human reading ``--stats``.
This module is that layer: a small rule engine evaluated at poll
boundaries (follow/fleet) and heartbeat boundaries (batch scans) over
registry snapshots and short observed windows, with the alerting
semantics a pager expects —

- **threshold + for-duration**: a rule's condition must hold
  continuously for ``for_s`` before the alert fires (a one-poll blip
  never pages);
- **resolve hysteresis**: a firing alert must observe its condition
  clear continuously for ``resolve_s`` before it resolves (a flapping
  condition re-arms the firing state without emitting a second
  ``alert_firing`` event — flap suppression);
- **no silent state changes**: EVERY transition of the per-rule state
  machine (ok → pending → firing → resolving → ok) books
  ``kta_alerts_transitions_total{rule=,state=}`` — the alert trace is
  reconstructible from the counter alone (tools/lint.sh rule 12), and
  the set of currently-active alerts is ``kta_alerts_firing{rule=}``.

Transitions also emit typed events on the JSONL bus (``alert_pending``,
``alert_firing``, ``alert_resolving``, ``alert_resolved``,
``alert_cleared`` for a pending blip that never fired), and every
evaluation publishes a pre-serialized health document — the ``health``
block of ``/report.json`` and ``--stats``, and the body ``/healthz``
serves (200 while healthy, 503 with the firing-rule JSON otherwise —
fit for a k8s liveness probe).  The HTTP handler reads ONLY the
``healthz``/``doc`` snapshot accessors (rule 9): serialization happens
here, on the evaluating side, never per probe.

The engine is clock-injectable like Spinner/Backoff; tests drive
``evaluate`` with a fake clock and scripted snapshots and never sleep.
State is per (rule, scope): fleet mode evaluates per-topic rules once
per topic (scope = the topic name), so ``/report.json?topic=`` carries
exactly that topic's alerts while the bare rollup carries all of them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.config import HealthConfig
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

#: Rule states (the transitions counter's ``state`` label values).
OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVING = "resolving"

#: An alert counts as ACTIVE (unhealthy) while firing or resolving —
#: resolve hysteresis means "not yet proven healed".
ACTIVE_STATES = (FIRING, RESOLVING)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule.  ``predicate(ctx)`` returns an evidence
    dict while the condition holds and None while it is clear — the
    evidence rides the events, the health document, and ``--stats``
    (same discipline as the doctor: never a bare label)."""

    name: str
    #: What firing MEANS, for humans ("follow lag diverging...").
    summary: str
    predicate: "Callable[[EvalContext], Optional[dict]]"
    #: Condition must hold this long before the alert fires.
    for_s: float = 0.0
    #: Condition must stay clear this long before the alert resolves.
    resolve_s: float = 0.0
    #: Fleet mode: evaluate once per topic in ``extras['topics']``
    #: (scope = topic name) instead of once globally.
    per_topic: bool = False


class EvalContext:
    """What a predicate sees: the registry snapshot, the engine's
    observed scalar series (short in-memory windows, clock-stamped),
    the optional disk history, caller extras, and the scope topic."""

    def __init__(
        self,
        engine: "HealthEngine",
        snapshot: "Optional[dict]",
        now: float,
        extras: "Optional[dict]" = None,
        topic: "Optional[str]" = None,
    ):
        self.engine = engine
        self.snapshot = snapshot or {}
        self.now = now
        self.extras = extras or {}
        self.topic = topic
        self.cfg = engine.cfg

    def total(self, metric: str) -> float:
        """Sum of a snapshot metric's sample values (0.0 when absent)."""
        m = self.snapshot.get(metric)
        if not m:
            return 0.0
        return float(sum(s.get("value", 0.0) for s in m["samples"]))

    def value(self, series: str) -> "Optional[float]":
        """Latest observed value of an engine series."""
        obs = self.engine._series.get(series)
        return obs[-1][1] if obs else None

    def at(self, series: str, age_s: float) -> "Optional[Tuple[float, float]]":
        """The newest observation at least ``age_s`` old: (t, value), or
        None when the series has not been observed that long — rules
        refuse to fire on a window they have not actually watched."""
        obs = self.engine._series.get(series)
        if not obs:
            return None
        cutoff = self.now - age_s
        best = None
        for t, v in obs:
            if t <= cutoff:
                best = (t, v)
            else:
                break
        return best

    def delta(self, series: str, age_s: float, strict: bool = False) -> "Optional[float]":
        """Increase of a cumulative series over the trailing window.
        When the series does not yet span the window, the non-strict
        form differences against the OLDEST observation — a shorter
        span yields a conservative subset of the window's delta, which
        is the right call for threshold rules (a fault counter moving
        at all should not wait a full window to be noticed).  ``strict``
        returns None instead (rules comparing rates across specific
        spans need the real window)."""
        now_v = self.value(series)
        if now_v is None:
            return None
        then = self.at(series, age_s)
        if then is None:
            if strict:
                return None
            obs = self.engine._series.get(series)
            if not obs or len(obs) < 2:
                return None
            then = obs[0]
        return now_v - then[1]


@dataclasses.dataclass
class _RuleState:
    state: str = OK
    #: Clock time the CURRENT state was entered.
    since: float = 0.0
    #: Clock time the alert last fired (entered FIRING from ok/pending).
    fired_at: float = 0.0
    evidence: "Optional[dict]" = None


class HealthEngine:
    """Own the rule states and the published health document.

    ``evaluate(snapshot, extras)`` runs one pass (services call it at
    their poll boundaries); ``maybe_evaluate()`` is the rate-limited
    form the engine drive loop calls at heartbeat cadence (it snapshots
    the default registry itself).  Both publish the serialized document
    under the engine lock — the ``/healthz`` handler reads one
    reference.
    """

    #: (series name, reader over a snapshot) — the scalar series the
    #: engine observes each evaluation for windowed rule predicates.
    SERIES: "List[Tuple[str, str]]" = [
        ("lag", "kta_follow_lag_records"),
        ("records", "kta_scan_records_total"),
        ("refresh_failures", "kta_watermark_refresh_failures_total"),
        ("corrupt_frames", "kta_corrupt_frames_total"),
        ("degraded", "kta_scan_degraded_partitions"),
        ("backoff_sleeps", "kta_backoff_sleeps_total"),
        ("segstore_fallbacks", "kta_segstore_fallback_total"),
        ("lease_losses", "kta_lease_losses_total"),
        ("failovers", "kta_fleet_failovers_total"),
        ("lost_records", "kta_log_lost_records_total"),
        ("lost_ranges", "kta_log_lost_ranges_total"),
        ("watermark_regressions", "kta_log_watermark_regressions_total"),
    ]

    def __init__(
        self,
        rules: "Optional[List[AlertRule]]" = None,
        cfg: "Optional[HealthConfig]" = None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        history=None,
    ):
        self.cfg = cfg if cfg is not None else HealthConfig()
        self.rules = (
            list(rules) if rules is not None else built_in_rules(self.cfg)
        )
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self._clock = clock
        self._wall_clock = wall_clock
        self.history = history
        self._lock = threading.Lock()
        #: The last non-None extras (the fleet's per-topic lag map and
        #: failed set).  Extras-free evaluations — the engine-drive-loop
        #: heartbeat hook fires DURING topic passes — reuse it, so an
        #: extras-derived condition (fleet-topic-failure) cannot flap
        #: ok↔firing between poll boundaries just because an evaluator
        #: had no context; staleness is bounded by one fleet poll.
        self._last_extras: "Optional[dict]" = None
        self._states: "Dict[Tuple[str, Optional[str]], _RuleState]" = {}
        self._series: "Dict[str, Deque[Tuple[float, float]]]" = {}
        self._doc: "Optional[dict]" = None
        self._doc_bytes: "Optional[bytes]" = None
        self._healthy = True
        self._last_eval: "Optional[float]" = None
        self.evaluations = 0

    # -- evaluation -----------------------------------------------------------

    def maybe_evaluate(self, extras: "Optional[dict]" = None) -> None:
        """Evaluate at most once per ``cfg.eval_interval_s`` — the
        engine-drive-loop hook (engine.run_scan's heartbeat path), so a
        plain batch scan gets live ``/healthz`` too."""
        now = self._clock()
        with self._lock:
            if (
                self._last_eval is not None
                and now - self._last_eval < self.cfg.eval_interval_s
            ):
                return
        self.evaluate(extras=extras)

    def evaluate(
        self,
        snapshot: "Optional[dict]" = None,
        extras: "Optional[dict]" = None,
    ) -> dict:
        """One evaluation pass: observe the series, run every rule's
        state machine, publish the health document.  ``snapshot``
        defaults to a fresh default-registry snapshot (the poll-boundary
        callers pass nothing)."""
        if snapshot is None:
            from kafka_topic_analyzer_tpu_torch.obs.registry import (
                default_registry,
            )

            snapshot = default_registry().snapshot()
        now = self._clock()
        with self._lock:
            if extras is not None:
                self._last_extras = extras
            extras = self._last_extras
            self._last_eval = now
            self.evaluations += 1
            self._observe(snapshot, now, extras)
            rows: "List[dict]" = []
            for rule in self.rules:
                scopes: "List[Optional[str]]"
                if rule.per_topic:
                    # Fleet mode: one state per topic.  Scopes that
                    # already hold state keep being evaluated even when
                    # this evaluation carries no topic context (the
                    # heartbeat path) — a published document must never
                    # DROP a firing per-topic row just because the
                    # evaluator had no extras.  Without any topic map
                    # (solo follow, batch scans) the rule evaluates
                    # once, unscoped, over the global series.
                    topics = set((extras or {}).get("topics", {}))
                    topics |= {
                        s
                        for (rname, s) in self._states
                        if rname == rule.name and s is not None
                    }
                    scopes = sorted(topics) if topics else [None]
                else:
                    scopes = [None]
                for scope in scopes:
                    ctx = EvalContext(
                        self, snapshot, now, extras, topic=scope
                    )
                    rows.append(self._eval_rule(rule, scope, ctx, now))
            doc = self._build_doc(rows, now)
            self._doc = doc
            self._doc_bytes = json.dumps(doc).encode()
            self._healthy = doc["healthy"]
        obs_metrics.HEALTH_EVALUATIONS.inc()
        return doc

    def _observe(
        self, snapshot: dict, now: float, extras: "Optional[dict]"
    ) -> None:
        """Record the windowed scalar series this evaluation sees.
        Retention is the longest rule window plus slack."""
        keep = self.cfg.retention_s

        def push(name: str, v: float) -> None:
            obs = self._series.setdefault(name, deque())
            obs.append((now, float(v)))
            while obs and now - obs[0][0] > keep:
                obs.popleft()

        ctx = EvalContext(self, snapshot, now)
        for name, metric in self.SERIES:
            push(name, ctx.total(metric))
        # Truncation is one REASON of the lost-records counter — the
        # truncation rule needs it split out (a retention race is routine
        # under short retention; a truncation never is).
        lost_metric = snapshot.get("kta_log_lost_records_total") or {}
        push(
            "truncated_records",
            float(
                sum(
                    s.get("value", 0.0)
                    for s in lost_metric.get("samples", [])
                    if s.get("labels", {}).get("reason") == "truncation"
                )
            ),
        )
        for topic, lag in ((extras or {}).get("topics") or {}).items():
            push(f"topic:{topic}:lag", float(lag))
        for topic, records in (
            (extras or {}).get("topic_loss") or {}
        ).items():
            push(f"topic:{topic}:lost", float(records))

    def _eval_rule(
        self,
        rule: AlertRule,
        scope: "Optional[str]",
        ctx: EvalContext,
        now: float,
    ) -> dict:
        key = (rule.name, scope)
        st = self._states.setdefault(key, _RuleState(since=now))
        try:
            evidence = rule.predicate(ctx)
        except Exception:
            # A broken rule must never take the service down — health is
            # telemetry, and telemetry is best-effort by contract.
            log.exception("alert rule %r predicate failed", rule.name)
            evidence = None
        cond = evidence is not None
        if st.state == OK and cond:
            if rule.for_s > 0:
                self._transition(rule, scope, st, PENDING, now, evidence)
            else:
                self._transition(rule, scope, st, FIRING, now, evidence)
        elif st.state == PENDING:
            if not cond:
                self._transition(rule, scope, st, OK, now, None)
            elif now - st.since >= rule.for_s:
                self._transition(rule, scope, st, FIRING, now, evidence)
            else:
                st.evidence = evidence
        elif st.state == FIRING:
            if cond:
                st.evidence = evidence
            elif rule.resolve_s > 0:
                self._transition(rule, scope, st, RESOLVING, now, None)
            else:
                self._transition(rule, scope, st, OK, now, None)
        elif st.state == RESOLVING:
            if cond:
                # Flap suppression: the re-armed firing state books its
                # transition but emits no second alert_firing event and
                # re-increments no gauge — the alert never resolved.
                self._transition(rule, scope, st, FIRING, now, evidence)
            elif now - st.since >= rule.resolve_s:
                self._transition(rule, scope, st, OK, now, None)
        return {
            "rule": rule.name,
            "topic": scope,
            "state": st.state,
            "since_s": round(max(0.0, now - st.since), 3),
            "firing_s": (
                round(max(0.0, now - st.fired_at), 3)
                if st.state in ACTIVE_STATES
                else None
            ),
            "summary": rule.summary,
            "evidence": st.evidence,
        }

    def _transition(
        self,
        rule: AlertRule,
        scope: "Optional[str]",
        st: _RuleState,
        new: str,
        now: float,
        evidence: "Optional[dict]",
    ) -> None:
        """The ONE place rule state changes (tools/lint.sh rule 12):
        every transition books kta_alerts_transitions_total{rule,state};
        entering/leaving the active set moves kta_alerts_firing{rule}
        and emits the typed event."""
        prev = st.state
        obs_metrics.ALERTS_TRANSITIONS.labels(rule=rule.name, state=new).inc()
        fields = dict(rule=rule.name, state=new)
        if scope is not None:
            fields["topic"] = scope
        if evidence:
            fields["evidence"] = evidence
        if new == FIRING and prev in (OK, PENDING):
            obs_metrics.ALERTS_FIRING.labels(rule=rule.name).inc(1.0)
            st.fired_at = now
            obs_events.emit("alert_firing", **fields)
        elif new == OK and prev in ACTIVE_STATES:
            obs_metrics.ALERTS_FIRING.labels(rule=rule.name).inc(-1.0)
            obs_events.emit("alert_resolved", **fields)
        elif new == PENDING:
            obs_events.emit("alert_pending", **fields)
        elif new == RESOLVING:
            obs_events.emit("alert_resolving", **fields)
        elif new == OK and prev == PENDING:
            obs_events.emit("alert_cleared", **fields)
        st.state = new
        st.since = now
        st.evidence = evidence if evidence else (
            st.evidence if new in ACTIVE_STATES else None
        )

    def _build_doc(self, rows: "List[dict]", now: float) -> dict:
        active = [r for r in rows if r["state"] in ACTIVE_STATES]
        return {
            "healthy": not active,
            "evaluations": self.evaluations,
            "evaluated_at": round(self._wall_clock(), 3),
            "firing": active,
            "rules": rows,
        }

    # -- read side (the rule-9 snapshot accessors) ---------------------------

    def doc(self) -> "Optional[dict]":
        """Latest health document (None before the first evaluation)."""
        with self._lock:
            return self._doc

    def healthz(self) -> "Optional[Tuple[int, bytes]]":
        """(status_code, body) for the ``/healthz`` probe: 200 while no
        alert is active, 503 with the firing-rule JSON otherwise; None
        before the first evaluation (the handler serves 503 for that —
        an unevaluated service must not claim liveness)."""
        with self._lock:
            if self._doc_bytes is None:
                return None
            return (200 if self._healthy else 503), self._doc_bytes

    def healthz_entry(self) -> "Optional[Tuple[int, bytes, str]]":
        """(status_code, body, etag) for conditional ``/healthz`` GETs
        (DESIGN §26).  The evaluation count is the strong validator:
        ``_doc_bytes`` is re-serialized exactly once per evaluation
        (``evaluated_at``/``since_s`` move every pass, so each count
        really is a distinct body), and both are assigned in the same
        critical section of ``evaluate``."""
        with self._lock:
            if self._doc_bytes is None:
                return None
            return (
                (200 if self._healthy else 503),
                self._doc_bytes,
                f'"e{self.evaluations}"',
            )

    def alerts_block(self, topic: "Optional[str]" = None) -> "Optional[dict]":
        """The ``health`` block a report document embeds.  With
        ``topic``: only that topic's scoped alerts plus the global ones
        (what ``/report.json?topic=`` should show); without: the whole
        document."""
        with self._lock:
            if self._doc is None:
                return None
            if topic is None:
                return self._doc
            rows = [
                r
                for r in self._doc["rules"]
                if r["topic"] in (None, topic)
            ]
            active = [r for r in rows if r["state"] in ACTIVE_STATES]
            return {
                "healthy": not active,
                "evaluations": self._doc["evaluations"],
                "evaluated_at": self._doc["evaluated_at"],
                "firing": active,
                "rules": rows,
            }


# -- built-in rules -----------------------------------------------------------


def _lag_series(ctx: EvalContext) -> str:
    return f"topic:{ctx.topic}:lag" if ctx.topic is not None else "lag"


def _lag_growth(ctx: EvalContext) -> "Optional[dict]":
    """Lag divergence: the cursor is behind AND the gap has grown over
    the rule window — at this rate the scan never catches up (ETA ∞)."""
    cfg = ctx.cfg
    series = _lag_series(ctx)
    lag = ctx.engine._series.get(series)
    lag_now = lag[-1][1] if lag else None
    if lag_now is None or lag_now <= 0:
        return None
    then = ctx.at(series, cfg.lag_window_s)
    if then is None:
        return None  # not watched long enough to call divergence
    t_then, lag_then = then
    growth = lag_now - lag_then
    if growth < cfg.lag_min_growth:
        return None
    dt = max(1e-9, ctx.now - t_then)
    return {
        "lag": int(lag_now),
        "lag_then": int(lag_then),
        "window_s": round(dt, 1),
        "growth_per_s": round(growth / dt, 2),
        "eta": "inf",
    }


def _degraded(ctx: EvalContext) -> "Optional[dict]":
    n = ctx.total("kta_scan_degraded_partitions")
    if n <= 0:
        return None
    return {"degraded_partitions": int(n)}


def _corruption_storm(ctx: EvalContext) -> "Optional[dict]":
    d = ctx.delta("corrupt_frames", ctx.cfg.storm_window_s)
    if d is None or d < ctx.cfg.corrupt_frames_threshold:
        return None
    return {
        "corrupt_frames": int(d),
        "window_s": ctx.cfg.storm_window_s,
    }


def _watermark_outage(ctx: EvalContext) -> "Optional[dict]":
    d = ctx.delta("refresh_failures", ctx.cfg.outage_window_s)
    if d is None or d <= 0:
        return None
    return {
        "refresh_failures": int(d),
        "window_s": ctx.cfg.outage_window_s,
    }


def _throughput_regression(ctx: EvalContext) -> "Optional[dict]":
    """Recent fold rate collapsed against the trailing baseline while
    there is still work (lag > 0) — an idle service at the head is
    healthy, a backed-up one folding at a fraction of its own baseline
    is not."""
    cfg = ctx.cfg
    lag_now = ctx.value(_lag_series(ctx))
    if not lag_now or lag_now <= 0:
        return None
    now_v = ctx.value("records")
    then = ctx.at("records", cfg.throughput_window_s)
    base_then = ctx.at("records", cfg.throughput_baseline_s)
    if now_v is None or then is None or base_then is None:
        return None
    base_span = then[0] - base_then[0]
    recent_span = ctx.now - then[0]
    if base_span <= 0 or recent_span <= 0:
        return None
    baseline_rate = (then[1] - base_then[1]) / base_span
    # Both rates divide by their ACTUAL observed spans: `then` can be
    # older than the nominal window at sparse evaluation cadence, and
    # dividing that wider delta by the nominal width would overestimate
    # the recent rate — silently raising the firing threshold.
    recent_rate = (now_v - then[1]) / recent_span
    if baseline_rate < cfg.min_baseline_rate:
        return None
    if recent_rate >= cfg.throughput_drop_fraction * baseline_rate:
        return None
    return {
        "recent_per_s": round(recent_rate, 1),
        "baseline_per_s": round(baseline_rate, 1),
        "drop_fraction": round(
            recent_rate / baseline_rate if baseline_rate > 0 else 0.0, 3
        ),
        "lag": int(lag_now),
    }


def _fleet_topic_failure(ctx: EvalContext) -> "Optional[dict]":
    failed = sorted((ctx.extras or {}).get("failed_topics") or [])
    if not failed:
        return None
    return {"failed_topics": failed, "count": len(failed)}


def _lease_lost(ctx: EvalContext) -> "Optional[dict]":
    """This instance lost topic leases it held (fenced by a successor,
    or expired with renewals failing) in the trailing window — scanned
    work is being handed over, which is news even when the handover is
    working as designed."""
    d = ctx.delta("lease_losses", ctx.cfg.storm_window_s)
    if d is None or d <= 0:
        return None
    return {"lease_losses": int(d), "window_s": ctx.cfg.storm_window_s}


def _failover(ctx: EvalContext) -> "Optional[dict]":
    """Topics changed owner in the trailing window: this instance took
    over leases whose previous holder was a different instance — some
    peer crashed, hung, or released (DESIGN §23)."""
    d = ctx.delta("failovers", ctx.cfg.storm_window_s)
    if d is None or d <= 0:
        return None
    return {"failovers": int(d), "window_s": ctx.cfg.storm_window_s}


def _loss_series(ctx: EvalContext) -> str:
    return (
        f"topic:{ctx.topic}:lost" if ctx.topic is not None else "lost_records"
    )


def _lost_range(ctx: EvalContext) -> "Optional[dict]":
    """The log mutated records out from under the scanner in the trailing
    window (retention races past the cursor, resume below log-start) —
    the counts are honest but incomplete, which an operator must hear
    about before trusting a dashboard built on them."""
    d = ctx.delta(_loss_series(ctx), ctx.cfg.storm_window_s)
    if d is None or d <= 0:
        return None
    evidence = {
        "lost_records": int(d),
        "window_s": ctx.cfg.storm_window_s,
    }
    ranges = ctx.delta("lost_ranges", ctx.cfg.storm_window_s)
    if ranges:
        evidence["lost_ranges"] = int(ranges)
    return evidence


def _truncation(ctx: EvalContext) -> "Optional[dict]":
    """The log was TRUNCATED under the scanner (unclean leader election
    replacing already-counted records) in the trailing window — unlike a
    retention race, this marks folds non-authoritative and is never
    routine.  Watermark regressions ride along as evidence only: a held
    stale-replica answer heals by itself and must not page."""
    d = ctx.delta("truncated_records", ctx.cfg.storm_window_s)
    if d is None or d <= 0:
        return None
    evidence = {
        "truncated_records": int(d),
        "window_s": ctx.cfg.storm_window_s,
    }
    w = ctx.delta("watermark_regressions", ctx.cfg.storm_window_s)
    if w:
        evidence["watermark_regressions"] = int(w)
    return evidence


def built_in_rules(cfg: "Optional[HealthConfig]" = None) -> "List[AlertRule]":
    """The shipped rule set: lag growth, degraded-partition
    transitions, corruption storms, watermark-refresh outages,
    throughput regression, fleet-topic failure.  Thresholds/windows come
    from `config.HealthConfig`; services and tests may extend or replace
    the list freely — the engine is declarative."""
    cfg = cfg if cfg is not None else HealthConfig()
    return [
        AlertRule(
            "lag-growth",
            "follow lag diverging: the cursor falls further behind the "
            "head every poll — at this rate the scan never catches up",
            _lag_growth,
            for_s=cfg.for_s,
            resolve_s=cfg.resolve_s,
            per_topic=True,
        ),
        AlertRule(
            "degraded-partitions",
            "partitions dropped from the scan after exhausting their "
            "transport retry budget — metrics undercount their tails",
            _degraded,
            for_s=0.0,  # a degraded transition is immediately actionable
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "corruption-storm",
            "corrupt frames classified in the trailing window — the "
            "topic (or a broker volume) is shedding poisoned data",
            _corruption_storm,
            for_s=0.0,
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "watermark-refresh-outage",
            "watermark re-polls exhausting the transport retry budget — "
            "the service is flying blind on stale head offsets",
            _watermark_outage,
            for_s=cfg.for_s,
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "throughput-regression",
            "fold throughput collapsed against the service's own "
            "trailing baseline while lag remains",
            _throughput_regression,
            for_s=cfg.for_s,
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "fleet-topic-failure",
            "one or more fleet topics hard-failed (isolation caught the "
            "error; their numbers are partial until rerun)",
            _fleet_topic_failure,
            for_s=0.0,
            resolve_s=0.0,
        ),
        AlertRule(
            "lease_lost",
            "this instance was fenced off topics it owned (lease lost "
            "to a successor or expired unrenewed) — its in-flight work "
            "on those topics was discarded at the epoch fence",
            _lease_lost,
            for_s=0.0,  # a fencing is immediately actionable
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "failover",
            "topics changed owner: this instance took over leases from "
            "a crashed, hung, or departed peer (DESIGN §23)",
            _failover,
            for_s=0.0,
            resolve_s=cfg.resolve_s,
        ),
        AlertRule(
            "lost-range",
            "the log mutated records out from under the scanner "
            "(retention race / resume below log-start) — counts are "
            "honest for the surviving records but name a lost range",
            _lost_range,
            for_s=0.0,  # every lost record is immediately actionable
            resolve_s=cfg.resolve_s,
            per_topic=True,
        ),
        AlertRule(
            "truncation",
            "the log was truncated under the scanner (unclean election "
            "or watermark regression) — affected folds are "
            "non-authoritative until rescanned",
            _truncation,
            for_s=0.0,
            resolve_s=cfg.resolve_s,
        ),
    ]


_active: "Optional[HealthEngine]" = None


def set_active(engine: "Optional[HealthEngine]") -> None:
    global _active
    _active = engine


def active() -> "Optional[HealthEngine]":
    return _active
