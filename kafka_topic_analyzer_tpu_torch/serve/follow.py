"""The follow-mode drive loop: a batch scan that never has to end (port
of the reference's ``serve/follow.py``).

``--follow`` turns one invocation into a service (DESIGN.md §18): after
the initial earliest→latest pass, the loop re-polls watermarks, tails
whatever arrived, and folds it incrementally — by re-entering the SAME
``engine.run_scan`` on the SAME backend with the cursor as ``start_at``.
That is the whole trick: every fold in the analyzer is associative and
per-partition offset-ordered (DESIGN.md §2), so a chain of passes over
``[cursor, head)`` windows folds to byte-identical state as one batch
scan stopped at the same offsets — and every composition the engine
already knows (superbatch dispatch, parallel ingest fan-ins, wire-v5
combiner rows and wire-v4 record rows, each with its CUDA counter
kernel) rides along untouched, because the service never re-implements
the drive loop, it just re-enters it.  On the torch backend the state
stays on the card between passes, and so do the staging rings, the
dispatch queue and the superbatch stager; each pass's finalize copies
the state to the host for the report.

Pass mechanics (the engine's follow hooks, engine.run_scan docstring):
one shared heartbeat rate limiter spans passes, per-pass lifecycle events
are suppressed (the service emits ONE scan_start/scan_end pair), and the
pending superbatch tail is flushed at every pass end — a poll boundary is
always a superbatch boundary, so lag stays bounded and checkpoints/
reports are always fold-consistent.

Durability: periodic checkpoints ride the engine's snapshot machinery —
within a long pass on its timer, across short passes forced at the first
poll boundary past ``--checkpoint-interval`` — and SIGINT/SIGTERM request
a stop that lands at the next boundary: final checkpoint, final report,
clean exit code.  A killed service resumes from its last periodic
checkpoint (batch or follow — the fingerprint doesn't know the
difference) with no loss and no double-count.

Reporting: after every pass the service assembles the full ``--json``
document (plus the ``follow`` and ``windows`` blocks) and publishes it to
`serve.state.ServiceState` — the lock-consistent snapshot ``/report.json``
serves without ever touching this loop.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from kafka_topic_analyzer_tpu_torch.config import FollowConfig, TransportRetryConfig
from kafka_topic_analyzer_tpu_torch.engine import ScanResult, run_scan
from kafka_topic_analyzer_tpu_torch.io.retry import Backoff
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state
from kafka_topic_analyzer_tpu_torch.serve.windows import WindowObserver, WindowRing
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner

log = logging.getLogger(__name__)


class FollowService:
    """Own one topic's follow loop: initial pass, tail passes, shutdown.

    Construction wires the window ring (when enabled) around the source;
    ``run()`` blocks until a stop is requested — by a signal handler
    (``install_signal_handlers``), by ``request_stop`` from any thread, or
    by the ``idle_exit_s`` drain timer — and returns the final composed
    `ScanResult`, which the CLI reports exactly like a batch scan's.

    ``clock`` is injectable like Spinner/Backoff so tests pace polls
    without real sleeping; waiting always goes through the stop event, so
    a stop request interrupts any idle backoff immediately.
    """

    def __init__(
        self,
        topic: str,
        source,
        backend,
        batch_size: int,
        follow: "FollowConfig | None" = None,
        *,
        spinner: "Optional[Spinner]" = None,
        snapshot_dir: "Optional[str]" = None,
        resume: bool = False,
        start_at: "Optional[Dict[int, int]]" = None,
        prefetch_depth: int = 2,
        ingest_workers=1,
        heartbeat_every_s: float = 10.0,
        publish_reports: bool = True,
        serve_gzip: bool = True,
        health: "Optional[obs_health.HealthEngine]" = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        # A multi-controller mesh would need a lockstep agreement on every
        # poll's decisions (new data, idle exit, stop) before each pass;
        # with one controller every data row is local and a mesh backend
        # folds each pass like any other.
        if (getattr(backend, "sharded", False)
                and len(backend.local_rows) < backend.config.data_shards):
            raise ValueError(
                "--follow does not support multi-controller meshes yet "
                "(pass entry would need per-poll lockstep agreement); "
                "run the service single-controller"
            )
        self.topic = topic
        self.backend = backend
        self.batch_size = batch_size
        self.follow = follow if follow is not None else FollowConfig()
        self.spinner = spinner or Spinner(enabled=False)
        self.snapshot_dir = snapshot_dir
        self.resume = resume
        self.start_at = start_at
        self.prefetch_depth = prefetch_depth
        self.ingest_workers = ingest_workers
        self._clock = clock
        self.heartbeat_every_s = heartbeat_every_s
        #: Assemble + publish /report.json documents at poll boundaries.
        #: The CLI turns this off when no --metrics-port server exists to
        #: serve them — a full per-partition document serialized per
        #: productive poll that nothing can ever read is pure waste.
        self.publish_reports = publish_reports
        self._heartbeat = obs_events.Heartbeat(heartbeat_every_s)
        self.ring: "Optional[WindowRing]" = None
        self._observer: "Optional[WindowObserver]" = None
        if self.follow.window_count > 0:
            self.ring = WindowRing(
                source.partitions(),
                window_secs=self.follow.window_secs,
                window_count=self.follow.window_count,
                hll_p=self.follow.window_hll_p,
                clock=clock,
            )
            # Disabled through the initial catch-up: windows describe the
            # LIVE head, and folding the historical backlog into the
            # current wall-clock window would report all of history as
            # "the last N minutes" (see WindowObserver.enabled).
            self._observer = WindowObserver(source, self.ring, enabled=False)
            self.source = self._observer
        else:
            self.source = source
        #: The alert engine this service evaluates at every poll
        #: boundary (obs/health.py): an explicit one wins (tests inject
        #: clock-driven engines), else whatever the telemetry session
        #: installed, else none — alerting is opt-in observability and
        #: the loop must not pay for an engine nobody reads.
        self.health = health if health is not None else obs_health.active()
        #: The lock-consistent /report.json snapshot (serve/state.py) —
        #: publish-time gzip encoding rides the ``--serve-gzip`` knob.
        self.state = serve_state.ServiceState(gzip_enabled=serve_gzip)
        self._stop = threading.Event()
        self._stop_reason: "Optional[str]" = None
        # Idle pacing: poll_interval floor, exponential backoff to the
        # ceiling over consecutive empty polls (io/retry.Backoff — the
        # delay schedule only; idle waits are not transport retries, so
        # they are not booked on the backoff counters).
        self._idle_backoff = Backoff(
            TransportRetryConfig(
                backoff_ms=max(1, int(self.follow.poll_interval_s * 1000)),
                backoff_max_ms=max(
                    max(1, int(self.follow.poll_interval_s * 1000)),
                    int(self.follow.idle_backoff_max_s * 1000),
                ),
            )
        )
        # Cross-pass accounting.
        self.polls = 0
        self.passes = 0
        self.cursor: "Dict[int, int]" = {}
        self._seq_total = 0
        self._service_start_offsets: "Optional[Dict[int, int]]" = None
        self._last_end: "Dict[int, int]" = {}
        #: Partitions whose regressed end watermark was held for one poll
        #: (a second consecutive regression is adopted as truncation).
        self._regress_held: "Dict[int, bool]" = {}
        self._t0 = clock()  # re-anchored at run() start
        self._last_ckpt = clock()
        self._wire_bytes = 0
        self._wire_records = 0

    # -- stopping -------------------------------------------------------------

    def request_stop(self, reason: str = "stop") -> None:
        """Ask the loop to stop at the next poll boundary (thread-safe;
        signal handlers and test harnesses both land here)."""
        if not self._stop.is_set():
            self._stop_reason = reason
        self._stop.set()

    def install_signal_handlers(self):
        """SIGINT/SIGTERM → graceful stop at the next boundary; a SECOND
        SIGINT restores the default handler so an operator can still
        hard-interrupt a pass.  Shared wiring with the fleet service
        (serve/signals.py); returns a restore callable."""
        from kafka_topic_analyzer_tpu_torch.serve.signals import (
            install_stop_handlers,
        )

        return install_stop_handlers(self.request_stop)

    # -- the loop -------------------------------------------------------------

    def run(self) -> ScanResult:
        serve_state.set_active(self.state)
        if self.health is not None:
            # The /healthz handler discovers the engine the same way the
            # /report.json handler discovers the state: module-level
            # registration, last service wins.
            obs_health.set_active(self.health)
        if self.resume and self.snapshot_dir is not None:
            # Operator banner: where will this service pick up?  Metadata
            # only — the engine's resume path pays the state load.
            from kafka_topic_analyzer_tpu_torch.checkpoint import snapshot_info

            info = snapshot_info(self.snapshot_dir)
            if info is not None:
                log.info(
                    "follow: resuming %s from a snapshot at "
                    "records_seen=%s (batch- and follow-written snapshots "
                    "are interchangeable)",
                    self.topic, info.get("records_seen"),
                )
        obs_events.emit(
            "scan_start",
            topic=self.topic,
            partitions=len(self.source.partitions()),
            batch_size=self.batch_size,
            follow=True,
        )
        self._t0 = self._clock()
        idle_streak = 0
        idle_since: "Optional[float]" = None
        # Initial catch-up: earliest→latest (or resume / --from-timestamp
        # start), exactly the batch scan this mode generalizes.
        result = self._run_pass(first=True)
        if self._observer is not None:
            # Caught up: from here every fold is live tail, which is what
            # the window ring describes.
            self._observer.enabled = True
        self._after_pass(result)
        while not self._stop.is_set():
            # Pace the metadata polls: the poll interval after progress,
            # the backed-off schedule after consecutive empty polls.  The
            # wait rides the stop event, so shutdown never waits it out.
            delay = (
                self.follow.poll_interval_s
                if idle_streak == 0
                else self._idle_backoff.delay_ms(idle_streak) / 1000.0
            )
            if idle_since is not None and self.follow.idle_exit_s is not None:
                remaining = self.follow.idle_exit_s - (
                    self._clock() - idle_since
                )
                delay = max(0.0, min(delay, remaining))
            if self._stop.wait(delay):
                break
            lag_total = self._poll()
            if self._stop.is_set():
                break
            if lag_total > 0:
                idle_streak = 0
                idle_since = None
                obs_events.emit(
                    "follow_poll",
                    poll=self.polls,
                    new_records=lag_total,
                    lag_total=lag_total,
                )
                result = self._run_pass()
                self._after_pass(result)
            else:
                idle_streak += 1
                now = self._clock()
                if idle_since is None:
                    idle_since = now
                if (
                    self.follow.idle_exit_s is not None
                    and now - idle_since >= self.follow.idle_exit_s
                ):
                    self.request_stop("idle")
                    break
                self.spinner.set_message(
                    f"[following {self.topic} | at head | "
                    f"Sq: {self._seq_total} | polls: {self.polls}]"
                )
        # Shutdown boundary: one final (usually empty) pass commits the
        # final checkpoint at a superbatch boundary and finalizes the
        # state for the closing report.
        result = self._run_pass(final=True)
        self._after_pass(result)
        obs_events.emit(
            "follow_stop",
            reason=self._stop_reason or "stop",
            polls=self.polls,
            passes=self.passes,
        )
        obs_events.emit(
            "scan_end",
            topic=self.topic,
            records=self._seq_total,
            duration_secs=result.duration_secs,
            degraded=sum(1 for p in result.degraded_partitions if p >= 0),
            corrupt_frames=sum(
                d.get("frames", 0)
                for p, d in result.corrupt_partitions.items()
                if p >= 0
            ),
        )
        # Closing heartbeat: the engine's own forced closer is suppressed
        # on follow passes (emit_lifecycle=False), so the service emits
        # it — a sub-interval run must still record one heartbeat, and
        # the drained ETA gauges must not stay stale at mid-scan values.
        rate = (
            self._seq_total / result.duration_secs
            if result.duration_secs > 0 else 0.0
        )
        for p in self._last_end:
            obs_metrics.PARTITION_ETA_SECONDS.labels(partition=p).set(0.0)
        obs_events.emit(
            "heartbeat",
            seq=self._seq_total,
            records_per_sec=round(rate, 1),
            lag_total=int(obs_metrics.FOLLOW_LAG.value),
        )
        self._heartbeat.force()
        self.spinner.finish_with_message("done")
        return result

    # -- internals ------------------------------------------------------------

    def _poll(self) -> int:
        """Refresh watermarks (through the source's retry budget) and
        recompute every lag gauge against the MOVING end offsets — the
        follow-aware replacement for the batch scan's start-snapshot lag.
        Returns the total new-record lag behind the head."""
        start_w, end_w = self.source.refresh_watermarks()
        self.polls += 1
        obs_metrics.FOLLOW_POLLS.inc()
        # End-watermark REGRESSION (stale replica answering the re-poll,
        # or a truncation the epoch fence hasn't classified yet): hold
        # the previous head for one poll instead of scanning backwards.
        # A transient stale answer recovers by the next refresh; a
        # regression that PERSISTS is the log's new truth (truncation),
        # so the second poll adopts it — the follow cursor never rewinds,
        # so an adopted shorter head drains the partition rather than
        # re-reading offsets (no double-count), and the fetch path's
        # epoch fence owns the loss accounting.  Booked
        # (kta_log_watermark_regressions_total) + emitted, never silent.
        for p, end in list(end_w.items()):
            prev = self._last_end.get(p)
            if prev is not None and end < prev:
                held = not self._regress_held.get(p, False)
                obs_metrics.LOG_WATERMARK_REGRESSIONS.inc()
                obs_events.emit(
                    "watermark_regression",
                    partition=int(p),
                    previous_end=int(prev),
                    answered_end=int(end),
                    held=bool(held),
                )
                if held:
                    self._regress_held[p] = True
                    end_w[p] = prev
                else:
                    self._regress_held.pop(p, None)
            else:
                self._regress_held.pop(p, None)
        self._last_end = dict(end_w)
        lag_total = 0
        for p, end in end_w.items():
            lag = max(0, end - self.cursor.get(p, start_w.get(p, 0)))
            lag_total += lag
            obs_metrics.PARTITION_LAG.labels(partition=p).set(lag)
        obs_metrics.FOLLOW_LAG.set(lag_total)
        self._evaluate_health()
        return lag_total

    def _evaluate_health(self) -> None:
        """One alert-engine pass at a poll boundary (DESIGN.md §22): a
        /healthz flip lands within one poll of the fault, which is the
        acceptance bar for the lag-divergence scenario."""
        if self.health is not None:
            self.health.evaluate()

    def _checkpoint_due(self) -> bool:
        if self.snapshot_dir is None:
            return False
        return (
            self._clock() - self._last_ckpt >= self.follow.checkpoint_every_s
        )

    def _run_pass(self, first: bool = False, final: bool = False) -> ScanResult:
        """One engine pass over [cursor, current watermark snapshot)."""
        force_ckpt = self.snapshot_dir is not None and (
            final or self._checkpoint_due()
        )
        result = run_scan(
            self.topic,
            self.source,
            self.backend,
            batch_size=self.batch_size,
            spinner=self.spinner,
            snapshot_dir=self.snapshot_dir,
            snapshot_every_s=self.follow.checkpoint_every_s,
            resume=self.resume and first,
            prefetch_depth=self.prefetch_depth,
            start_at=self.start_at if first else dict(self.cursor),
            heartbeat=self._heartbeat,
            ingest_workers=self.ingest_workers,
            initial_seq=self._seq_total,
            emit_lifecycle=False,
            book_once=first,
            final_snapshot=force_ckpt,
        )
        if force_ckpt:
            self._last_ckpt = self._clock()
        self.passes += 1
        obs_metrics.FOLLOW_PASSES.inc()
        self.cursor = dict(result.next_offsets)
        # The cumulative fold count doubles as the next pass's seq seed:
        # overall_count counts exactly the records every pass (and any
        # resumed snapshot) folded.
        self._seq_total = result.metrics.overall_count
        if self._service_start_offsets is None:
            self._service_start_offsets = dict(result.start_offsets)
        if result.wire is not None:
            self._wire_bytes += result.wire.bytes_total
            self._wire_records += result.wire.records
        return result

    def _after_pass(self, result: ScanResult) -> None:
        """Publish the poll-boundary report snapshot and heal partitions
        that caught back up to the head."""
        # Re-settle the lag gauges against the freshest known head: the
        # pass just moved the cursor, and leaving the pre-pass values in
        # place would report the service permanently behind (the inverse
        # of the fixed-end-offset bug this layer exists to fix).
        lag_total = 0
        for p, end in self._last_end.items():
            lag = max(0, end - self.cursor.get(p, end))
            lag_total += lag
            obs_metrics.PARTITION_LAG.labels(partition=p).set(lag)
        obs_metrics.FOLLOW_LAG.set(lag_total)
        healed = [
            p
            for p in result.degraded_partitions
            if p >= 0
            and p in self._last_end
            and self.cursor.get(p, 0) >= self._last_end[p]
        ]
        if healed and hasattr(self.source, "heal_degraded"):
            self.source.heal_degraded(healed)
            for p in healed:
                result.degraded_partitions.pop(p, None)
        # Re-anchor the per-pass result to the SERVICE view before anyone
        # reads it: cumulative duration (a pass's own wall time is
        # meaningless to a dashboard), the first pass's start offsets, and
        # the run's cumulative wire accounting — so a published snapshot
        # and the final --json can never disagree about totals.
        result.duration_secs = int(self._clock() - self._t0)
        if self._service_start_offsets is not None:
            result.start_offsets = self._service_start_offsets
        if result.wire is not None:
            result.wire.bytes_total = self._wire_bytes
            result.wire.records = self._wire_records
        # Post-pass health boundary: the lag gauges just settled against
        # the freshest head, so a pass that healed (or worsened) the
        # divergence is reflected before the report publishes.
        self._evaluate_health()
        if not self.publish_reports:
            return
        from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan
        from kafka_topic_analyzer_tpu_torch.report import build_json_doc

        doc = build_json_doc(
            self.topic,
            result,
            diagnosis=diagnose_scan(result),
            follow=self.follow_block(result),
            windows=self.ring.report() if self.ring is not None else None,
            health=(
                self.health.alerts_block()
                if self.health is not None
                else None
            ),
        )
        # The compact delta block /events subscribers get instead of a
        # body: enough to decide whether (and what) to fetch.
        self.state.publish(
            doc,
            summary={
                "records": int(self._seq_total),
                "lag": int(obs_metrics.FOLLOW_LAG.value),
                "polls": self.polls,
                "passes": self.passes,
            },
        )

    def follow_block(self, result: "Optional[ScanResult]" = None) -> dict:
        """The ``follow`` block of the report document: service counters
        plus the exact resume cursor."""
        block = {
            "polls": self.polls,
            "passes": self.passes,
            "lag_records": int(obs_metrics.FOLLOW_LAG.value),
            "watermark_refresh_failures": int(
                obs_metrics.WATERMARK_REFRESH_FAILURES.value
            ),
            "next_offsets": {
                str(p): int(o) for p, o in sorted(self.cursor.items())
            },
        }
        return block

    def windows_report(self) -> "Optional[dict]":
        return self.ring.report() if self.ring is not None else None
