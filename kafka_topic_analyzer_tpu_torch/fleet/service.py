"""The fleet drive layer: admitted per-topic scans on shared budgets (port
of the reference's ``fleet/service.py``).

Each admitted topic runs the pass chain a solo scan of that topic would:
``engine.run_scan`` over ``[cursor, head)`` windows on the topic's own
backend, so its metrics equal a solo scan's stopped at the same offsets.
On the card each topic's backend holds a CUDA stream of its own (the
CLI's ``backend_factory`` leases it from the process's pool), so the
folds of concurrent topics are ordered only within their topic.  A batch
fleet passes each topic once and closes its backend when the pass ends,
so only the admitted topics' device state is ever live, and the next
topic's state takes the memory (and the stream) the last one freed; a
fleet follow keeps each backend for the next pass.  What the fleet adds
is around the passes:

- admission: `fleet.scheduler.FleetScheduler` decides which topics hold
  ingest-worker and dispatch budget; a pass runs with the worker count it
  was granted (grants change only between passes);
- failure isolation: a topic whose scan raises (corruption under the
  ``fail`` policy, an exhausted transport budget, a source that cannot
  connect) is marked ``failed`` in the status table and gives its budget
  back; the exception never reaches another topic;
- namespacing: each topic's checkpoints live in their own subdirectory
  (`checkpoint.topic_snapshot_dir`) and its report document is published
  to its own ``/report.json?topic=`` slot;
- the rollup: after every wave or poll the service publishes the cluster
  rollup (fleet/report.py) to the main ``/report.json`` slot;
- leases (fleet/lease.py), when a `LeaseManager` is given: a topic is
  scanned only under a held lease, renewed at every poll boundary.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from kafka_topic_analyzer_tpu_torch.checkpoint import StaleLeaseEpochError
from kafka_topic_analyzer_tpu_torch.config import FollowConfig, TransportRetryConfig
from kafka_topic_analyzer_tpu_torch.engine import ScanResult, run_scan
from kafka_topic_analyzer_tpu_torch.fleet.lease import LeaseManager
from kafka_topic_analyzer_tpu_torch.fleet.report import build_fleet_rollup
from kafka_topic_analyzer_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    Grant,
    TopicSeed,
)
from kafka_topic_analyzer_tpu_torch.io.retry import Backoff
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TopicStatus:
    """One row of the fleet status table."""

    topic: str
    partitions: int = 0
    #: pending | scanning | ok | empty | degraded | corrupt | data-loss
    #: | failed | fenced (lease lost to a successor — not a topic
    #: failure; the topic scans on, under another instance's ownership).
    #: data-loss is set ONLY by an --on-data-loss=fail abort: a scan
    #: that completes under the report policy keeps its ordinary status
    #: (loss never changes the exit code outside the fail policy) and
    #: carries the booked loss in `lost_records` instead.
    status: str = "pending"
    records: int = 0
    bytes: int = 0
    lost_records: int = 0
    lag: int = 0
    verdict: str = ""
    workers: int = 0
    passes: int = 0
    error: "Optional[str]" = None

    def as_dict(self) -> dict:
        out = {
            "status": self.status,
            "partitions": self.partitions,
            "records": self.records,
            "bytes": self.bytes,
            "lost_records": self.lost_records,
            "lag": self.lag,
            "verdict": self.verdict,
            "workers": self.workers,
            "passes": self.passes,
        }
        if self.error:
            out["error"] = self.error
        return out


@dataclasses.dataclass
class FleetResult:
    """What a fleet run returns to the CLI: the status table, each
    scanned topic's full `ScanResult`, and the published rollup doc."""

    statuses: "Dict[str, TopicStatus]"
    results: "Dict[str, ScanResult]"
    rollup: dict
    duration_secs: int = 0

    @property
    def any_failed(self) -> bool:
        return any(s.status == "failed" for s in self.statuses.values())

    @property
    def any_degraded(self) -> bool:
        return any(s.status == "degraded" for s in self.statuses.values())

    @property
    def any_corrupt(self) -> bool:
        return any(s.status == "corrupt" for s in self.statuses.values())

    @property
    def any_data_loss(self) -> bool:
        return any(s.status == "data-loss" for s in self.statuses.values())


class _TopicScan:
    """Per-topic mutable scan state the fleet loop drives."""

    def __init__(self, seed: TopicSeed):
        self.seed = seed
        self.source = None
        self.backend = None
        self.cursor: "Dict[int, int]" = {}
        self.seq = 0
        self.first = True
        self.status = TopicStatus(topic=seed.name, partitions=seed.partitions)
        self.result: "Optional[ScanResult]" = None
        #: Last pass's doctor attribution (obs/doctor.Diagnosis) — set by
        #: every completed pass, so the rollup's verdict column fills in
        #: whether or not per-topic documents are being published.
        self.diagnosis = None
        self.lag = 0
        #: Last grant a productive pass ran under — the shutdown pass
        #: (whose budget was already released) reuses it so the final
        #: report does not overwrite the topic's real parallelism with
        #: the fallback's.
        self.last_grant: "Optional[Grant]" = None
        #: When the topic was last offered to admission without a pass
        #: since (a reading of `obs.trace.now`): its pass books the wait
        #: (span ``fleet-admit``).
        self.waiting_since: "Optional[float]" = None


class FleetService:
    """Own the whole-cluster scan: admission, passes, rollup, shutdown.

    ``source_factory(topic)`` builds a topic's record source (the CLI
    closes over its flag set); ``backend_factory(topic, partitions,
    grant)`` builds its backend, sized by the grant's dispatch share.
    Both are called lazily — a topic that is never admitted costs no
    broker handshake and no device state.  ``follow=None`` runs the batch
    fleet (every topic scanned once, in scheduler-planned waves);
    a `FollowConfig` turns on fleet follow: the poll loop re-polls every
    topic's watermarks, admits lagging topics, and re-enters their pass
    chains until stopped.  ``rediscover`` (follow mode) is an optional
    zero-arg callable returning fresh `TopicSeed`s — topics created after
    startup join the fleet at the next re-discovery poll.
    """

    def __init__(
        self,
        seeds: "List[TopicSeed]",
        source_factory: "Callable[[str], object]",
        backend_factory: "Callable[[str, int, Grant], object]",
        batch_size: int,
        scheduler: FleetScheduler,
        *,
        follow: "Optional[FollowConfig]" = None,
        snapshot_dir: "Optional[str]" = None,
        resume: bool = False,
        publish_reports: bool = True,
        spinner: "Optional[Spinner]" = None,
        rediscover: "Optional[Callable[[], List[TopicSeed]]]" = None,
        rediscover_every: int = 16,
        heartbeat_every_s: float = 10.0,
        health: "Optional[obs_health.HealthEngine]" = None,
        clock: Callable[[], float] = time.monotonic,
        leases: "Optional[LeaseManager]" = None,
        instance: str = "solo",
        serve_gzip: bool = True,
    ):
        self.scans: "Dict[str, _TopicScan]" = {
            s.name: _TopicScan(s) for s in seeds
        }
        self.discovered = len(seeds)
        self.source_factory = source_factory
        self.backend_factory = backend_factory
        self.batch_size = batch_size
        self.scheduler = scheduler
        self.follow = follow
        self.snapshot_dir = snapshot_dir
        self.resume = resume
        self.publish_reports = publish_reports
        self.spinner = spinner or Spinner(enabled=False)
        self.rediscover = rediscover
        self.rediscover_every = max(1, int(rediscover_every))
        self._clock = clock
        self._heartbeat = obs_events.Heartbeat(heartbeat_every_s)
        #: Alert engine evaluated at every fleet poll/wave boundary with
        #: per-topic lag + failure context (obs/health.py): explicit
        #: wins, else the telemetry session's engine, else none.
        self.health = health if health is not None else obs_health.active()
        #: Per-topic ownership leases (fleet/lease.py) — None runs the
        #: pre-lease single-instance fleet unchanged.  With a manager,
        #: admission is acquire-before-scan, renewal rides every poll
        #: boundary, and budgets release WITH the lease.
        self.leases = leases
        self.instance = instance
        self.state = serve_state.ServiceState(
            instance=instance if leases is not None else None,
            gzip_enabled=serve_gzip,
        )
        self._stop = threading.Event()
        self._stop_reason: "Optional[str]" = None
        #: Chaos seams for the failover tests: ``kill()`` crashes the
        #: instance — stop NOW, no shutdown passes, no lease release,
        #: exactly what SIGKILL leaves behind; ``pause()``/``unpause()``
        #: freeze/thaw the loop right after the renew step, the zombie
        #: window epoch fencing must cover.
        self._killed = False
        self._pause = threading.Event()
        #: True exactly while the follow loop is frozen at the
        #: post-renew pause gate — the observable the chaos tests wait
        #: on (a polls-are-static heuristic cannot tell "at the gate"
        #: from "mid-pass on a slow broker").
        self.paused = False
        self.polls = 0
        #: The span context the fleet's threads bind: the fleet's own
        #: ``scan`` number (`_start_banner`).
        self._trace_ctx: dict = {}
        self._t0 = clock()
        self._last_ckpt = clock()
        if follow is not None:
            self._idle_backoff = Backoff(
                TransportRetryConfig(
                    backoff_ms=max(1, int(follow.poll_interval_s * 1000)),
                    backoff_max_ms=max(
                        max(1, int(follow.poll_interval_s * 1000)),
                        int(follow.idle_backoff_max_s * 1000),
                    ),
                )
            )

    # -- stopping -------------------------------------------------------------

    def request_stop(self, reason: str = "stop") -> None:
        if not self._stop.is_set():
            self._stop_reason = reason
        self._stop.set()

    def kill(self) -> None:
        """Crash semantics (the chaos twin of FakeBroker.kill): the
        loop exits at the next check with NO shutdown passes and NO
        lease release — held leases dangle until their TTL expires,
        which is precisely the failover the two-instance tests prove."""
        self._killed = True
        self.request_stop("killed")

    def pause(self) -> None:
        """Freeze the follow loop at the post-renew gate (a stalled VM,
        a long GC): leases keep their last renewal and expire while
        paused — the zombie window."""
        self._pause.set()

    def unpause(self) -> None:
        # Not `resume()`: the constructor's resume-from-checkpoint flag
        # lives at `self.resume` and would shadow a method of that name.
        self._pause.clear()

    def install_signal_handlers(self):
        from kafka_topic_analyzer_tpu_torch.serve.signals import (
            install_stop_handlers,
        )

        return install_stop_handlers(self.request_stop)

    # -- per-topic plumbing ---------------------------------------------------

    def _topic_snapshot_dir(self, topic: str) -> "Optional[str]":
        if self.snapshot_dir is None:
            return None
        from kafka_topic_analyzer_tpu_torch.checkpoint import topic_snapshot_dir

        return topic_snapshot_dir(self.snapshot_dir, topic)

    def _ensure_source(self, scan: _TopicScan) -> bool:
        """Build the topic's source on first need; a factory failure is a
        per-topic failure, never a fleet one."""
        if scan.source is not None:
            return True
        try:
            scan.source = self.source_factory(scan.seed.name)
            scan.status.partitions = len(scan.source.partitions())
            return True
        except BaseException as e:  # noqa: BLE001 — isolation boundary
            scan.status.status = "failed"
            scan.status.error = f"{type(e).__name__}: {e}"
            log.exception("fleet: source for topic %r failed", scan.seed.name)
            return False

    def _release_source(self, scan: _TopicScan) -> None:
        """Close and drop a stopped topic's source.  Shared-pool hygiene:
        remote segment sources hold chunk bodies and fetch-scheduler
        streams, and the scheduler pool is ONE per process — a fenced or
        failed topic must stop competing for its workers the moment it
        stops scanning, not at fleet teardown.  A later pass (re-acquire
        after fencing, batch retry) rebuilds through _ensure_source."""
        source, scan.source = scan.source, None
        if source is not None and hasattr(source, "close"):
            try:
                source.close()
            except BaseException:  # noqa: BLE001 — teardown best-effort
                log.exception(
                    "fleet: closing source for topic %r failed",
                    scan.seed.name,
                )

    def _run_pass(
        self, scan: _TopicScan, grant: Grant, final: bool = False
    ) -> bool:
        """One engine pass for one topic (the fleet twin of
        serve/follow.FollowService._run_pass).  Returns True when the
        pass completed; False marks the topic failed — the exception is
        absorbed HERE, at the topic boundary, so a poisoned topic can
        never take the fleet down.

        On the thread that runs it, the pass books the topic's wait for
        its grant (span ``fleet-admit``) and then its own wall (span
        ``fleet-pass``, enclosing the scan's spans), both with the
        fleet's ``scan`` number and the topic.  A batch fleet's pass then
        releases the topic's backend, however the pass ended."""
        topic = scan.seed.name
        obs_trace.bind(self._trace_ctx)
        if scan.waiting_since is not None:
            obs_trace.since(
                "fleet-admit", scan.waiting_since,
                obs_metrics.FLEET_ADMISSION_WAIT_SECONDS, cat="fleet",
                topic=topic,
            )
            scan.waiting_since = None
        try:
            with obs_trace.timed(
                "fleet-pass", obs_metrics.FLEET_PASS_SECONDS, cat="fleet",
                topic=topic, workers=grant.workers,
                dispatch_depth=grant.dispatch_depth,
            ):
                try:
                    return self._pass(scan, grant, final)
                finally:
                    # run_scan numbered the pass; the span closes under
                    # the fleet's number.
                    obs_trace.bind(self._trace_ctx)
        finally:
            if self.follow is None:
                self._release_backend(scan)

    def _release_backend(self, scan: _TopicScan) -> None:
        """Close and drop a batch fleet topic's backend: the fleet never
        passes the topic again, and its device state would otherwise stay
        on the card until the whole fleet ends.  The close frees it now,
        before the next admission, and a close that returns books
        ``kta_fleet_backends_released_total``."""
        backend, scan.backend = scan.backend, None
        if backend is None:
            return
        try:
            backend.close()
        except Exception:  # noqa: BLE001 — the pass's result stands
            log.exception(
                "fleet: closing the backend of topic %r failed",
                scan.seed.name,
            )
            return
        obs_metrics.FLEET_BACKENDS_RELEASED.inc()

    def _pass(self, scan: _TopicScan, grant: Grant, final: bool) -> bool:
        topic = scan.seed.name
        scan.status.status = "scanning"
        scan.status.workers = grant.workers
        scan.last_grant = dataclasses.replace(grant)
        force_ckpt = self.snapshot_dir is not None and (
            final or self._checkpoint_due()
        )
        try:
            if scan.backend is None:
                scan.backend = self.backend_factory(
                    topic, len(scan.source.partitions()), grant
                )
            else:
                # Re-apply the CURRENT dispatch share to a live backend:
                # rebalance/re-admission may have moved tokens since
                # construction, and the ledger must stay the real bound
                # (backends clamp grows at their constructed depth).
                scan.backend.set_dispatch_depth(grant.dispatch_depth)
            result = run_scan(
                topic,
                scan.source,
                scan.backend,
                batch_size=self.batch_size,
                spinner=self.spinner,
                snapshot_dir=self._topic_snapshot_dir(topic),
                snapshot_every_s=(
                    self.follow.checkpoint_every_s
                    if self.follow is not None else 60.0
                ),
                resume=self.resume and scan.first,
                start_at=dict(scan.cursor) if not scan.first else None,
                heartbeat=self._heartbeat,
                ingest_workers=grant.workers,
                initial_seq=scan.seq,
                emit_lifecycle=False,
                book_once=scan.first,
                final_snapshot=force_ckpt,
                lease_epoch=(
                    self.leases.epoch(topic)
                    if self.leases is not None else None
                ),
            )
        except StaleLeaseEpochError as e:
            # The zombie path: this instance's lease epoch is older than
            # what a successor already stamped on disk — the checkpoint
            # write was REFUSED, the topic is not ours anymore.  Not a
            # topic failure (the topic is healthy, under new ownership):
            # fence the lease (books kta_lease_losses_total) and step
            # aside; a later acquire can win the topic back legitimately.
            scan.status.status = "fenced"
            scan.status.error = f"{type(e).__name__}: {e}"
            if self.leases is not None:
                self.leases.fence(topic)
            log.warning("fleet: topic %r fenced: %s", topic, e)
            self._release_source(scan)
            return False
        except BaseException as e:  # noqa: BLE001 — isolation boundary
            from kafka_topic_analyzer_tpu_torch.io.kafka_wire import DataLossError

            if isinstance(e, DataLossError):
                # --on-data-loss=fail abort: the loss is booked and the
                # checkpoint fold-consistent — a NAMED stop, not a topic
                # failure (the distinct status keeps _fleet_exit's
                # EXIT_DATA_LOSS rung separate from the hard-failure 1).
                scan.status.status = "data-loss"
                scan.status.error = f"{type(e).__name__}: {e}"
                log.warning(
                    "fleet: scan of topic %r stopped on data loss: %s",
                    topic, e,
                )
                self._release_source(scan)
                return False
            scan.status.status = "failed"
            scan.status.error = f"{type(e).__name__}: {e}"
            log.exception("fleet: scan of topic %r failed", topic)
            self._release_source(scan)
            return False
        scan.first = False
        scan.result = result
        scan.cursor = dict(result.next_offsets)
        scan.seq = result.metrics.overall_count
        scan.status.passes += 1
        scan.status.records = result.metrics.overall_count
        scan.status.bytes = result.metrics.overall_size
        scan.status.lost_records = sum(
            d.get("records", 0)
            for p, d in result.lost_partitions.items()
            if p >= 0
        )
        if result.degraded_partitions:
            scan.status.status = "degraded"
        elif result.corrupt_partitions:
            scan.status.status = "corrupt"
        else:
            scan.status.status = "ok"
        # The doctor attributes EVERY completed pass — the rollup's
        # verdict column (and the scheduler's rebalance input) must not
        # depend on whether /report.json documents are being published.
        from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan

        scan.diagnosis = diagnose_scan(result)
        scan.status.verdict = scan.diagnosis.verdict
        self._publish_topic(scan)
        return True

    def _publish_topic(self, scan: _TopicScan) -> None:
        if not self.publish_reports or scan.result is None:
            return
        from kafka_topic_analyzer_tpu_torch.report import build_json_doc

        doc = build_json_doc(
            scan.seed.name,
            scan.result,
            diagnosis=scan.diagnosis,
            fleet=scan.status.as_dict(),
            health=(
                self.health.alerts_block(topic=scan.seed.name)
                if self.health is not None
                else None
            ),
        )
        self.state.publish(
            doc,
            topic=scan.seed.name,
            summary={
                "status": scan.status.status,
                "verdict": scan.status.verdict,
                "passes": scan.status.passes,
            },
        )

    def _publish_rollup(self) -> dict:
        rollup = build_fleet_rollup(
            {t: s.status for t, s in self.scans.items()},
            discovered=self.discovered,
            duration_secs=int(self._clock() - self._t0),
            health=(
                self.health.alerts_block()
                if self.health is not None
                else None
            ),
            instance=(
                self.instance if self.leases is not None else None
            ),
            instances=(
                self.leases.known_instances()
                if self.leases is not None else None
            ),
        )
        if self.publish_reports:
            self.state.publish(
                rollup,
                summary={
                    "discovered": self.discovered,
                    "polls": self.polls,
                },
            )
        return rollup

    def _evaluate_health(self) -> None:
        """One alert-engine pass at a fleet poll/wave boundary, with the
        per-topic lag map (per-topic lag-growth scopes) and the failed
        set (the fleet-topic-failure rule) as context."""
        if self.health is None:
            return
        self.health.evaluate(
            extras={
                "topics": {
                    t: s.lag for t, s in self.scans.items()
                },
                "failed_topics": [
                    t
                    for t, s in self.scans.items()
                    if s.status.status == "failed"
                ],
                # Cumulative per-topic lost records (the lost-range
                # rule's per-topic scopes): summed from each scan's
                # result so one topic's retention race never fires the
                # alert against its fleet-mates.
                "topic_loss": {
                    t: sum(
                        d.get("records", 0)
                        for p, d in s.result.lost_partitions.items()
                        if p >= 0
                    )
                    for t, s in self.scans.items()
                    if s.result is not None
                },
            }
        )

    def _checkpoint_due(self) -> bool:
        if self.snapshot_dir is None or self.follow is None:
            return False
        if self._clock() - self._last_ckpt >= self.follow.checkpoint_every_s:
            self._last_ckpt = self._clock()
            return True
        return False

    def _finish(self) -> FleetResult:
        rollup = self._publish_rollup()
        duration = int(self._clock() - self._t0)
        obs_events.emit(
            "scan_end",
            topic="<fleet>",
            records=sum(s.status.records for s in self.scans.values()),
            duration_secs=duration,
            degraded=sum(
                1 for s in self.scans.values() if s.status.status == "degraded"
            ),
            corrupt_frames=sum(
                d.get("frames", 0)
                for s in self.scans.values()
                if s.result is not None
                for p, d in s.result.corrupt_partitions.items()
                if p >= 0
            ),
        )
        self.spinner.finish_with_message("done")
        for scan in self.scans.values():
            if scan.source is not None and hasattr(scan.source, "close"):
                try:
                    scan.source.close()
                except Exception:
                    log.exception(
                        "fleet: closing source for %r failed", scan.seed.name
                    )
        return FleetResult(
            statuses={t: s.status for t, s in self.scans.items()},
            results={
                t: s.result
                for t, s in self.scans.items()
                if s.result is not None
            },
            rollup=rollup,
            duration_secs=duration,
        )

    def _start_banner(self) -> None:
        obs_trace.begin_scan()
        self._trace_ctx = obs_trace.context()
        serve_state.set_active(self.state)
        if self.health is not None:
            obs_health.set_active(self.health)
        self._t0 = self._clock()
        if self.resume and self.snapshot_dir is not None:
            from kafka_topic_analyzer_tpu_torch.checkpoint import (
                list_topic_snapshots,
            )

            for topic, info in list_topic_snapshots(self.snapshot_dir).items():
                log.info(
                    "fleet: topic %r will resume from a snapshot at "
                    "records_seen=%s", topic, info.get("records_seen"),
                )
        obs_events.emit(
            "scan_start",
            topic="<fleet>",
            partitions=sum(s.seed.partitions for s in self.scans.values()),
            batch_size=self.batch_size,
            fleet=True,
            topics=len(self.scans),
            follow=self.follow is not None,
        )

    # -- batch fleet ----------------------------------------------------------

    def run_batch(self) -> FleetResult:
        """Scan every topic once, in scheduler-planned waves of at most
        ``max_concurrent`` concurrent scans, sharing the worker budget
        within each wave."""
        self._start_banner()
        # Every topic waits for its grant from the fleet's start: the plan
        # defers a later wave's topics as the budget defers a wave's.
        offered = obs_trace.now()
        for scan in self.scans.values():
            scan.waiting_since = offered
        waves = self.scheduler.plan_waves(
            [s.seed for s in self.scans.values()]
        )
        for wave in waves:
            if self._stop.is_set():
                break
            ready = []
            for topic in wave:
                scan = self.scans[topic]
                if not self._ensure_source(scan):
                    continue
                if scan.source.is_empty():
                    # A fleet audit reports the empty topic as a status
                    # row — the solo scan's exit(-2) contract stays solo.
                    scan.status.status = "empty"
                    continue
                ready.append(
                    TopicSeed(
                        name=topic,
                        partitions=len(scan.source.partitions()),
                        lag=scan.source.total_records(),
                    )
                )
            self.scheduler.skip_idle(
                sum(1 for t in wave if self.scans[t].status.status == "empty")
            )
            # Acquire-before-scan (batch form): topics another instance
            # owns drop out of the wave — their refusals are booked by
            # the manager, and a concurrent batch audit splits the
            # cluster between instances instead of double-scanning it.
            if self.leases is not None:
                ready = [
                    s for s in ready
                    if self.leases.is_held(s.name)
                    or self.leases.acquire(s.name) is not None
                ]
            # Admission can defer part of the wave (the dispatch-token
            # budget caps concurrent device scans below the wave size);
            # re-offer the deferred remainder until the wave drains — a
            # batch fleet must scan EVERY topic, deferral only sequences.
            pending = ready
            while pending and not self._stop.is_set():
                grants = self.scheduler.admit(pending, reason="admitted-seed")
                if not grants:
                    break  # budget gone for good (cannot happen while
                    # grants release below, but never spin on it)
                self.spinner.set_message(
                    f"[fleet | wave: {', '.join(sorted(grants))}]"
                )
                with ThreadPoolExecutor(max_workers=len(grants)) as pool:
                    futures = {
                        t: pool.submit(
                            self._run_pass, self.scans[t], g, True
                        )
                        for t, g in grants.items()
                    }
                    for t, fut in futures.items():
                        fut.result()  # _run_pass never raises
                        self.scheduler.release(t)
                        if self.leases is not None:
                            self.leases.release(t)
                pending = [s for s in pending if s.name not in grants]
            self._evaluate_health()
            self._publish_rollup()
        return self._finish()

    # -- fleet follow ---------------------------------------------------------

    def _poll_topic(self, scan: _TopicScan) -> int:
        """Refresh one topic's watermarks through its retry budget and
        return its lag behind the head (0 on a failed/unbuildable
        source)."""
        if scan.status.status == "failed" or not self._ensure_source(scan):
            return 0
        try:
            start_w, end_w = scan.source.refresh_watermarks()
        except BaseException as e:  # noqa: BLE001 — isolation boundary
            scan.status.status = "failed"
            scan.status.error = f"{type(e).__name__}: {e}"
            log.exception("fleet: poll of topic %r failed", scan.seed.name)
            # A topic can fail while HOLDING a grant (admitted last poll,
            # broker died before this one): return its budget, or the
            # pool shrinks permanently with every such failure.
            self.scheduler.release(scan.seed.name)
            return 0
        lag = 0
        for p, end in end_w.items():
            lag += max(0, end - scan.cursor.get(p, start_w.get(p, 0)))
        scan.lag = lag
        scan.status.lag = lag
        # EVERY instance polls EVERY topic (polling is how lag is
        # discovered before acquiring), but the lag gauge merges by sum
        # across the fleet — so only the lease holder reports a topic's
        # lag; everyone else pins 0, or a federated scrape over-counts
        # cluster lag ~N-fold.  The returned lag stays real either way:
        # admission needs it to decide WHETHER to acquire.
        held = self.leases is None or self.leases.is_held(scan.seed.name)
        obs_metrics.FLEET_TOPIC_LAG.labels(
            topic=scan.seed.name, instance=self.instance
        ).set(lag if held else 0)
        return lag

    def run_follow(self) -> FleetResult:
        """The multi-topic tail loop: per poll, every topic's watermarks
        refresh, lagging topics are admitted (or keep their grants),
        admitted topics run one pass each (concurrently, bounded by the
        scheduler's concurrency), and the doctor's per-topic verdicts
        rebalance the budgets before the next poll."""
        assert self.follow is not None, "run_follow needs a FollowConfig"
        self._start_banner()
        idle_streak = 0
        idle_since: "Optional[float]" = None
        while True:
            self.polls += 1
            if (
                self.rediscover is not None
                and self.polls > 1
                and (self.polls - 1) % self.rediscover_every == 0
            ):
                try:
                    for seed in self.rediscover():
                        if seed.name not in self.scans:
                            self.scans[seed.name] = _TopicScan(seed)
                            self.discovered += 1
                            log.info(
                                "fleet: discovered new topic %r", seed.name
                            )
                except BaseException:  # noqa: BLE001 — isolation boundary
                    log.exception("fleet: re-discovery failed; keeping list")
            lags = {
                t: self._poll_topic(s) for t, s in list(self.scans.items())
            }
            lag_total = sum(lags.values())
            # Poll-boundary renewal: every held lease's
            # expiry extends here, once per poll — a store blip books
            # "deferred" inside the manager and the loop keeps going.
            if self.leases is not None:
                self.leases.renew_all()
            # The pause seam sits EXACTLY after the renew: a paused
            # instance's leases are as fresh as they will ever be, and
            # everything after resume runs on epochs that may have been
            # fenced meanwhile — the window the checkpoint-epoch check
            # must cover (the zombie window).
            while self._pause.is_set() and not self._stop.is_set():
                self.paused = True
                time.sleep(0.005)
            self.paused = False
            if self._killed:
                # Crash semantics: not one more admission, pass, or lease
                # decision after kill() — leases dangle exactly as a
                # SIGKILL would leave them.
                break
            # Poll-boundary health: the lag map just refreshed, so a
            # diverging topic flips /healthz within one poll.
            self._evaluate_health()
            ready = [
                TopicSeed(
                    name=t,
                    partitions=max(1, self.scans[t].status.partitions),
                    lag=lag,
                )
                for t, lag in sorted(lags.items())
                if lag > 0 or (
                    self.scans[t].first
                    and self.scans[t].status.status not in ("failed", "empty")
                    and self.scans[t].source is not None
                    and not self.scans[t].source.is_empty()
                )
            ]
            # Acquire-before-scan: a topic enters admission only under
            # a held (or just-acquired) lease.  Refusals are already
            # booked by the manager (held-elsewhere / lost-race /
            # store-error on kta_lease_acquisitions_total), so they are
            # excluded from the skipped-empty count below — they had
            # work, it just belongs to another instance.
            not_ours: "set" = set()
            if self.leases is not None:
                gated = []
                for s in ready:
                    if self.leases.is_held(s.name) or (
                        self.leases.acquire(s.name) is not None
                    ):
                        gated.append(s)
                    else:
                        not_ours.add(s.name)
                ready = gated
            ready_names = {s.name for s in ready}
            offered = obs_trace.now()
            for t, scan in self.scans.items():
                if t not in ready_names:
                    scan.waiting_since = None
                elif scan.waiting_since is None:
                    scan.waiting_since = offered
            self.scheduler.admit(ready)
            # "Skipped because empty" means exactly that: topics that
            # polled at the head with no work.  Failed topics are not
            # admission decisions (their trace ended at the failure), so
            # booking them here would corrupt the reconstructible trace.
            self.scheduler.skip_idle(
                sum(
                    1
                    for t in lags
                    if t not in ready_names
                    and t not in not_ours
                    and self.scans[t].status.status != "failed"
                )
            )
            admitted = {
                t: g
                for t, g in self.scheduler.grants().items()
                if t in self.scans and t in ready_names
            }
            if admitted:
                idle_streak = 0
                idle_since = None
                with ThreadPoolExecutor(max_workers=len(admitted)) as pool:
                    futures = {
                        t: pool.submit(self._run_pass, self.scans[t], g)
                        for t, g in admitted.items()
                    }
                    for t, fut in futures.items():
                        fut.result()  # _run_pass never raises
                if self._killed:
                    # kill() landed while passes ran: no post-pass
                    # bookkeeping, no caught-up lease release — the
                    # failover tests need exactly what a crash leaves.
                    break
                # Post-pass bookkeeping: verdicts drive the rebalance;
                # caught-up (or failed) topics return their budget.
                verdicts = {}
                for t in admitted:
                    scan = self.scans[t]
                    if scan.status.status == "failed":
                        self.scheduler.release(t)
                        # Let another instance try the topic — this
                        # one's source/backend is poisoned.
                        if self.leases is not None:
                            self.leases.release(t)
                        continue
                    if scan.status.status == "fenced":
                        # The lease itself was already fenced inside
                        # _run_pass; only the budget comes back here.
                        self.scheduler.release(t)
                        continue
                    caught_up = all(
                        scan.cursor.get(p, 0) >= end
                        for p, end in scan.source.watermarks()[1].items()
                    )
                    scan.lag = 0 if caught_up else scan.lag
                    scan.status.lag = scan.lag
                    if caught_up:
                        self.scheduler.release(t)
                        # Release-on-caught-up: a topic at the head is
                        # up for grabs again — ownership follows work.
                        if self.leases is not None:
                            self.leases.release(t)
                    elif scan.status.verdict:
                        verdicts[t] = scan.status.verdict
                if verdicts:
                    self.scheduler.rebalance(verdicts)
                self._evaluate_health()
                self._publish_rollup()
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
                self._publish_rollup()
            if self.scans and all(
                s.status.status == "failed" for s in self.scans.values()
            ):
                # Failure isolation needs survivors: when EVERY topic is
                # terminally failed (e.g. the whole cluster is
                # unreachable) there is nothing left to follow — exit
                # like the solo scan's hard error instead of polling a
                # dead cluster forever.
                self.request_stop("all-failed")
            if self._stop.is_set():
                break
            self.spinner.set_message(
                f"[fleet | topics: {len(self.scans)} | "
                f"active: {self.scheduler.active} | lag: {lag_total} | "
                f"polls: {self.polls}]"
            )
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
        # Shutdown boundary: one final pass per live topic commits the
        # final checkpoint (superbatch boundary by construction) and
        # settles each status row for the closing rollup — then every
        # held lease is RELEASED (not just checkpointed), so a rolling
        # restart under SIGTERM (serve/signals.py → request_stop) fails
        # over immediately instead of waiting out the TTL.  ``kill()``
        # skips all of it: a crash leaves leases dangling, and failover
        # happens the honest way, by expiry.
        if not self._killed:
            for t, scan in self.scans.items():
                if scan.backend is None or scan.status.status in (
                    "failed", "fenced",
                ):
                    continue
                if self.leases is not None and not self.leases.is_held(t):
                    # No lease, no write: a final pass on a topic we
                    # released (or never owned) would checkpoint with no
                    # epoch stamp, bypassing the fence.  Its last
                    # in-lease checkpoint stands; a successor rescans
                    # the (small) tail from there.
                    continue
                grant = (
                    self.scheduler.grant_for(t)
                    or scan.last_grant
                    or Grant(workers=1, dispatch_depth=1)
                )
                self._run_pass(scan, grant, final=True)
                self.scheduler.release(t)
            if self.leases is not None:
                self.leases.release_all()
        obs_events.emit(
            "follow_stop",
            reason=self._stop_reason or "stop",
            polls=self.polls,
            passes=sum(s.status.passes for s in self.scans.values()),
            fleet=True,
        )
        return self._finish()
