"""Process-wide fetch scheduler: ONE admission point for every remote byte
(port of the reference's ``io/fetchsched.py``).

A read-ahead pool per ingest stream could deepen concurrency only by
multiplying pools, never saturated a short-RTT store, and let concurrent
streams — parallel ingest workers, the catalog's header probes, fleet
topics — compete blindly for sockets.  This module gives the process
ONE scheduler instead (DESIGN.md §25):

- **Single admission point.**  All remote chunk-body fetches, catalog
  header probes, and plan-time resume probes submit here; nothing else in
  ``io/segstore.py`` / ``io/objstore.py`` / ``io/segfile.py`` may
  construct a pool or thread.  The worker pool is
  sized once per process (``--fetch-concurrency N|auto``), so total
  connection count is a process property, not ``streams × depth``.
- **Two priority classes.**  A DEMAND request is one a consumer is
  blocked on *right now* (the chunk the decoder needs next, a catalog
  probe the plan cannot proceed without); SPECULATIVE is read-ahead.
  Demand always outranks speculation — booked on
  ``kta_fetch_sched_reorders_total{reason="demand-over-speculative"}``
  when a demand request actually jumps queued speculative work, and
  ``{reason="deadline-promotion"}`` when a consumer reaches a chunk whose
  speculative request is still queued and promotes it.
- **Per-stream fairness, weighted.**  Each consumer registers a
  `FetchStream` with a WEIGHT (its lag / planned chunk count — the
  ingest read-ahead registers its segment-plan size; default 1.0), and
  selection within each priority class is smooth weighted round-robin
  across the streams that have queued work: a stream with twice the
  backlog weight is granted twice the admissions, interleaved (never
  bursted), and equal weights degrade to an exact round-robin — so a stream with a deep speculative backlog cannot starve a
  sibling's first request, and a fleet topic that is 10× further behind
  drains ~10× the bytes instead of splitting the wire evenly with an
  almost-caught-up sibling.  ``FetchStream.set_weight`` retargets a
  live stream (lag moves; weights follow).
- **Cancellation.**  A queued request can be cancelled before it starts
  (``kta_fetch_sched_cancelled_total``): degraded-partition skips and
  stream teardown must not pay for bytes nobody will read.  In-flight
  fetches are never interrupted — `shutdown` drains them cleanly.

Occupancy telemetry (``kta_fetch_sched_queue_depth`` /
``_inflight`` / ``_wait_seconds_total``) feeds FlightRecorder tracks so
`obs/doctor.py` can attribute a fetch-bound scan to scheduler starvation
(queue deeper than the pool — raise ``--fetch-concurrency``) vs wire
saturation (pool busy, queue shallow — the link is the limit).
"""

from __future__ import annotations

import os
import threading
from time import perf_counter as _perf_counter
from typing import Callable, Dict, List, Optional

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

#: Priority classes.  Smaller = served first.
DEMAND = 0
SPECULATIVE = 1

#: Ticket states.
_QUEUED, _RUNNING, _DONE, _CANCELLED = range(4)

#: Hard cap on the auto-sized pool: past ~16 connections the remote tier
#: is wire-bound, not admission-bound, and more threads only churn.
_MAX_AUTO = 16


def default_concurrency() -> int:
    """``--fetch-concurrency auto``: enough workers to keep a multi-stream
    scan's demand + speculation in flight on any host, capped where more
    sockets stop helping."""
    return min(_MAX_AUTO, max(4, os.cpu_count() or 4))


class FetchTicket:
    """One scheduled fetch: the callable, its stream/sequence position,
    its priority class, and (after completion) its outcome.  Waiters
    block on ``wait``/``result``; ``cancel`` works only while queued."""

    __slots__ = (
        "_sched", "stream_id", "fn", "seq", "pclass", "ordinal", "state",
        "submitted", "value", "error", "_done",
    )

    def __init__(
        self,
        sched: "FetchScheduler",
        stream_id: int,
        fn: "Callable[[], object]",
        seq: int,
        pclass: int,
        ordinal: int,
    ):
        self._sched = sched
        self.stream_id = stream_id
        self.fn = fn
        self.seq = seq
        self.pclass = pclass
        #: Global submission order — the referee for "did a demand
        #: request actually jump queued speculative work".
        self.ordinal = ordinal
        self.state = _QUEUED
        self.submitted = _perf_counter()
        self.value: object = None
        self.error: "Optional[BaseException]" = None
        self._done = threading.Event()

    def wait(self, timeout: "Optional[float]" = None) -> bool:
        """Block until the fetch completed or was cancelled."""
        return self._done.wait(timeout)

    def result(self, timeout: "Optional[float]" = None) -> object:
        """The fetch's return value, re-raising its exception in the
        caller (the synchronous-fetch contract `run`/`run_all` build on)."""
        if not self._done.wait(timeout):
            raise TimeoutError("fetch request did not complete in time")
        if self.error is not None:
            raise self.error
        return self.value

    def cancel(self) -> bool:
        """Cancel if still queued (booked); False once started/finished."""
        return self._sched.cancel(self)

    @property
    def cancelled(self) -> bool:
        return self.state == _CANCELLED


class FetchStream:
    """One consumer's handle on the scheduler: the unit of weighted
    fairness.  Each ingest stream (and each catalog open) registers its
    own; ``close`` cancels everything of this stream still queued."""

    def __init__(self, sched: "FetchScheduler", sid: int):
        self._sched = sched
        self.sid = sid
        self._closed = False

    def set_weight(self, weight: float) -> "FetchStream":
        """Retarget this stream's fairness weight (lag / partition or
        chunk count).  Selection share within a priority class is
        proportional among streams with queued work; takes effect on
        the next admission."""
        self._sched.set_weight(self.sid, weight)
        return self

    def submit(
        self, fn: "Callable[[], object]", seq: int = 0,
        speculative: bool = True,
    ) -> FetchTicket:
        if self._closed:
            raise RuntimeError("fetch stream is closed")
        return self._sched._submit(
            self.sid, fn, seq, SPECULATIVE if speculative else DEMAND
        )

    def demand(self, ticket: FetchTicket) -> None:
        """The consumer is blocked on this request NOW: promote it past
        every speculative fetch (booked when it was still queued) and
        wait for it to finish."""
        self._sched.promote(ticket)
        ticket.wait()

    def close(self) -> None:
        """Unregister the stream; queued requests are cancelled (booked),
        in-flight ones finish on their worker."""
        if not self._closed:
            self._closed = True
            self._sched._close_stream(self.sid)


class FetchScheduler:
    """The shared worker pool + priority queue.  One instance per process
    (`get_scheduler`); tests may construct private instances."""

    def __init__(self, concurrency: "Optional[int]" = None):
        if concurrency is None:
            concurrency = default_concurrency()
        if concurrency < 1:
            raise ValueError("fetch concurrency must be >= 1")
        self._cv = threading.Condition()
        self._target = int(concurrency)
        #: stream id -> queued tickets (unordered; selection scans).
        self._queues: "Dict[int, List[FetchTicket]]" = {}
        #: Stream ids in registration order — the deterministic
        #: tie-break for weighted selection.
        self._order: "List[int]" = []
        #: Smooth weighted round-robin state (nginx SWRR): each
        #: selection credits every CANDIDATE stream (queued work in the
        #: class being served) by its weight, picks the highest credit,
        #: and debits the winner by the candidates' total — proportional
        #: shares, interleaved, deterministic, and exactly round-robin
        #: when all weights are equal.
        self._weights: "Dict[int, float]" = {}
        self._credits: "Dict[int, float]" = {}
        self._next_sid = 0
        self._ordinal = 0
        self._live = 0
        self._idle = 0
        self._spawned = 0
        self._threads: "List[threading.Thread]" = []
        self._stopped = False

    @property
    def concurrency(self) -> int:
        return self._target

    # -- streams --------------------------------------------------------------

    def stream(self, weight: float = 1.0) -> FetchStream:
        if weight <= 0:
            raise ValueError("fetch stream weight must be > 0")
        with self._cv:
            if self._stopped:
                raise RuntimeError("fetch scheduler is shut down")
            sid = self._next_sid
            self._next_sid += 1
            self._order.append(sid)
            self._queues[sid] = []
            self._weights[sid] = float(weight)
            self._credits[sid] = 0.0
        return FetchStream(self, sid)

    def set_weight(self, sid: int, weight: float) -> None:
        if weight <= 0:
            raise ValueError("fetch stream weight must be > 0")
        with self._cv:
            if sid in self._weights:
                self._weights[sid] = float(weight)

    def _close_stream(self, sid: int) -> None:
        with self._cv:
            dropped = [
                t for t in self._queues.pop(sid, [])
                if t.state == _QUEUED
            ]
            for t in dropped:
                t.state = _CANCELLED
                obs_metrics.FETCH_SCHED_QUEUE_DEPTH.inc(-1)
                obs_metrics.FETCH_SCHED_CANCELLED.inc()
            if sid in self._order:
                self._order.remove(sid)
            self._weights.pop(sid, None)
            self._credits.pop(sid, None)
        for t in dropped:
            t._done.set()

    # -- submission / cancellation / promotion --------------------------------

    def _submit(
        self, sid: int, fn: "Callable[[], object]", seq: int, pclass: int
    ) -> FetchTicket:
        with self._cv:
            if self._stopped:
                raise RuntimeError("fetch scheduler is shut down")
            ticket = FetchTicket(self, sid, fn, seq, pclass, self._ordinal)
            self._ordinal += 1
            self._queues.setdefault(sid, []).append(ticket)
            obs_metrics.FETCH_SCHED_QUEUE_DEPTH.inc(1)
            self._ensure_workers()
            self._cv.notify()
        return ticket

    def cancel(self, ticket: FetchTicket) -> bool:
        with self._cv:
            if ticket.state != _QUEUED:
                return False
            q = self._queues.get(ticket.stream_id)
            if q is not None and ticket in q:
                q.remove(ticket)
            ticket.state = _CANCELLED
            obs_metrics.FETCH_SCHED_QUEUE_DEPTH.inc(-1)
            obs_metrics.FETCH_SCHED_CANCELLED.inc()
        ticket._done.set()
        return True

    def promote(self, ticket: FetchTicket) -> bool:
        """Raise a queued speculative request to DEMAND (the deadline
        rule: the chunk a decoder needs next outranks read-ahead)."""
        with self._cv:
            if ticket.state != _QUEUED or ticket.pclass != SPECULATIVE:
                return False
            ticket.pclass = DEMAND
            obs_metrics.FETCH_SCHED_REORDERS.labels(
                reason="deadline-promotion"
            ).inc()
            self._cv.notify()
        return True

    # -- synchronous conveniences ---------------------------------------------

    def run(self, fn: "Callable[[], object]") -> object:
        """One demand fetch through the pool, result (or exception)
        re-delivered in the caller — the plan-time probe path."""
        stream = self.stream()
        try:
            return stream.submit(fn, seq=0, speculative=False).result()
        finally:
            stream.close()

    def run_all(self, fns: "List[Callable[[], object]]") -> "List[object]":
        """Demand-fetch a batch concurrently, results in submission order
        (the catalog's header-probe fan-out).  The first failure by order
        is re-raised after every request settled — a catalog either opens
        whole or fails deterministically, never half-probed."""
        stream = self.stream()
        try:
            tickets = [
                stream.submit(fn, seq=i, speculative=False)
                for i, fn in enumerate(fns)
            ]
            for t in tickets:
                t.wait()
            for t in tickets:
                if t.error is not None:
                    raise t.error
            return [t.value for t in tickets]
        finally:
            stream.close()

    # -- selection (the admission policy) --------------------------------------

    def _pick_stream(self, pclass: int) -> "Optional[int]":
        """Smooth weighted round-robin over the streams with queued work
        in ``pclass`` (callers hold the lock).  Idle streams accrue no
        credit, so a stream that sat quiet cannot burst later; ties
        break by registration order, keeping selection deterministic."""
        candidates = [
            sid
            for sid in self._order
            if any(t.pclass == pclass for t in self._queues.get(sid, ()))
        ]
        if not candidates:
            return None
        total = 0.0
        best_sid: "Optional[int]" = None
        for sid in candidates:
            w = self._weights.get(sid, 1.0)
            total += w
            self._credits[sid] = self._credits.get(sid, 0.0) + w
            if best_sid is None or self._credits[sid] > self._credits[best_sid]:
                best_sid = sid
        self._credits[best_sid] -= total
        return best_sid

    def _select(self) -> "Optional[FetchTicket]":
        """Pick the next request (callers hold the lock): DEMAND before
        SPECULATIVE, weighted round-robin across streams within a class
        (`_pick_stream`), lowest (seq, ordinal) within a stream —
        deterministic given the queue and the weights."""
        for pclass in (DEMAND, SPECULATIVE):
            sid = self._pick_stream(pclass)
            if sid is None:
                continue
            q = self._queues[sid]
            best: "Optional[FetchTicket]" = None
            for t in q:
                if t.pclass != pclass:
                    continue
                if best is None or (t.seq, t.ordinal) < (
                    best.seq, best.ordinal
                ):
                    best = t
            q.remove(best)
            if pclass == DEMAND and any(
                t.pclass == SPECULATIVE and t.ordinal < best.ordinal
                for queue in self._queues.values()
                for t in queue
            ):
                # This demand request jumped speculative work that was
                # submitted before it — the deadline rule reordering
                # the wire, made visible.
                obs_metrics.FETCH_SCHED_REORDERS.labels(
                    reason="demand-over-speculative"
                ).inc()
            best.state = _RUNNING
            obs_metrics.FETCH_SCHED_QUEUE_DEPTH.inc(-1)
            return best
        return None

    # -- the worker pool -------------------------------------------------------

    def _ensure_workers(self) -> None:
        """Spawn workers lazily up to the target while queued work exceeds
        idle capacity (callers hold the lock).  Threads are daemons: the
        pool never blocks interpreter exit."""
        backlog = sum(len(q) for q in self._queues.values())
        while (
            self._live < self._target
            and backlog > self._idle
            and not self._stopped
        ):
            self._live += 1
            self._spawned += 1
            th = threading.Thread(
                target=self._worker,
                name=f"kta-fetch-sched-{self._spawned}",
                daemon=True,
            )
            self._threads.append(th)
            th.start()
            backlog -= 1

    def _worker(self) -> None:
        while True:
            with self._cv:
                req: "Optional[FetchTicket]" = None
                while req is None:
                    if self._stopped or self._live > self._target:
                        self._live -= 1
                        return
                    req = self._select()
                    if req is None:
                        self._idle += 1
                        self._cv.wait()
                        self._idle -= 1
            obs_metrics.FETCH_SCHED_WAIT_SECONDS.inc(
                max(0.0, _perf_counter() - req.submitted)
            )
            obs_metrics.FETCH_SCHED_INFLIGHT.inc(1)
            try:
                req.value = req.fn()
            except BaseException as e:  # noqa: BLE001 — delivered to waiter
                req.error = e
            finally:
                obs_metrics.FETCH_SCHED_INFLIGHT.inc(-1)
                with self._cv:
                    req.state = _DONE
                req._done.set()

    def resize(self, concurrency: int) -> None:
        """Retarget the pool.  Growth spawns on the next submissions;
        excess workers exit as they finish their current fetch."""
        if concurrency < 1:
            raise ValueError("fetch concurrency must be >= 1")
        with self._cv:
            self._target = int(concurrency)
            self._ensure_workers()
            self._cv.notify_all()

    def shutdown(self, wait: bool = True) -> None:
        """Clean shutdown mid-fetch: queued requests are cancelled
        (booked), in-flight fetches complete on their workers, workers
        exit.  ``wait=True`` joins them."""
        with self._cv:
            self._stopped = True
            dropped = [
                t
                for q in self._queues.values()
                for t in q
                if t.state == _QUEUED
            ]
            for t in dropped:
                t.state = _CANCELLED
                obs_metrics.FETCH_SCHED_QUEUE_DEPTH.inc(-1)
                obs_metrics.FETCH_SCHED_CANCELLED.inc()
            self._queues.clear()
            self._cv.notify_all()
        for t in dropped:
            t._done.set()
        if wait:
            for th in self._threads:
                th.join(timeout=30)


# -- the process singleton -----------------------------------------------------

_lock = threading.Lock()
_singleton: "Optional[FetchScheduler]" = None
#: Last configured size + whether it came from an explicit flag value
#: (explicit beats auto: a later auto hint never shrinks or overrides
#: what the operator asked for).
_configured: "Optional[int]" = None
_explicit = False


def configure(concurrency: int, explicit: bool = True) -> None:
    """Size the process-wide pool (``--fetch-concurrency``).  Safe to
    call repeatedly — e.g. once per fleet topic source sharing one
    process: the LAST explicit value wins; auto hints only apply while
    no explicit size was ever given."""
    global _configured, _explicit
    if concurrency < 1:
        raise ValueError("fetch concurrency must be >= 1")
    with _lock:
        if not explicit and _explicit:
            return
        _configured = int(concurrency)
        _explicit = _explicit or explicit
        if _singleton is not None:
            _singleton.resize(_configured)


def note_streams(streams: int) -> None:
    """Engine hint: ``streams`` ingest streams are about to drain
    concurrently.  Under auto sizing, grow the pool so every stream can
    hold a demand fetch plus some speculation without starving siblings;
    an explicit ``--fetch-concurrency`` is never overridden."""
    want = min(_MAX_AUTO, max(default_concurrency(), streams + 2))
    with _lock:
        if _explicit:
            return
        global _configured
        if _configured is None or want > _configured:
            _configured = want
            if _singleton is not None:
                _singleton.resize(want)


def get_scheduler() -> FetchScheduler:
    """THE process-wide scheduler, created on first use at the configured
    (or auto) size."""
    global _singleton
    with _lock:
        if _singleton is None:
            _singleton = FetchScheduler(
                _configured if _configured is not None
                else default_concurrency()
            )
        return _singleton


def _reset_for_tests() -> None:
    """Tear down the singleton (tests only): shut the pool, forget the
    configuration."""
    global _singleton, _configured, _explicit
    with _lock:
        sched, _singleton = _singleton, None
        _configured = None
        _explicit = False
    if sched is not None:
        sched.shutdown(wait=True)
