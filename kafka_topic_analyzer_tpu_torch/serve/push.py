"""Server-Sent-Events push channel for report publishes (port of the
reference's ``serve/push.py``; DESIGN.md §26).

Polling dashboards pay one request per second forever to learn "nothing
changed".  This module inverts the flow: every ``ServiceState.publish``
(one per poll boundary) is offered here, and ``/events`` subscribers
receive one compact SSE frame per publish — snapshot seq, topic, byte
size, and the drive loop's delta summary — so a dashboard polls zero
times and fetches a body only when the seq actually moved (and then
usually gets a 304-free gzip body one conditional GET later).

Backpressure contract (the part that keeps rule 9's spirit intact):

- **The drive loop never blocks on a subscriber.**  ``offer()`` is an
  O(1) intake append + notify; formatting (``json.dumps`` of the
  summary) and fan-out writes happen on THIS module's dedicated
  publisher thread, never the drive loop and never a handler.
- **Bounded per-subscriber queues, eviction over blocking.**  Each
  subscriber owns a bounded queue of pre-formatted frames.  A slow
  client whose queue is full is EVICTED — its stream is closed and the
  drop is booked (``kta_serve_sse_dropped_total{reason="slow-client"}``,
  never silent) — because one stalled socket must not delay the frames
  every healthy subscriber is owed.
- **Catch-up on (re)connect.**  The latest frame is re-delivered to
  every new subscriber, so an evicted client that reconnects learns the
  current seq immediately instead of waiting for the next publish.

The handler side (obs/exporters.py) only calls ``subscribe`` /
``unsubscribe`` and blocking-reads frames off its own queue — it takes
no locks of its own and serializes nothing, so the extended rule 9
(no json/gzip in handlers) holds for the streaming route too.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import deque
from typing import Deque, List, Optional

from kafka_topic_analyzer_tpu_torch.config import DEFAULT_SERVE
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

#: Default bound on a subscriber's frame queue (config.ServeConfig).
#: Publishes happen once per poll boundary (~1/s), so 64 outstanding
#: frames is already a minute of a client reading nothing — past that,
#: eviction.
DEFAULT_QUEUE_LEN = DEFAULT_SERVE.sse_queue_len

#: Sentinel closing a subscriber's stream (eviction or shutdown).
CLOSE = None


class SseSubscriber:
    """One ``/events`` connection's frame queue (handler side holds it)."""

    __slots__ = ("q", "closed")

    def __init__(self, queue_len: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_len)
        self.closed = False

    def next_frame(self, timeout: "Optional[float]" = None):
        """Next pre-formatted frame, ``CLOSE`` when the stream ended, or
        raises ``queue.Empty`` on timeout (the handler's keepalive
        boundary)."""
        return self.q.get(timeout=timeout)


class SsePublisher:
    """The session's SSE fan-out: one intake, one publisher thread, N
    bounded subscriber queues."""

    def __init__(self, queue_len: int = DEFAULT_QUEUE_LEN):
        if queue_len < 1:
            raise ValueError("SSE queue length must be >= 1")
        self.queue_len = int(queue_len)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._intake: "Deque[object]" = deque()
        self._subs: "List[SseSubscriber]" = []
        self._last_frame: "Optional[bytes]" = None
        self._stopped = False
        self._thread: "Optional[threading.Thread]" = None
        #: Publishes seen / frames fanned out (tests + bench referee).
        self.offered = 0
        self.delivered = 0

    # -- drive-loop side ------------------------------------------------------

    def offer(self, entry) -> None:
        """Hand one published snapshot to the fan-out (O(1); called from
        ``ServiceState.publish`` at poll boundaries).  ``entry`` is a
        ``serve.state.PublishedReport`` — only its ``summary`` rides the
        wire."""
        with self._lock:
            if self._stopped:
                return
            self._intake.append(entry)
            self.offered += 1
        self._wake.set()

    # -- handler side ---------------------------------------------------------

    def subscribe(self) -> SseSubscriber:
        """Register one ``/events`` connection.  The latest frame (if
        any) is pre-queued — the catch-up contract."""
        sub = SseSubscriber(self.queue_len)
        with self._lock:
            if self._stopped:
                sub.closed = True
                sub.q.put_nowait(CLOSE)
                return sub
            if self._last_frame is not None:
                sub.q.put_nowait(self._last_frame)
            self._subs.append(sub)
        obs_metrics.SERVE_SSE_SUBSCRIBERS.inc(1)
        return sub

    def unsubscribe(self, sub: SseSubscriber) -> None:
        """Drop one connection (handler teardown; idempotent with
        eviction — whoever removes the subscriber decrements)."""
        with self._lock:
            if sub.closed or sub not in self._subs:
                return
            self._subs.remove(sub)
            sub.closed = True
        obs_metrics.SERVE_SSE_SUBSCRIBERS.inc(-1)

    @property
    def subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- the publisher thread -------------------------------------------------

    def start(self) -> "SsePublisher":
        if self._thread is not None:
            raise RuntimeError("SSE publisher already started")
        self._thread = threading.Thread(
            target=self._run, name="kta-sse-publisher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close every stream (booked ``reason="shutdown"``) and join the
        publisher thread (idempotent)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            subs, self._subs = self._subs, []
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for sub in subs:
            sub.closed = True
            self._close_queue(sub)
            obs_metrics.SERVE_SSE_SUBSCRIBERS.inc(-1)
            obs_metrics.SERVE_SSE_DROPPED.labels(reason="shutdown").inc()

    @staticmethod
    def _close_queue(sub: SseSubscriber) -> None:
        """Make room if needed and enqueue the CLOSE sentinel so a
        blocked handler wakes up promptly."""
        try:
            sub.q.put_nowait(CLOSE)
        except queue.Full:
            try:
                sub.q.get_nowait()
            except queue.Empty:
                pass
            try:
                sub.q.put_nowait(CLOSE)
            except queue.Full:
                pass  # another closer already made the queue terminal

    def _format(self, entry) -> bytes:
        """One SSE frame: event name, seq as the event id (clients
        resume with Last-Event-ID semantics), compact JSON summary."""
        data = json.dumps(entry.summary, separators=(",", ":"))
        return (
            f"event: publish\nid: {entry.seq}\ndata: {data}\n\n"
        ).encode()

    def _run(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if self._stopped and not self._intake:
                    return
                batch = list(self._intake)
                self._intake.clear()
                self._wake.clear()
            for entry in batch:
                frame = self._format(entry)
                with self._lock:
                    self._last_frame = frame
                    subs = list(self._subs)
                evicted: "List[SseSubscriber]" = []
                for sub in subs:
                    try:
                        sub.q.put_nowait(frame)
                        self.delivered += 1
                    except queue.Full:
                        evicted.append(sub)
                for sub in evicted:
                    # Slow-client eviction: booked, never silent.  The
                    # handler sees CLOSE and ends the response; the
                    # client's reconnect gets catch-up.
                    with self._lock:
                        if sub in self._subs:
                            self._subs.remove(sub)
                            sub.closed = True
                        else:
                            continue
                    obs_metrics.SERVE_SSE_SUBSCRIBERS.inc(-1)
                    obs_metrics.SERVE_SSE_DROPPED.labels(
                        reason="slow-client"
                    ).inc()
                    self._close_queue(sub)


_active: "Optional[SsePublisher]" = None


def set_active(pub: "Optional[SsePublisher]") -> None:
    global _active
    _active = pub


def active() -> "Optional[SsePublisher]":
    return _active
