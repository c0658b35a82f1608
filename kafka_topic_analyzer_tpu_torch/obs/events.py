"""Structured event log: scan lifecycle + transport-fault events as JSONL
(port of the reference's ``obs/events.py``, unchanged; the follow-mode
events below are not emitted until follow mode is ported).

The module-level bus is a no-op until a sink attaches (``emit`` returns
after one attribute load when the sink list is empty), so library modules
emit unconditionally — the hot paths pay nothing unless ``--events-jsonl``
(or a test sink) is active.

Event catalog (field names stable — they are an output format):

- ``scan_start``            topic, partitions, batch_size
- ``heartbeat``             seq, records_per_sec, lag_total   (rate-limited)
- ``snapshot_saved``        records_seen
- ``transport_failure``     leader, partitions, error
- ``connection_evicted``    host, port
- ``metadata_reload``       ok
- ``fetch_error``           partition, code
- ``retry_budget_exhausted`` partition, reason
- ``partition_degraded``    partition, reason
- ``corrupt_suspect``       partition, anchor, kind   (re-fetch pending)
- ``corrupt_frame``         partition, anchor, skip_to, kind, action,
                            quarantined
- ``scan_end``              topic, records, duration_secs, degraded,
                            corrupt_frames

Follow-mode additions (serve/follow.py; a service run emits ONE
scan_start/scan_end pair for its whole lifetime — per-pass lifecycle
events are suppressed so a long-lived run cannot flood the log):

- ``follow_poll``           poll, new_records, lag_total   (only on polls
                            that found new records; idle polls are silent)
- ``watermark_refresh_failed``  attempts, error   (budget exhausted; the
                            previous watermark snapshot stays in force)
- ``partition_healed``      partition   (a degraded partition caught back
                            up to the head in a later follow pass)
- ``follow_stop``           reason, polls, passes   (stop requested:
                            signal name, 'idle', or a caller's reason)
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional


class JsonlEventLog:
    """Append-only JSONL sink: one ``{"ts": ..., "type": ..., ...}`` object
    per line, flushed per event (events are rare — scan lifecycle and
    faults, not records — so durability beats buffering)."""

    def __init__(self, path: str, clock: Callable[[], float] = time.time):
        self._fh = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._clock = clock

    def __call__(self, etype: str, fields: dict) -> None:
        doc = {"ts": round(self._clock(), 3), "type": etype}
        doc.update(fields)
        line = json.dumps(doc, default=str, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


_sinks: "List[Callable[[str, dict], None]]" = []


def add_sink(sink: Callable[[str, dict], None]) -> None:
    _sinks.append(sink)


def remove_sink(sink: Callable[[str, dict], None]) -> None:
    try:
        _sinks.remove(sink)
    except ValueError:
        pass


def emit(etype: str, **fields) -> None:
    """Publish an event to every attached sink.  A sink that raises is
    detached (a full disk must not take down the scan) — telemetry is
    best-effort by contract."""
    if not _sinks:
        return
    for sink in list(_sinks):
        try:
            sink(etype, fields)
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "event sink failed; detaching it"
            )
            remove_sink(sink)


class Heartbeat:
    """Rate limiter for periodic status events: ``ready()`` is True at most
    once per ``interval_s`` (clock-injectable for tests)."""

    def __init__(
        self,
        interval_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.interval_s = interval_s
        self._clock = clock
        self._last: Optional[float] = None

    def ready(self) -> bool:
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        return True

    def force(self) -> None:
        """Make the next ``ready()`` fire regardless of the interval
        (closing heartbeat at scan end)."""
        self._last = None
