"""Host-side span tracer → Chrome trace-event JSON (port of the reference's
``obs/trace.py``, unchanged).

``--profile-dir`` captures the device timeline through ``torch.profiler``;
this records the *host* side (fetch, decode, fold dispatch, snapshot,
finalize) in the same Chrome ``traceEvents`` format, so both timelines
load into the same viewer (chrome://tracing, Perfetto) for side-by-side
inspection.

Spans are complete events (``ph: "X"``) appended under a lock — prefetch
workers and fetch-pool threads record concurrently and the per-thread
``tid`` keeps their tracks separate.  ``ScanProfile`` mirrors its stage
windows into the active tracer with the *same* measured duration, so the
trace's per-stage totals agree with ``--stats`` by construction
(tests/test_telemetry.py holds them within 5%).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Iterator, List, Optional


class SpanTracer:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def add_complete(
        self,
        name: str,
        start_s: float,
        dur_s: float,
        cat: str = "span",
        args: "Optional[dict]" = None,
    ) -> None:
        """Record one complete span; ``start_s`` is in this tracer's clock
        domain (the same clock used by the caller's measurement, so the
        recorded duration is exactly the measured one)."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (start_s - self._t0) * 1e6,
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_counter(
        self, name: str, values: "dict", t_s: "Optional[float]" = None
    ) -> None:
        """Record one counter-track sample (``ph: "C"``): the flight
        recorder's occupancy gauges render as stacked numeric lanes under
        the stage spans in chrome://tracing / Perfetto.  ``t_s`` is in
        this tracer's clock domain, like ``add_complete``; None stamps
        the sample "now" (callers on a different clock — the flight
        recorder's injectable monotonic — must not translate domains).
        ``values`` maps series name -> number (one lane per key)."""
        ev = {
            "name": name,
            "cat": "flight",
            "ph": "C",
            "ts": ((self._clock() if t_s is None else t_s) - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": 0,  # counter tracks live on one lane, not per-thread
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.add_complete(
                name, t0, self._clock() - t0, cat, args or None
            )

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)


_active: "Optional[SpanTracer]" = None


def set_active(tracer: "Optional[SpanTracer]") -> None:
    global _active
    _active = tracer


def active() -> "Optional[SpanTracer]":
    return _active


@contextlib.contextmanager
def maybe_span(name: str, cat: str = "span") -> Iterator[None]:
    """Span on the active tracer, or a fast no-op when tracing is off —
    what library modules (io/kafka_wire.py) wrap their fetch/decode work
    in without threading a tracer through every call."""
    tr = _active
    if tr is None:
        yield
        return
    with tr.span(name, cat):
        yield
