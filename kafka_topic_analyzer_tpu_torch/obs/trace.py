"""Host-side span tracer → Chrome trace-event JSON (port of the reference's
``obs/trace.py``, with one clock, span ids and a scan context).

``--profile-dir`` captures the device timeline through ``torch.profiler``;
this records the *host* side (fetch rounds, decode→pack, staging, fold
dispatch, snapshot, finalize and its phases) in the same Chrome
``traceEvents`` format.  With both flags the host spans are also merged
into the profiler's trace on its time base (`utils.profiling.
maybe_torch_trace`), so a device gap sits under the host span that caused
it in one file.

Spans are complete events (``ph: "X"``) appended under a lock — ingest
workers and fetch-pool threads record concurrently and the per-thread
``tid`` keeps their tracks separate.  Every span is stamped from its
tracer's own clock (`SpanTracer.now`), whatever the call site measures
with, and `timed` books the counter beside a span with the span's own
duration, so the trace and the counters cannot drift apart.  A span's
``args`` carry its ``id``, the ``parent`` id of the span enclosing it on
the same thread (None at a thread's top level), and the thread's bound
context (`bind`): the ``scan`` number `begin_scan` hands out, and the
``worker`` of an ingest worker's spans.  ``ScanProfile`` mirrors its
stage windows into the active tracer with the *same* measured duration,
so the trace's per-stage totals agree with ``--stats`` by construction
(tests/test_torch_telemetry.py holds them equal).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class SpanTracer:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        #: Counter events, and spans as `_record` keeps them.
        self._events: List[object] = []
        self._ids = itertools.count(1)
        #: Per thread: the ids of its open spans, innermost last.
        self._local = threading.local()
        #: ``tid`` → thread name, for the tracks of a merged trace.
        self.threads: Dict[int, str] = {}

    def now(self) -> float:
        """A reading of this tracer's clock: the one every span it
        records is stamped from."""
        return self._clock()

    def ts_us(self, t: float) -> float:
        """A reading of `now` as the ``ts`` of this tracer's events."""
        return (t - self._t0) * 1e6

    def begin(self) -> Tuple[int, Optional[int]]:
        """Open a span on the calling thread: its id and the id of the
        span enclosing it there (None at the thread's top level)."""
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            self.threads[_get_ident()] = threading.current_thread().name
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        return sid, parent

    def end(
        self,
        span: Tuple[int, Optional[int]],
        name: str,
        start_s: float,
        dur_s: float,
        cat: str = "span",
        args: "Optional[dict]" = None,
    ) -> None:
        """Close the calling thread's innermost span (``span``, from
        `begin`: spans close in the reverse order they open) and record
        it with the thread's context, its id and its parent's id in
        ``args``."""
        self._local.stack.pop()
        self._record(name, cat, start_s, dur_s, (getattr(_local, "ctx", None), args, span))

    def add_complete(
        self,
        name: str,
        start_s: float,
        dur_s: float,
        cat: str = "span",
        args: "Optional[dict]" = None,
    ) -> None:
        """Record one complete span with ``args`` alone; ``start_s`` is a
        reading of `now` (the program's spans are opened and closed
        through `begin`/`end` or `timed`, which read it, so the recorded
        duration is exactly the measured one)."""
        self._record(name, cat, start_s, dur_s, args)

    def _record(self, name, cat, start_s, dur_s, args) -> None:
        # A tuple, made an event by `events`: the recording threads pay
        # for no dict, and a list's append is atomic without the lock.
        self._events.append((name, cat, start_s, dur_s, _get_ident(), args))

    def _event(self, rec) -> dict:
        """The Chrome event of a recorded span (`_record`)."""
        if isinstance(rec, dict):
            return rec
        name, cat, start_s, dur_s, tid, args = rec
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (start_s - self._t0) * 1e6,
            "dur": dur_s * 1e6,
            "pid": self._pid,
            "tid": tid,
        }
        if isinstance(args, tuple):
            ctx, extra, (sid, parent) = args
            args = {**(ctx or {}), **(extra or {}), "id": sid, "parent": parent}
        if args:
            ev["args"] = args
        return ev

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
            "pid": self._pid,
            "tid": 0,  # counter tracks live on one lane, not per-thread
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, cat: str = "span", **args) -> "timed":
        """A span on this tracer around the enclosed block."""
        return timed(name, cat=cat, tracer=self, **args)

    def events(self) -> List[dict]:
        with self._lock:
            recs = list(self._events)
        return [self._event(rec) for rec in recs]

    def chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)


_get_ident = threading.get_ident
_active: "Optional[SpanTracer]" = None
_local = threading.local()
_scans = itertools.count(1)


def set_active(tracer: "Optional[SpanTracer]") -> None:
    global _active
    _active = tracer


def active() -> "Optional[SpanTracer]":
    return _active


def context() -> dict:
    """The calling thread's bound span context (``scan``, ``worker``)."""
    return getattr(_local, "ctx", {})


def bind(ctx: dict) -> None:
    """Bind ``ctx`` as the calling thread's span context: a thread that
    works for a scan binds the context of the thread that started it
    (`context`), plus its own keys."""
    _local.ctx = dict(ctx)


def begin_scan() -> int:
    """Number a new scan (an audit, a follow pass) of this process and
    bind it as the calling thread's ``scan``."""
    n = next(_scans)
    bind({**context(), "scan": n})
    return n


_UNSET = object()


class timed:
    """Time the enclosed block on the active tracer's clock (the
    ``perf_counter`` when tracing is off) and record it there as a span
    when a tracer is active.  ``counter`` (anything with ``inc``) books
    the same duration; ``seconds`` holds it after the block."""

    __slots__ = ("name", "cat", "counter", "args", "tracer", "seconds",
                 "_t0", "_span")

    def __init__(self, name: str, counter=None, cat: str = "span",
                 tracer=_UNSET, **args):
        self.name = name
        self.cat = cat
        self.counter = counter
        self.args = args
        self.tracer = _active if tracer is _UNSET else tracer
        self.seconds = 0.0

    def __enter__(self) -> "timed":
        tr = self.tracer
        if tr is None:
            self._t0 = time.perf_counter()
        else:
            self._span = tr.begin()
            self._t0 = tr.now()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        if tr is None:
            self.seconds = time.perf_counter() - self._t0
        else:
            self.seconds = tr.now() - self._t0
            tr.end(self._span, self.name, self._t0, self.seconds, self.cat,
                   self.args or None)
        if self.counter is not None:
            self.counter.inc(self.seconds)
        return False


def now() -> float:
    """A reading of the clock `timed` reads: the active tracer's, else
    the ``perf_counter``."""
    tr = _active
    return tr.now() if tr is not None else time.perf_counter()


def since(name: str, start_s: float, counter=None, cat: str = "span",
          **args) -> float:
    """Record on the calling thread a span from ``start_s`` (a reading of
    `now`) to now, as `timed` would have, and book its duration on
    ``counter``: a wait that began before the thread that ends it took
    over.  Returns the duration."""
    tr = _active
    if tr is None:
        dur = max(0.0, time.perf_counter() - start_s)
    else:
        span = tr.begin()
        dur = max(0.0, tr.now() - start_s)
        tr.end(span, name, start_s, dur, cat, args or None)
    if counter is not None:
        counter.inc(dur)
    return dur


def maybe_span(name: str, cat: str = "span") -> timed:
    """Span on the active tracer, or a bare timing when tracing is off —
    what library modules (io/kafka_wire.py) wrap their fetch/decode work
    in without threading a tracer through every call."""
    return timed(name, cat=cat)
