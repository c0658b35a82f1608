"""Per-stage throughput counters + optional ``torch.profiler`` traces
(port of the reference's ``utils/profiling.py``).

The reference's only observability is wall-clock + a derived msgs/s
(src/main.rs:129-130, SURVEY.md §5.1).  Since msgs/s *is* the north-star
metric here, the engine keeps per-stage (ingest / dispatch / finalize)
wall-time and record counters, and can wrap the scan in a
``torch.profiler`` trace (``--profile-dir``, `maybe_torch_trace`) where the
reference writes a JAX profiler trace.

On CUDA a stage window times what the host does inside it: enqueueing
kernels and copies, plus real waits (a slot whose copy is still in flight,
the dispatch queue's throttle, finalize's device-to-host copy).  Nothing
here synchronizes the device, so a stage time is not a device time; the
device side lives in the ``--profile-dir`` trace.

Each stage window also books the drive loop thread's CPU seconds inside
it (``time.thread_time``, ``kta_stage_cpu_seconds_total``): for
``dispatch``, wall minus CPU minus the dispatch throttle's wait is the
time the thread waited for something other than the device (the GIL,
the scheduler).

With a span tracer attached (``--trace-json``, obs/trace.py) every stage
window is also mirrored into the Chrome trace with the *same* measured
duration, stamped from the tracer's clock, so the host trace's per-stage
totals agree with ``--stats`` exactly.  With ``--profile-dir`` as well,
`maybe_torch_trace` merges the host spans into the profiler's trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Iterator, Optional

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace

#: Canonical drive-loop stage order: pipeline position, not insertion
#: order (insertion order varies with which stage fires first — e.g. a
#: resumed scan snapshots before its first dispatch).  THE one list —
#: the --stats stage digest (results.StageDigest), the flight recorder's
#: stage tracks (obs/flight.py), and the scan doctor's occupancy model
#: (obs/doctor.py) all import it, so adding a stage here propagates to
#: every surface instead of silently dropping out of one.
STAGE_ORDER = ("ingest", "dispatch", "snapshot", "finalize")


class ScanProfile:
    """Books every drive-loop stage window into the live ``kta_stage_*``
    counters, mirrored into the span tracer when one is attached."""

    def __init__(self, tracer=None) -> None:
        #: Optional obs.trace.SpanTracer — stage windows mirror into it.
        self.tracer = tracer

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, nbytes: int = 0) -> Iterator[None]:
        # One measurement for the span and the counters, booked into the
        # live stage counters at every window exit (not once at scan end):
        # the flight recorder samples these mid-scan for per-stage
        # occupancy, and the --stats stage digest renders from the
        # registry snapshot — one measurement, every surface (DESIGN.md
        # §17).  The trace and --stats can never drift apart.
        with obs_trace.timed(
            name, obs_metrics.STAGE_SECONDS.labels(stage=name), cat="stage",
            tracer=self.tracer,
        ):
            c0 = time.thread_time()
            try:
                yield
            finally:
                obs_metrics.STAGE_CPU_SECONDS.labels(stage=name).inc(
                    time.thread_time() - c0
                )
                if items:
                    obs_metrics.STAGE_RECORDS.labels(stage=name).inc(items)
                if nbytes:
                    obs_metrics.STAGE_BYTES.labels(stage=name).inc(nbytes)


#: File name of the Chrome trace `maybe_torch_trace` writes.
TRACE_FILE = "torch_trace.json"
#: Chrome-trace categories of device activity in a ``torch.profiler`` trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: The ``record_function`` marker that places the span tracer's clock on
#: the profiler's time base.
CLOCK_MARKER = "kta.clock"


@contextlib.contextmanager
def maybe_torch_trace(
    profile_dir: "Optional[str]", device=None
) -> Iterator[None]:
    """Profile the enclosed scan with ``torch.profiler`` and write its
    Chrome trace to ``profile_dir/TRACE_FILE`` (the port's counterpart of
    the reference's ``maybe_jax_trace``).  CPU activity always; CUDA
    activity too when ``device`` is a CUDA device.  When the profiler
    recorded no device activity for a CUDA device (CUPTI could not trace
    on this machine), the trace is still written and one stderr line says
    so: the scan does not fail, and nothing is hidden.

    With a span tracer active (``--trace-json``) its host spans are merged
    into the written trace on the profiler's time base (`merge_host_spans`),
    each host thread on a track of its own."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    tracer = obs_trace.active()
    with profile(activities=activities) as prof:
        mark = clock_mark(tracer) if tracer is not None else None
        yield
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if mark is not None:
        merge_host_spans(path, tracer, mark)
    if cuda and not device_events(path):
        sys.stderr.write(
            f"profile: {path} holds no CUDA activity (the profiler could "
            "not trace the device here); CPU activity only\n"
        )


def clock_mark(tracer) -> float:
    """Record the `CLOCK_MARKER` in the running profiler and return the
    tracer's reading at its middle (the mean of a reading before and one
    after)."""
    import torch

    before = tracer.now()
    with torch.profiler.record_function(CLOCK_MARKER):
        pass
    return (before + tracer.now()) / 2


def merge_host_spans(trace_path: str, tracer, mark: float) -> None:
    """Append ``tracer``'s events to the profiler's Chrome trace at
    ``trace_path``, shifted so that ``mark`` (a reading of its clock, from
    `clock_mark`) falls at the middle of the trace's `CLOCK_MARKER`.  Each
    host thread gets a track of its own, named ``host spans: <thread>``."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e for e in events if e.get("name") == CLOCK_MARKER and e.get("ph") == "X"]
    if not marks:
        sys.stderr.write(
            f"profile: {trace_path} lacks the clock marker; host spans not merged\n"
        )
        return
    marker = marks[0]
    shift_us = marker["ts"] + marker.get("dur", 0) / 2 - tracer.ts_us(mark)
    events.extend(dict(ev, ts=ev["ts"] + shift_us) for ev in tracer.events())
    events.extend(
        {"name": "thread_name", "ph": "M", "pid": os.getpid(), "tid": tid,
         "args": {"name": f"host spans: {name}"}}
        for tid, name in sorted(tracer.threads.items())
    )
    with open(trace_path, "w") as f:
        json.dump(doc, f)


def device_events(trace_path: str) -> "list[dict]":
    """The device events (kernels, copies, memsets) of a Chrome trace
    that `maybe_torch_trace` wrote."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [
        e for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
    ]
