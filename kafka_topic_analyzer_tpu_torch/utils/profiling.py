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

With a span tracer attached (``--trace-json``, obs/trace.py) every stage
window is also mirrored into the Chrome trace with the *same* measured
duration, so the host trace's per-stage totals agree with ``--stats``
exactly.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Iterator, Optional

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self.tracer is not None:
                # Same t0/dt as the counters below: the trace and --stats
                # can never drift apart.
                self.tracer.add_complete(name, t0, dt, cat="stage")
            # Book the measurement into the live stage counters at every
            # window exit (not once at scan end): the flight recorder
            # samples these mid-scan for per-stage occupancy, and the
            # --stats stage digest renders from the registry snapshot —
            # one measurement, every surface (DESIGN.md §17).
            obs_metrics.STAGE_SECONDS.labels(stage=name).inc(dt)
            if items:
                obs_metrics.STAGE_RECORDS.labels(stage=name).inc(items)
            if nbytes:
                obs_metrics.STAGE_BYTES.labels(stage=name).inc(nbytes)


#: File name of the Chrome trace `maybe_torch_trace` writes.
TRACE_FILE = "torch_trace.json"
#: Chrome-trace categories of device activity in a ``torch.profiler`` trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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
    so: the scan does not fail, and nothing is hidden."""
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
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda and not device_events(path):
        sys.stderr.write(
            f"profile: {path} holds no CUDA activity (the profiler could "
            "not trace the device here); CPU activity only\n"
        )


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
