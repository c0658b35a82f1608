"""Telemetry subsystem: metrics registry, exporters, events, trace spans
(port of the reference's ``obs`` package core: registry, metrics, events,
trace, flight, doctor and the Prometheus exporter.  Left out until their
features are ported: ``obs.health``, ``obs.history``, the doctor's trend
rules and the SSE push of follow mode).

Dependency-free observability for the scan pipeline:

- ``obs.registry``  — counters / gauges / fixed-bucket histograms, with
  snapshot + merge algebra for multi-controller aggregation;
- ``obs.metrics``   — the instrument catalog every layer writes to;
- ``obs.exporters`` — Prometheus text exposition over HTTP
  (``--metrics-port``);
- ``obs.events``    — structured JSONL event log (``--events-jsonl``) and
  the rate-limited heartbeat;
- ``obs.trace``     — host-side span tracer exporting Chrome trace-event
  JSON (``--trace-json``), complementary to the ``--profile-dir``
  ``torch.profiler`` trace;
- ``obs.flight``    — the pipeline flight recorder (``--flight-record``);
- ``obs.doctor``    — the scan doctor's BOTTLENECK verdict.

``telemetry_session`` is the CLI's one-stop wiring: it attaches exactly
the sinks the flags ask for, yields the tracer for ``run_scan``, and
tears everything down (flushing the trace file) on exit.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Iterator, Optional

from kafka_topic_analyzer_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    merge_snapshots,
    render_prometheus,
)
from kafka_topic_analyzer_tpu_torch.obs.trace import SpanTracer  # noqa: F401


@contextlib.contextmanager
def telemetry_session(
    metrics_port: "Optional[int]" = None,
    events_jsonl: "Optional[str]" = None,
    trace_json: "Optional[str]" = None,
    flight_record: bool = False,
) -> "Iterator[Optional[SpanTracer]]":
    """Wire up the flag-selected telemetry outputs around a scan.

    Yields the span tracer (None unless ``trace_json`` is set) for
    ``run_scan``'s profile to mirror stages into.  On exit the trace file
    is written, the event log closed, and the scrape endpoint shut down —
    the endpoint therefore serves while the scan runs.

    ``flight_record`` starts the occupancy sampler (obs/flight.py) as the
    process-wide active recorder for the session: the ``/flight``
    endpoint, the Chrome counter tracks, and the ``--stats`` windowed
    verdict lines all read it.  The recorder keeps sampling until
    teardown (so readers inside the session — the report code — see a
    LIVE series and take their own closing ``sample_once()`` if they
    need the final state; obs.doctor.diagnose_scan does); teardown then
    stops the thread and clears ``active()``.

    Output paths are opened (and truncated, for the trace) at setup so a
    bad ``--trace-json``/``--events-jsonl`` path fails before the scan,
    not after it; and each teardown step is isolated, so a failing trace
    write still closes the event log and the endpoint.
    """
    import sys

    from kafka_topic_analyzer_tpu_torch.obs import events as _events
    from kafka_topic_analyzer_tpu_torch.obs import flight as _flight
    from kafka_topic_analyzer_tpu_torch.obs import trace as _trace

    exporter = None
    sink = None
    tracer = None
    recorder = None
    try:
        if metrics_port is not None:
            from kafka_topic_analyzer_tpu_torch.obs.exporters import (
                PrometheusExporter,
            )

            exporter = PrometheusExporter(metrics_port)
            if metrics_port == 0:
                # The ephemeral port is useless unless announced; stderr,
                # like the spinner, so stdout stays clean.
                sys.stderr.write(
                    "serving metrics on "
                    f"http://{exporter.host}:{exporter.port}/metrics\n"
                )
        if events_jsonl:
            sink = _events.JsonlEventLog(events_jsonl)
            _events.add_sink(sink)
        if trace_json:
            with open(trace_json, "w", encoding="utf-8"):
                pass  # fail fast on an unwritable path; write() re-opens
            tracer = SpanTracer()
            _trace.set_active(tracer)
        if flight_record:
            # After the tracer: the recorder mirrors its instantaneous
            # tracks onto the active tracer as Chrome counter events.
            recorder = _flight.FlightRecorder()
            _flight.set_active(recorder)
            recorder.start()
        yield tracer
    finally:
        if recorder is not None:
            try:
                recorder.stop()  # final sample; series stays readable
            finally:
                _flight.set_active(None)
        if tracer is not None:
            _trace.set_active(None)
        try:
            if tracer is not None:
                try:
                    tracer.write(trace_json)
                except OSError:
                    # Best-effort by contract: a trace-write failure (disk
                    # filled mid-scan) must not mask the scan's own
                    # exception or fail a finished scan.
                    logging.getLogger(__name__).exception(
                        "failed to write %s", trace_json
                    )
        finally:
            try:
                if sink is not None:
                    _events.remove_sink(sink)
                    sink.close()
            finally:
                if exporter is not None:
                    exporter.close()
