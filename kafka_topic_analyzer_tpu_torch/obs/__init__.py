"""Telemetry subsystem: metrics registry, exporters, events, trace spans
(port of the reference's ``obs`` package: registry, metrics, events,
trace, flight, doctor, health, history and the HTTP exporter).

Dependency-free observability for the scan pipeline:

- ``obs.registry``  — counters / gauges / fixed-bucket histograms, with
  snapshot + merge algebra for multi-controller aggregation;
- ``obs.metrics``   — the instrument catalog every layer writes to;
- ``obs.exporters`` — Prometheus text exposition over HTTP
  (``--metrics-port``);
- ``obs.events``    — structured JSONL event log (``--events-jsonl``) and
  the rate-limited heartbeat;
- ``obs.trace``     — host-side span tracer exporting Chrome trace-event
  JSON (``--trace-json``), merged into the ``--profile-dir``
  ``torch.profiler`` trace on its time base when both are given;
- ``obs.flight``    — the pipeline flight recorder (``--flight-record``);
- ``obs.doctor``    — the scan doctor's BOTTLENECK verdict and the trend
  doctor over the telemetry history;
- ``obs.health``    — the alert-rule engine behind ``/healthz`` and the
  ``health`` block;
- ``obs.history``   — the disk-backed telemetry history
  (``--history-bytes``, ``/history``).

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
    history_dir: "Optional[str]" = None,
    history_bytes: int = 0,
    sse: bool = False,
) -> "Iterator[Optional[SpanTracer]]":
    """Wire up the flag-selected telemetry outputs around a scan.

    Yields the span tracer (None unless ``trace_json`` is set) for
    ``run_scan``'s profile to mirror stages into; it is the active one, so
    ``--profile-dir``'s `utils.profiling.maybe_torch_trace`, entered
    inside the session, merges its spans into the device trace.  On exit
    the trace file is written, the event log closed, and the scrape
    endpoint shut down — the endpoint therefore serves while the scan
    runs.

    ``flight_record`` starts the occupancy sampler (obs/flight.py) as the
    process-wide active recorder for the session: the ``/flight``
    endpoint, the Chrome counter tracks, and the ``--stats`` windowed
    verdict lines all read it.  The recorder keeps sampling until
    teardown (so readers inside the session — the report code — see a
    LIVE series and take their own closing ``sample_once()`` if they
    need the final state; obs.doctor.diagnose_scan does); teardown then stops the
    thread and clears ``active()``.

    ``history_dir``/``history_bytes`` open the disk-backed telemetry
    history (obs/history.py) next to the checkpoints and feed it from
    the recorder's tick path — the recorder is started implicitly when
    history is on, since history IS the recorder's durable sink.  The
    session also constructs the alert engine (obs/health.py, built-in
    rules) as the process-wide active one whenever any serving surface
    exists to read it (``metrics_port`` set, or history on) — the
    follow/fleet services evaluate it at their poll boundaries, the
    engine drive loop at heartbeat cadence, and ``/healthz`` serves its
    latest verdict.  Services may install their own engine instead
    (tests do); last ``set_active`` wins.

    ``sse`` starts the Server-Sent-Events publisher (serve/push.py) as
    the session's active one: every report publish is pushed to
    ``/events`` subscribers from the publisher's own fan-out thread.
    Requires ``metrics_port`` (the route needs a server to live on).

    Output paths are opened (and truncated, for the trace) at setup so a
    bad ``--trace-json``/``--events-jsonl`` path fails before the scan,
    not after it; and each teardown step is isolated, so a failing trace
    write still closes the event log and the endpoint.
    """
    import sys

    from kafka_topic_analyzer_tpu_torch.obs import events as _events
    from kafka_topic_analyzer_tpu_torch.obs import flight as _flight
    from kafka_topic_analyzer_tpu_torch.obs import health as _health
    from kafka_topic_analyzer_tpu_torch.obs import history as _history
    from kafka_topic_analyzer_tpu_torch.obs import trace as _trace

    exporter = None
    sink = None
    tracer = None
    recorder = None
    store = None
    engine = None
    pusher = None
    try:
        if events_jsonl:
            sink = _events.JsonlEventLog(events_jsonl)
            _events.add_sink(sink)
        if trace_json:
            with open(trace_json, "w", encoding="utf-8"):
                pass  # fail fast on an unwritable path; write() re-opens
            tracer = SpanTracer()
            _trace.set_active(tracer)
        if flight_record or history_dir:
            # After the tracer: the recorder mirrors its instantaneous
            # tracks onto the active tracer as Chrome counter events.
            # History implies the recorder — it is the durable sink of
            # the same tick path.
            recorder = _flight.FlightRecorder()
            if history_dir:
                store = _history.HistoryStore(
                    history_dir,
                    max_bytes=max(4096, int(history_bytes)),
                )
                recorder.attach_history(store)
                _history.set_active(store)
            _flight.set_active(recorder)
            recorder.start()
        if metrics_port is not None or history_dir:
            # The alert engine costs nothing until something evaluates
            # it; it exists whenever a surface (the HTTP endpoints, the
            # --stats health digest, the JSONL event bus) can read it.
            engine = _health.HealthEngine()
            _health.set_active(engine)
        if sse and metrics_port is not None:
            from kafka_topic_analyzer_tpu_torch.serve import push as _push

            pusher = _push.SsePublisher().start()
            _push.set_active(pusher)
        # The endpoint opens last: a client that connects the moment the
        # port accepts finds every route it serves (``/events``,
        # ``/healthz``) already there.
        if metrics_port is not None:
            from kafka_topic_analyzer_tpu_torch.obs.exporters import (
                PrometheusExporter,
            )

            exporter = PrometheusExporter(metrics_port)
            if metrics_port == 0:
                # The ephemeral port is useless unless announced; stderr,
                # like the spinner, so --json stdout stays clean.
                sys.stderr.write(
                    "serving metrics on "
                    f"http://{exporter.host}:{exporter.port}/metrics\n"
                )
        yield tracer
    finally:
        if pusher is not None:
            from kafka_topic_analyzer_tpu_torch.serve import push as _push

            try:
                pusher.stop()  # closes every stream; booked "shutdown"
            finally:
                _push.set_active(None)
        if engine is not None:
            # The session is the CLI's outermost scope: whatever engine
            # is active at teardown (ours, or a service's replacement)
            # has no reader once the endpoint below closes.
            _health.set_active(None)
        if recorder is not None:
            try:
                recorder.stop()  # final sample; series stays readable
            finally:
                _flight.set_active(None)
        if store is not None:
            try:
                store.close()
            finally:
                _history.set_active(None)
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
