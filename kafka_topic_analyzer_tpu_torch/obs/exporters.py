"""The service HTTP read path (Prometheus scrape endpoint + dashboards;
port of the reference's ``obs/exporters.py``, every route).

A threaded stdlib HTTP/1.1 server exposing ``/metrics`` (text exposition
v0.0.4) while the scan runs — scrapes render a fresh registry snapshot
per request, so a dashboard pointed at ``--metrics-port`` watches
throughput, retries, and per-partition lag live.  Port 0 binds an
ephemeral port (``.port`` reports the bound one — tests use this).

Every snapshot route follows the read-path contract (DESIGN.md §26):

- **Conditional.**  ``/report.json``, ``/healthz``, ``/history``, and
  ``/flight`` carry a strong ``ETag`` minted by the publishing side (the
  snapshot seq, evaluation count, history epoch+append-seq, flight
  sample count); ``If-None-Match`` answers 304 with ZERO body bytes, so
  a dashboard polling at 1 Hz pays one full body per publish, not per
  request.
- **Pre-encoded.**  ``/report.json`` serves the gzip variant stored at
  publish time (serve/state.py's atomic ``(raw, gzipped, etag)`` triple)
  when ``Accept-Encoding`` allows — the handler never compresses,
  serializes, or locks anything of its own (tools/lint.sh rule 9,
  extended): per-request cost is O(headers).
- **Push.**  ``/events`` streams one Server-Sent-Events frame per report
  publish (serve/push.py): bounded per-subscriber queues, slow-client
  eviction booked on ``kta_serve_sse_dropped_total``, catch-up frame on
  (re)connect — dashboards stop polling entirely.
- **Booked.**  Every response books ``kta_serve_requests_total{route,
  status}`` and its body bytes by encoding; 304s book
  ``kta_serve_not_modified_total``.  No silent traffic.

``/healthz`` (obs/health.py) is the k8s-shaped liveness probe: 200
while no alert rule is active, 503 with the firing-rule JSON otherwise
(503 before the first evaluation; 404 without an engine).  ``/history``
(obs/history.py) serves windowed queries over the disk-backed telemetry
history while ``--history-bytes`` is active (404 otherwise) —
``?max_points=`` prices the query from the RRD tiers on the store side.
All error responses are JSON bodies with exact ``Content-Length`` so
HTTP/1.1 keep-alive framing survives every status code.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kafka_topic_analyzer_tpu_torch.config import DEFAULT_SERVE
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
    render_prometheus,
)

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Cache policy for the snapshot routes: caches may store the body but
#: must revalidate (the whole point of the strong ETags — a 1 Hz poller
#: pays 304s between publishes).
CACHE_CONTROL = "no-cache"

#: Seconds between ``: keepalive`` comment frames on an idle ``/events``
#: stream (config.ServeConfig) — keeps intermediaries from timing the
#: connection out and gives the handler a boundary to notice a closed
#: stream.
SSE_KEEPALIVE_S = DEFAULT_SERVE.sse_keepalive_s


class _MetricsHandler(BaseHTTPRequestHandler):
    #: HTTP/1.1: persistent connections by default — a 1 Hz dashboard
    #: poller reuses one socket instead of a TCP+handshake per request.
    #: Every response below therefore carries an exact Content-Length
    #: (or is a body-less 304 / Connection: close SSE stream).
    protocol_version = "HTTP/1.1"

    # -- response plumbing (headers only — rule 9: no json/gzip/locks) -------

    def _book(self, route: str, code: int) -> None:
        obs_metrics.SERVE_REQUESTS.labels(
            route=route, status=str(code)
        ).inc()

    def _send_body(
        self,
        route: str,
        body: bytes,
        content_type: str,
        code: int = 200,
        etag: "Optional[str]" = None,
        cache: "Optional[str]" = None,
        encoding: "Optional[str]" = None,
        vary: bool = False,
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if etag is not None:
            self.send_header("ETag", etag)
        if cache is not None:
            self.send_header("Cache-Control", cache)
        if encoding is not None:
            self.send_header("Content-Encoding", encoding)
        if vary:
            self.send_header("Vary", "Accept-Encoding")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._book(route, code)
        obs_metrics.SERVE_BYTES.labels(
            encoding=encoding or "identity"
        ).inc(len(body))

    def _error(self, route: str, code: int, message: str) -> None:
        """JSON error body with exact framing headers — keep-alive must
        survive 404/503/400 (the old HTML send_error dates from the
        metrics-only server)."""
        body = ('{"error": "' + message + '"}').encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._book(route, code)
        obs_metrics.SERVE_BYTES.labels(encoding="identity").inc(len(body))

    # -- conditional GET ------------------------------------------------------

    @staticmethod
    def _etag_match(if_none_match: str, *etags: "Optional[str]") -> bool:
        """RFC 9110 §13.1.2 weak comparison over a comma list; ``*``
        matches any current representation."""
        if if_none_match.strip() == "*":
            return True
        cand = set()
        for part in if_none_match.split(","):
            part = part.strip()
            cand.add(part)
            if part.startswith("W/"):
                cand.add(part[2:])
        return any(e is not None and e in cand for e in etags)

    def _not_modified(
        self,
        route: str,
        etag: str,
        *alternates: "Optional[str]",
        cache: "Optional[str]" = CACHE_CONTROL,
        vary: bool = False,
    ) -> bool:
        """Answer 304 (zero body bytes) if the client's If-None-Match
        covers any current representation of this resource.  All
        encodings of one seq carry the same content, so matching either
        variant's validator is exact, not optimistic."""
        inm = self.headers.get("If-None-Match")
        if inm is None or not self._etag_match(inm, etag, *alternates):
            return False
        self.send_response(304)
        self.send_header("ETag", etag)
        if cache is not None:
            self.send_header("Cache-Control", cache)
        if vary:
            self.send_header("Vary", "Accept-Encoding")
        self.send_header("Content-Length", "0")
        self.end_headers()
        self._book(route, 304)
        obs_metrics.SERVE_NOT_MODIFIED.inc()
        return True

    def _accepts_gzip(self) -> bool:
        ae = self.headers.get("Accept-Encoding", "")
        for part in ae.split(","):
            token, _, params = part.strip().partition(";")
            if token.strip().lower() not in ("gzip", "x-gzip", "*"):
                continue
            q = 1.0
            for p in params.split(";"):
                p = p.strip().lower()
                if p.startswith("q="):
                    try:
                        q = float(p[2:])
                    except ValueError:
                        q = 0.0
            if q > 0:
                return True
        return False

    # -- routes ---------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            # Liveness probe (obs/health.py): 200 while no alert is
            # active, 503 with the pre-serialized firing-rule JSON
            # otherwise, 503 before the first evaluation (an unevaluated
            # service must not claim liveness), 404 when no alert engine
            # runs at all.  The handler reads ONE snapshot accessor —
            # serialization + validator minting happened on the
            # evaluating side (rule 9).
            from kafka_topic_analyzer_tpu_torch.obs import health as _health

            eng = _health.active()
            if eng is None:
                self._error(
                    path, 404,
                    "no alert engine (run a scan with --metrics-port, "
                    "--follow, or --fleet)",
                )
                return
            hz = eng.healthz_entry()
            if hz is None:
                # Health-doc-shaped so pollers parsing the body see an
                # empty firing set, not a foreign error schema.
                self._send_body(
                    path,
                    b'{"error": "health not yet evaluated", "firing": []}',
                    "application/json",
                    code=503,
                )
                return
            code, body, etag = hz
            if self._not_modified(path, etag):
                return
            self._send_body(
                path, body, "application/json", code=code, etag=etag,
                cache=CACHE_CONTROL,
            )
            return
        if path == "/history":
            # Windowed telemetry-history query (obs/history.py):
            # ``?t0=&t1=`` bound the window (epoch seconds), ``tracks=``
            # selects a comma list, ``max_points=`` prices the answer
            # from the RRD tiers.  The etag/bytes accessors read the
            # store's in-memory mirror under the store's own lock —
            # never a drive-loop lock, and the handler serializes
            # nothing (rule 9).
            from urllib.parse import parse_qs

            from kafka_topic_analyzer_tpu_torch.obs import history as _history

            store = _history.active()
            if store is None:
                self._error(
                    path, 404,
                    "no telemetry history (run with --history-bytes)",
                )
                return
            qs = parse_qs(query)
            try:
                t0 = float(qs["t0"][0]) if "t0" in qs else None
                t1 = float(qs["t1"][0]) if "t1" in qs else None
            except ValueError:
                self._error(path, 400, "t0/t1 must be epoch seconds")
                return
            try:
                max_points = (
                    int(qs["max_points"][0]) if "max_points" in qs else None
                )
                if max_points is not None and max_points < 1:
                    raise ValueError
            except ValueError:
                self._error(
                    path, 400, "max_points must be a positive integer"
                )
                return
            tracks = None
            if "tracks" in qs:
                tracks = [
                    t for t in qs["tracks"][0].split(",") if t
                ]
            etag = store.window_etag(t0, t1, tracks, max_points)
            if self._not_modified(path, etag):
                return
            body, etag = store.window_bytes(t0, t1, tracks, max_points)
            self._send_body(
                path, body, "application/json", etag=etag,
                cache=CACHE_CONTROL,
            )
            return
        if path == "/report.json":
            # Follow/fleet point-in-time report (serve/state.py).  The
            # handler only ever reads the latest PRE-SERIALIZED,
            # PRE-ENCODED triple through the designated snapshot
            # accessor — body, gzip variant, and validator all belong to
            # one seq by construction, so no reader racing a publish can
            # see a torn response (tools/lint.sh rule 9; DESIGN §26).
            # ``?topic=<name>`` selects a fleet topic's document;
            # without it, the main slot (single-topic report, or the
            # fleet's cluster rollup) is served.
            from urllib.parse import parse_qs

            from kafka_topic_analyzer_tpu_torch.serve import state as _serve_state

            svc = _serve_state.active()
            if svc is None:
                self._error(
                    path, 404,
                    "no follow/fleet service (run with --follow/--fleet)",
                )
                return
            topic = (parse_qs(query).get("topic") or [None])[0]
            entry = svc.entry(topic)
            if entry is None and topic is not None:
                self._error(
                    path, 404,
                    f"no report for topic {topic!r} (unknown topic, or "
                    "its first fleet pass has not finished)",
                )
                return
            if entry is None:
                self._error(
                    path, 503,
                    "report not yet assembled (first pass running)",
                )
                return
            gz = entry.gzipped is not None and self._accepts_gzip()
            etag = entry.etag_gzip if gz else entry.etag
            if self._not_modified(
                path, etag,
                entry.etag, entry.etag_gzip, vary=True,
            ):
                return
            self._send_body(
                path,
                entry.gzipped if gz else entry.body,
                "application/json",
                etag=etag,
                cache=CACHE_CONTROL,
                encoding="gzip" if gz else None,
                vary=True,
            )
            return
        if path == "/flight":
            from kafka_topic_analyzer_tpu_torch.obs import flight as _flight

            rec = _flight.active()
            if rec is None:
                self._error(
                    path, 404,
                    "no flight recorder (run with --flight-record)",
                )
                return
            if self._not_modified(path, rec.series_etag()):
                return
            body, etag = rec.series_bytes()
            self._send_body(
                path, body, "application/json", etag=etag,
                cache=CACHE_CONTROL,
            )
            return
        if path == "/events":
            # SSE push channel (serve/push.py): one frame per report
            # publish.  The stream is close-delimited (no Content-Length
            # can exist), every frame was formatted on the publisher's
            # thread, and the handler's only state is its own bounded
            # queue — it blocks on frames, never on fold state.
            from kafka_topic_analyzer_tpu_torch.serve import push as _push

            pub = _push.active()
            if pub is None:
                self._error(
                    path, 404, "no SSE publisher (run with --sse)"
                )
                return
            sub = pub.subscribe()
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                self._book(path, 200)
                self.wfile.write(b": stream open\n\n")
                self.wfile.flush()
                while True:
                    try:
                        frame = sub.next_frame(timeout=SSE_KEEPALIVE_S)
                    except _queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    if frame is None:
                        break  # evicted or publisher shutdown
                    self.wfile.write(frame)
                    self.wfile.flush()
                    obs_metrics.SERVE_BYTES.labels(encoding="sse").inc(
                        len(frame)
                    )
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away; unsubscribe below books nothing
            finally:
                pub.unsubscribe(sub)
            return
        if path not in ("/metrics", "/"):
            self._error(
                "other", 404,
                "try /metrics, /flight, /history, /healthz, "
                "/report.json, or /events",
            )
            return
        body = render_prometheus(self.server.registry.snapshot()).encode()
        self._send_body("/metrics", body, CONTENT_TYPE)

    def log_message(self, format: str, *args) -> None:
        log.debug("metrics scrape: " + format, *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    registry: MetricsRegistry


class PrometheusExporter:
    """Serve ``registry`` on ``http://host:port/metrics`` from a daemon
    thread until ``close()``."""

    def __init__(
        self,
        port: int,
        registry: "Optional[MetricsRegistry]" = None,
        host: str = "127.0.0.1",
    ):
        self._server = _Server((host, port), _MetricsHandler)
        self._server.registry = (
            registry if registry is not None else default_registry()
        )
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="kta-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        log.info("serving Prometheus metrics on http://%s:%d/metrics",
                 host, self.port)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
