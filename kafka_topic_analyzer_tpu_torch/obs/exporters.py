"""The Prometheus scrape endpoint and the flight recorder's series (port
of the reference's ``obs/exporters.py``: ``/metrics`` and ``/flight``.
``/healthz``, ``/history``, ``/report.json`` with its gzip variant and the
``/events`` SSE stream come with the health, history and follow-mode
modules and are not ported yet).

A threaded stdlib HTTP/1.1 server exposing ``/metrics`` (text exposition
v0.0.4) while the scan runs — scrapes render a fresh registry snapshot
per request, so a dashboard pointed at ``--metrics-port`` watches
throughput, retries, and per-partition lag live.  Port 0 binds an
ephemeral port (``.port`` reports the bound one — tests use this).

``/flight`` carries a strong ``ETag`` minted by the recorder (its sample
count); ``If-None-Match`` answers 304 with zero body bytes.  Every
response books ``kta_serve_requests_total{route,status}`` and its body
bytes.  All error responses are JSON bodies with exact
``Content-Length`` so HTTP/1.1 keep-alive framing survives every status
code.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

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

class _MetricsHandler(BaseHTTPRequestHandler):
    #: HTTP/1.1: persistent connections by default — a 1 Hz dashboard
    #: poller reuses one socket instead of a TCP+handshake per request.
    #: Every response below therefore carries an exact Content-Length
    #: (or is a body-less 304).
    protocol_version = "HTTP/1.1"

    # -- response plumbing ----------------------------------------------------

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
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if etag is not None:
            self.send_header("ETag", etag)
        if cache is not None:
            self.send_header("Cache-Control", cache)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._book(route, code)
        obs_metrics.SERVE_BYTES.labels(encoding="identity").inc(len(body))

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
        cache: "Optional[str]" = CACHE_CONTROL,
    ) -> bool:
        """Answer 304 (zero body bytes) if the client's If-None-Match
        covers the current representation of this resource."""
        inm = self.headers.get("If-None-Match")
        if inm is None or not self._etag_match(inm, etag):
            return False
        self.send_response(304)
        self.send_header("ETag", etag)
        if cache is not None:
            self.send_header("Cache-Control", cache)
        self.send_header("Content-Length", "0")
        self.end_headers()
        self._book(route, 304)
        obs_metrics.SERVE_NOT_MODIFIED.inc()
        return True

    # -- routes ---------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        path = self.path.partition("?")[0]
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
        if path not in ("/metrics", "/"):
            self._error(
                "other", 404,
                "try /metrics or /flight",
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
