"""Lock-consistent report snapshots for the service HTTP surface (port of
the reference's ``serve/state.py``).

The snapshot-consistency rule (DESIGN.md §18): the follow drive loop
assembles and serializes a full report document at each poll boundary and
*publishes* it here; the ``/report.json`` handler (obs/exporters.py) only
ever *reads* the latest published bytes.  The lock below guards a single
reference swap on publish and a single reference read on serve — both
O(1) — so a scrape returns in microseconds and can never block folding,
and a publish can never block on a slow client.  Handlers must not reach
any deeper: ``report_bytes``/``snapshot``/``entry`` are the ONLY
sanctioned accessors (tools/lint.sh rule 9 rejects handler code that
calls into the drive loop or takes any other fold-state lock).

Since the read-path PR (DESIGN.md §26) a publish produces one immutable
``PublishedReport`` — ``(raw bytes, gzipped bytes, ETag, seq)`` encoded
ONCE on the publishing side — so conditional requests (`If-None-Match`)
and `Accept-Encoding: gzip` responses cost the handler O(headers): no
per-request ``json.dumps``, no per-request ``gzip.compress``, and no way
for a reader racing a publish to observe a torn triple (body, encoding,
and validator always belong to the same seq, because they live on the
same object and the swap is one reference assignment).

The monotone ``seq`` (one counter across the main slot and every fleet
topic slot) is the cache validator AND the SSE event id: each publish is
also offered to the session's SSE publisher (serve/push.py) so `/events`
subscribers learn about new snapshots without polling.

Module-level ``active()``/``set_active()`` mirror obs/flight.py: the CLI
registers the running service's state for the session so the exporter —
which predates this package and must not import it eagerly — can look it
up per request.
"""

from __future__ import annotations

import gzip as _gzip
import json
import threading
import time
from typing import Callable, Optional

from kafka_topic_analyzer_tpu_torch.config import DEFAULT_SERVE
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

#: Gzip level for publish-time encoding (config.ServeConfig): 6 is the
#: classic wire default — ~10× on report JSON, a low-single-digit-ms
#: cost paid once per poll boundary, never per request.
GZIP_LEVEL = DEFAULT_SERVE.gzip_level

#: Bodies smaller than this are not worth a gzip member's overhead; the
#: publish stores no gzip variant and every client gets identity (the
#: fallback is visible in kta_serve_bytes_total{encoding="identity"}).
MIN_GZIP_BYTES = DEFAULT_SERVE.gzip_min_bytes


class PublishedReport:
    """One published snapshot: the atomic (raw, gzipped, etag) triple.

    Immutable after construction — handlers hold a reference and can
    serve from it long after a newer seq replaced it in the slot, which
    is exactly what makes the torn-triple race impossible: there is no
    moment where the body belongs to one publish and the validator or
    encoding to another.
    """

    __slots__ = (
        "seq", "doc", "body", "gzipped", "etag", "etag_gzip",
        "published_at", "topic", "summary",
    )

    def __init__(
        self,
        seq: int,
        doc: dict,
        body: bytes,
        gzipped: "Optional[bytes]",
        published_at: float,
        topic: "Optional[str]",
        summary: dict,
    ):
        self.seq = seq
        self.doc = doc
        self.body = body
        self.gzipped = gzipped
        #: Strong validators.  The representation rule (RFC 9110 §8.8.3):
        #: the gzip representation carries its own ETag so a cache can
        #: never conflate the two encodings of one seq.
        self.etag = f'"r{seq}"'
        self.etag_gzip = f'"r{seq}+gzip"'
        self.published_at = published_at
        self.topic = topic
        #: Compact delta summary for the SSE event (serve/push.py):
        #: seq + topic + sizes + whatever the drive loop passed along
        #: (records folded, lag, pass count) — NOT the document itself.
        self.summary = summary


class ServiceState:
    """Latest published report document, pre-serialized AND pre-encoded.

    Serialization and compression happen on the PUBLISHING side (the
    drive loop, once per poll boundary) — never per scrape — so N
    dashboard scrapes cost N reference reads, not N ``json.dumps`` (or
    N ``gzip.compress``) of a large document.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        instance: "Optional[str]" = None,
        gzip_enabled: bool = True,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        #: Analyzer instance id stamped on every published document
        #: (fleet federation, DESIGN §23) — None keeps solo documents
        #: byte-identical to pre-fleet output.
        self._instance = instance
        #: Publish-time gzip toggle (``--serve-gzip off`` disables the
        #: stored variant; handlers then serve identity to everyone).
        self._gzip_enabled = bool(gzip_enabled)
        #: Monotone publish counter — ONE sequence across the main slot
        #: and every fleet topic slot, so each publish anywhere gets a
        #: process-unique strong validator and SSE event id.
        self._seq = 0
        self._entry: "Optional[PublishedReport]" = None
        #: Fleet mode: topic -> PublishedReport per-topic documents,
        #: published by the fleet service after each topic's pass and
        #: served at ``/report.json?topic=<name>``.  The main slot above
        #: is then the cluster ROLLUP.  Same locking discipline:
        #: per-topic publishes swap one dict entry; reads are one lookup.
        self._topic_entries: "dict[str, PublishedReport]" = {}

    def publish(
        self,
        doc: dict,
        topic: "Optional[str]" = None,
        summary: "Optional[dict]" = None,
    ) -> PublishedReport:
        """Swap in a new point-in-time report document (drive-loop side).
        The document is stamped (``report_ts``, ``seq``), serialized,
        and gzip-encoded here, then installed under the lock in one
        assignment.  With ``topic`` set, the document lands in that
        topic's fleet slot instead of the main (single-topic report /
        fleet rollup) slot.  ``summary`` rides the SSE event as the
        compact delta block dashboards read without fetching the body."""
        doc = dict(doc)
        doc["report_ts"] = round(self._clock(), 3)
        if self._instance is not None:
            doc["instance"] = self._instance
        with self._lock:
            self._seq += 1
            seq = self._seq
        doc["seq"] = seq
        # Encode OUTSIDE the lock: a reader's reference read never waits
        # on json/gzip of a large document — only on the swap below.
        body = json.dumps(doc).encode()
        gz: "Optional[bytes]" = None
        if self._gzip_enabled and len(body) >= MIN_GZIP_BYTES:
            # mtime=0 keeps the member deterministic: one seq, one exact
            # gzip byte string, so validators and bodies can be compared
            # across retries in tests and caches.
            gz = _gzip.compress(body, GZIP_LEVEL, mtime=0)
            if len(gz) >= len(body):
                gz = None  # incompressible: serve identity to everyone
        event = {
            "seq": seq,
            "topic": topic,
            "report_ts": doc["report_ts"],
            "bytes": len(body),
        }
        if self._instance is not None:
            event["instance"] = self._instance
        if summary:
            event.update(summary)
        entry = PublishedReport(
            seq, doc, body, gz, doc["report_ts"], topic, event
        )
        with self._lock:
            if topic is not None:
                self._topic_entries[topic] = entry
            else:
                self._entry = entry
        obs_metrics.REPORT_SNAPSHOTS.inc()
        # Poll-boundary SSE feed: hand the entry to the session's push
        # publisher (if one runs).  offer() is a bounded O(1) enqueue on
        # the publisher's intake — fan-out to subscriber queues happens
        # on the publisher's own thread, never the drive loop.
        from kafka_topic_analyzer_tpu_torch.serve import push as _push

        pub = _push.active()
        if pub is not None:
            pub.offer(entry)
        return entry

    def entry(
        self, topic: "Optional[str]" = None
    ) -> "Optional[PublishedReport]":
        """The latest published triple (HTTP-handler side), or None
        before the first publish.  One lock acquire, one reference read.
        With ``topic`` set: that topic's latest fleet entry (None for an
        unknown/not-yet-published topic)."""
        with self._lock:
            if topic is not None:
                return self._topic_entries.get(topic)
            return self._entry

    def report_bytes(self, topic: "Optional[str]" = None) -> "Optional[bytes]":
        """The latest serialized report, or None before the first
        publish (back-compat accessor; ``entry`` carries the triple)."""
        e = self.entry(topic)
        return e.body if e is not None else None

    def snapshot(self, topic: "Optional[str]" = None) -> "Optional[dict]":
        """The latest report document (test/introspection side)."""
        e = self.entry(topic)
        return e.doc if e is not None else None

    def topics(self) -> "list[str]":
        """Topic names with a published fleet document (sorted)."""
        with self._lock:
            return sorted(self._topic_entries)

    @property
    def seq(self) -> int:
        """Highest seq published so far (0 before the first publish)."""
        with self._lock:
            return self._seq

    @property
    def published_at(self) -> "Optional[float]":
        e = self.entry()
        return e.published_at if e is not None else None


_active: "Optional[ServiceState]" = None


def set_active(state: "Optional[ServiceState]") -> None:
    global _active
    _active = state


def active() -> "Optional[ServiceState]":
    return _active
