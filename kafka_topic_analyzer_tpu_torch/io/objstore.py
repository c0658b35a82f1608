"""Object-store transport for the remote segment tier (DESIGN.md §21;
port of the reference's ``io/objstore.py``).

The cold scan path's storage seam (io/segstore.py) needs exactly three
operations against a remote store: LIST a topic's chunk objects, fetch a
byte RANGE of one (the catalog's header probe), and fetch a whole chunk
body.  This module is the S3-shaped HTTP client behind
``ObjectSegmentStore`` plus the local segment cache:

- `RetryingHttp` — THE retry-budget wrapper.  Every socket the remote tier
  touches lives inside this class: one method pair
  does the raw request, one public ``get`` drives it through the wire
  scan's recovery substrate — capped-exponential `io/retry.Backoff` between
  attempts (sleeps booked, never bare ``time.sleep``) and a
  `PartitionRetryBudget` so a partition whose chunks stay unreachable is
  DEGRADED (scan continues without it, reported) instead of retried
  forever.  Transient failures are resets/timeouts/truncated bodies/5xx;
  a 200-body whose MD5 disagrees with the response ETag is presumed
  *in-flight* damage and re-fetched — but a second fetch returning
  byte-identical data proves the mismatch persistent (SSE-KMS/SSE-C
  ETags are 32-hex yet not the content MD5; responses declaring such
  encryption skip the check up front) and the body is accepted, booked,
  and left to the downstream structural/sha256 validation.  4xx are
  deterministic and never retried; so is a server that ignores Range
  headers (the requested window is sliced out of its 200 response).
  LIST pagination follows NextContinuationToken until IsTruncated
  clears, so catalogs beyond one 1000-key page enumerate completely.
- `SegmentCache` — the content-verified local chunk cache
  (``--segment-cache DIR``): entries are keyed by the address digest
  (store + object name + size), written tmp-file → atomic rename, carry a
  sha256 sidecar recorded at fetch time, and are VERIFIED on first touch
  each process lifetime — a flipped byte in a cached entry is detected,
  booked (``kta_segstore_fallback_total{reason="cache-poisoned"}``),
  evicted, and re-fetched; it is never silently served.  Once an entry
  verifies, its digest LATCHES as trusted and later hits skip the
  re-hash (``kta_segstore_cache_verify_latched_total``) — the
  verify-amortization that keeps a warm re-audit from re-hashing
  every chunk.  Eviction, re-population, and poison detection drop the
  latch, so any NEW on-disk bytes re-verify at their first touch.  Hits
  are served as read-only ``np.memmap`` views (zero-copy into
  ``pack_batch(out=)``/the fused native pass — POSIX keeps the mapping
  valid across a concurrent eviction's unlink).  The cache is a
  size-bounded LRU (hits refresh mtime; inserts evict oldest-first past
  ``max_bytes``).

Wire shape (path-style S3): ``GET {base}/?list-type=2&prefix=P`` returns
a ListBucketResult XML of Key/Size/ETag rows; ``GET {base}/{key}`` with an
optional ``Range: bytes=a-b`` header returns 200/206.  Any S3-compatible
endpoint serves this; ``tools/objstore_serve.py`` is the local
implementation the tests and benchmarks run against.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import json
import os
import re
import threading

import numpy as np
from time import perf_counter as _perf_counter
from typing import Callable, Dict, List, Optional, Tuple
from xml.etree import ElementTree

from kafka_topic_analyzer_tpu_torch.config import SegmentFetchConfig
from kafka_topic_analyzer_tpu_torch.io.retry import Backoff, PartitionRetryBudget
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics


class ObjectStoreError(IOError):
    """A remote-store operation that failed deterministically (bad spec,
    missing object, exhausted retry budget).  ``IOError`` so the CLI's
    environment-failure path reports one clean line, not a traceback."""


class SegmentFetchUnavailable(ObjectStoreError):
    """A chunk fetch that exhausted its transport retry budget.  Carries
    the partition so the segment source can mark exactly it degraded
    (the graceful-degradation contract) and keep scanning the rest."""

    def __init__(self, message: str, partition: "Optional[int]" = None):
        super().__init__(message)
        self.partition = partition


class _Transient(Exception):
    """Internal marker for a retryable failure (5xx, truncated body,
    ETag/MD5 disagreement): never escapes ``RetryingHttp.get``."""


def parse_object_store_spec(spec: str) -> "Tuple[bool, str, int, str]":
    """``(tls, host, port, base_path)`` for a remote store spec.

    ``http(s)://host[:port]/base`` addresses any S3-compatible endpoint
    path-style; ``s3://bucket[/prefix]`` is sugar for path-style access
    through the endpoint in ``KTA_S3_ENDPOINT`` (default
    ``https://s3.amazonaws.com`` — unauthenticated GETs, i.e. public or
    proxy-fronted buckets; signed access belongs to a fronting proxy)."""
    m = re.match(r"^(https?)://([^/:]+)(?::(\d+))?(/.*)?$", spec)
    if m:
        tls = m.group(1) == "https"
        host = m.group(2)
        port = int(m.group(3)) if m.group(3) else (443 if tls else 80)
        base = (m.group(4) or "").rstrip("/")
        return tls, host, port, base
    m = re.match(r"^s3://([^/]+)(/.*)?$", spec)
    if m:
        endpoint = os.environ.get("KTA_S3_ENDPOINT", "https://s3.amazonaws.com")
        tls, host, port, base = parse_object_store_spec(endpoint)
        return tls, host, port, f"{base}/{m.group(1)}{(m.group(2) or '').rstrip('/')}"
    raise ValueError(
        f"bad object store spec {spec!r}: expected http(s)://host[:port]/bucket"
        "[/prefix] or s3://bucket[/prefix]"
    )


class RetryingHttp:
    """The one place remote-tier bytes cross a socket (lint rule 11).

    Connections are per-thread (the read-ahead pool fetches concurrently)
    and evicted on any failure so a retry reconnects fresh.  ``get`` is
    the public surface: every attempt is paced by the shared `Backoff`
    schedule, every retry booked on ``kta_segstore_retries_total``, and
    per-partition failure streaks run through the `PartitionRetryBudget`
    so the degraded transition matches the live wire scan's semantics.
    """

    def __init__(self, spec: str, fetch: SegmentFetchConfig):
        self.spec = spec
        self.tls, self.host, self.port, self.base = parse_object_store_spec(spec)
        # Path-style S3 splits the base into BUCKET (the LIST endpoint —
        # /bucket/?list-type=2) and KEY PREFIX (folded into the prefix=
        # parameter and every object key): a /bucket/some/prefix spec
        # must never issue GET /bucket/some/prefix/?list-type=2, which
        # is an object GET, not a bucket LIST.
        parts = [p for p in self.base.split("/") if p]
        if not parts:
            # A bucketless spec would LIST against `GET /?list-type=2`
            # and GET `/name` — the user would see a confusing downstream
            # 404/XML error instead of a spec rejection.  (Validated here,
            # not in parse_object_store_spec: the s3:// branch parses a
            # bare KTA_S3_ENDPOINT with an empty base legitimately.)
            raise ValueError(
                f"bad object store spec {spec!r}: no bucket in path — "
                "expected http(s)://host[:port]/bucket[/prefix]"
            )
        self.bucket_path = f"/{parts[0]}"
        self.key_prefix = "/".join(parts[1:])
        if self.key_prefix:
            self.key_prefix += "/"
        self.timeout_s = fetch.timeout_s
        self.backoff = Backoff(fetch.retry)
        self.budget = PartitionRetryBudget(fetch.retry.retry_budget)
        #: Latched once ONE object proves (via a byte-identical re-fetch)
        #: that this store's ETags are not content MD5s: SSE and ETag
        #: policy are bucket-level, so re-learning it per chunk would
        #: download an archived year twice and sleep a backoff per chunk.
        self.etag_not_md5 = False
        #: Latched once ONE ranged GET comes back as a 200 full object:
        #: Range support is server-level, so once known the catalog
        #: fetches each chunk whole ONCE and slices its probes locally
        #: instead of downloading the full object per probe.
        self.range_ignored = False
        self._lock = threading.Lock()
        self._local = threading.local()

    def url_of(self, path: str) -> str:
        """Absolute URL of a request path, for error messages/logs."""
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}{path}"

    # -- raw request (the only socket touch) ---------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (
                http.client.HTTPSConnection if self.tls
                else http.client.HTTPConnection
            )
            conn = cls(self.host, self.port, timeout=self.timeout_s)
            self._local.conn = conn
        return conn

    def _evict_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None

    def _one_request(
        self,
        path: str,
        rng: "Optional[Tuple[int, int]]",
        method: str = "GET",
        body: "Optional[bytes]" = None,
        extra_headers: "Optional[Dict[str, str]]" = None,
    ) -> "Tuple[int, bytes, Dict[str, str]]":
        """One request on this thread's connection: (status, body, headers).
        Raises OSError/http.client exceptions on transport failure.  This
        is the ONLY place that touches the socket (lint rule 11) — the
        lease layer's conditional PUTs ride the same connection pool,
        eviction, and timeout discipline as segment GETs."""
        headers: "Dict[str, str]" = {}
        if rng is not None:
            lo, hi = rng
            headers["Range"] = (
                f"bytes=-{hi}" if lo is None else f"bytes={lo}-{hi}"
            )
        if extra_headers:
            headers.update(extra_headers)
        conn = self._connection()
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        resp_body = resp.read()
        return (
            resp.status,
            resp_body,
            {k.lower(): v for k, v in resp.getheaders()},
        )

    # -- the retry-budget wrapper --------------------------------------------

    def get(
        self,
        path: str,
        rng: "Optional[Tuple[Optional[int], int]]" = None,
        kind: str = "body",
        partition: "Optional[int]" = None,
        expect: "Optional[int]" = None,
    ) -> bytes:
        """GET with retry/budget/integrity.  ``rng`` is an inclusive byte
        range ((None, n) = suffix range, S3 semantics); ``expect`` the
        exact body length required (a short read is a transient truncated
        stream, like the wire client's).  ``partition`` routes failure
        streaks through the shared budget: exhaustion raises
        `SegmentFetchUnavailable` (the caller degrades the partition);
        catalog-time operations with no partition fail after the same
        number of attempts."""
        if partition is not None and partition in self.budget.degraded:
            raise SegmentFetchUnavailable(
                f"{self.url_of(path)}: partition {partition} "
                f"already degraded ({self.budget.degraded[partition]})",
                partition=partition,
            )
        attempt = 0
        #: MD5 of the last body whose ETag disagreed: a SECOND fetch
        #: returning the identical bytes proves the damage is not
        #: in-flight — the ETag simply is not the content MD5 (SSE-KMS /
        #: SSE-C / composite ETags), and retrying further would burn the
        #: whole budget against a healthy encrypted archive.
        mismatched_md5: "Optional[str]" = None
        while True:
            try:
                try:
                    status, body, headers = self._one_request(path, rng)
                except (OSError, http.client.HTTPException) as e:
                    self._evict_connection()
                    raise _Transient(
                        f"{type(e).__name__}: {e}"
                    ) from e
                if status in (500, 502, 503, 504):
                    raise _Transient(f"HTTP {status}")
                if status not in (200, 206):
                    raise ObjectStoreError(
                        f"object store GET {self.url_of(path)} failed: "
                        f"HTTP {status}"
                    )
                #: What actually crossed the wire — the egress metric
                #: books this even when a range-ignored full body is
                #: sliced down to a 32-byte window below.
                transferred = len(body)
                if (
                    status == 200
                    and rng is not None
                    and (expect is None or len(body) != expect)
                ):
                    # The endpoint ignored the Range header and replied 200
                    # with the FULL object.  That is deterministic server
                    # behavior, not in-flight damage: slice the requested
                    # window out (booked — every header probe against such
                    # a server pays a whole-body download) instead of
                    # burning the retry budget on 'truncated body'.  But a
                    # 200 body CUT SHORT of its own Content-Length is
                    # in-flight truncation, not range-ignoring — still
                    # transient.
                    try:
                        declared = int(headers.get("content-length", ""))
                    except ValueError:
                        declared = None
                    if declared is not None and len(body) < declared:
                        self._evict_connection()
                        raise _Transient(
                            f"truncated body ({len(body)} of "
                            f"{declared} bytes)"
                        )
                    lo, hi = rng
                    sliced = (
                        (body[-hi:] if hi else b"") if lo is None
                        else body[lo : hi + 1]
                    )
                    if expect is not None and len(sliced) != expect:
                        if declared is None:
                            # Close-delimited response (no Content-Length)
                            # cut short: indistinguishable from in-flight
                            # truncation — retry under the budget rather
                            # than abort the scan on one network blip.
                            self._evict_connection()
                            raise _Transient(
                                f"short 200 body for ranged GET "
                                f"({len(body)} bytes, no Content-Length)"
                            )
                        raise ObjectStoreError(
                            f"object store GET {self.url_of(path)} ignored "
                            f"Range: bytes={'' if lo is None else lo}-{hi} "
                            f"and its {len(body)}-byte 200 response cannot "
                            f"satisfy it — server does not support ranged "
                            "GETs"
                        )
                    body = sliced
                    self.range_ignored = True
                    _book_fallback("range-ignored")
                elif expect is not None and len(body) != expect:
                    self._evict_connection()
                    raise _Transient(
                        f"truncated body ({len(body)} of {expect} bytes)"
                    )
                if status == 200 and rng is None:
                    # Whole-object GET: S3 ETags for SIMPLE objects are the
                    # body MD5, so a first mismatch is presumed damage in
                    # flight and re-fetched.  But 32-hex ETags that are NOT
                    # the content MD5 exist (SSE-KMS / SSE-C encrypt the
                    # stored bytes), so the check is skipped when the
                    # response declares such encryption — and a SECOND
                    # fetch returning byte-identical data proves the
                    # mismatch is persistent, not in-flight: accept the
                    # body (booked) and let the structural / sha256
                    # validation downstream judge it, rather than degrading
                    # every partition of a healthy encrypted archive.
                    etag = headers.get("etag", "").strip('"')
                    sse = headers.get(
                        "x-amz-server-side-encryption", ""
                    ).lower()
                    etag_is_md5 = (
                        not self.etag_not_md5
                        and re.fullmatch(r"[0-9a-f]{32}", etag) is not None
                        and "kms" not in sse
                        and "x-amz-server-side-encryption-customer-algorithm"
                        not in headers
                    )
                    if etag_is_md5:
                        md5 = hashlib.md5(body).hexdigest()
                        if md5 == etag:
                            pass
                        elif md5 == mismatched_md5:
                            self.etag_not_md5 = True
                            _book_fallback("etag-not-md5")
                            obs_events.emit(
                                "segstore_etag_not_md5",
                                url=self.url_of(path),
                                etag=etag,
                            )
                        else:
                            mismatched_md5 = md5
                            raise _Transient("body MD5 does not match ETag")
                obs_metrics.SEGSTORE_GETS.labels(kind=kind).inc()
                obs_metrics.SEGSTORE_BYTES.inc(transferred)
                if partition is not None:
                    with self._lock:
                        self.budget.record_success(partition)
                return body
            except _Transient as e:
                attempt += 1
                obs_metrics.SEGSTORE_RETRIES.inc()
                if partition is not None:
                    with self._lock:
                        self.budget.record_failure(partition, str(e))
                        exhausted = partition in self.budget.degraded
                    if exhausted:
                        raise SegmentFetchUnavailable(
                            f"{self.url_of(path)}: "
                            f"{self.budget.degraded[partition]}",
                            partition=partition,
                        ) from e
                elif attempt >= self.budget.budget:
                    raise ObjectStoreError(
                        f"object store GET {self.url_of(path)} failed "
                        f"after {attempt} attempts (last: {e})"
                    ) from e
                self.backoff.sleep_for(attempt)

    def list_objects(self, prefix: str) -> "List[Tuple[str, int]]":
        """LIST (name, size) under ``prefix`` — ListObjectsV2-shaped:
        ``{bucket}/?list-type=2&prefix={key_prefix}{prefix}`` returning
        ListBucketResult XML, PAGINATED: S3 caps a LIST page at 1000 keys
        and an archived year is tens of thousands of chunks, so this
        follows NextContinuationToken until IsTruncated clears — a
        truncated page that carries no token is a protocol violation and
        fails loudly (a silently short catalog would scan incomplete data
        'successfully').  Every page rides the same retry-budget ``get``.
        Keys come back as full bucket keys; the basename is the
        store-relative name, so flat and prefixed layouts enumerate
        identically."""
        from urllib.parse import quote

        out: "List[Tuple[str, int]]" = []
        token: "Optional[str]" = None
        while True:
            path = (
                f"{self.bucket_path}/?list-type=2"
                f"&prefix={quote(self.key_prefix + prefix)}"
            )
            if token:
                path += f"&continuation-token={quote(token)}"
            body = self.get(path, kind="list")
            try:
                root = ElementTree.parse(io.BytesIO(body)).getroot()
            except ElementTree.ParseError as e:
                raise ObjectStoreError(
                    f"object store LIST {self.spec} returned unparseable "
                    f"XML: {e}"
                ) from e
            # S3 proper namespaces the document; local servers may not.
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for c in root.iter(f"{ns}Contents"):
                key = c.findtext(f"{ns}Key") or ""
                size = int(c.findtext(f"{ns}Size") or 0)
                out.append((key.rsplit("/", 1)[-1], size))
            truncated = (
                (root.findtext(f"{ns}IsTruncated") or "").strip().lower()
                == "true"
            )
            if not truncated:
                return out
            next_token = root.findtext(f"{ns}NextContinuationToken")
            if not next_token:
                raise ObjectStoreError(
                    f"object store LIST {self.spec} returned a truncated "
                    "page without a NextContinuationToken — cannot "
                    "enumerate the full catalog"
                )
            if next_token == token:
                # A server that echoes the same token forever would loop
                # this walk unboundedly while duplicating keys.
                raise ObjectStoreError(
                    f"object store LIST {self.spec} repeated continuation "
                    f"token {next_token!r} — no pagination progress"
                )
            token = next_token

    # -- small-object + conditional-write surface (the lease transport) -------

    def get_small(
        self, path: str
    ) -> "Optional[Tuple[bytes, str]]":
        """GET a small control object whole: (body, etag), or None on 404.

        Unlike ``get`` this treats 404 as an ANSWER, not an error — an
        absent lease record means "nobody has ever owned this topic",
        which the lease layer must distinguish from a store outage.  No
        MD5-vs-ETag integrity pass either: the ETag here is an opaque
        fencing token for If-Match (fleet/lease.py, DESIGN §23), not a
        content checksum to verify.  Transient failures retry on the
        shared backoff; exhaustion raises ObjectStoreError (the caller
        degrades, it does not guess)."""
        attempt = 0
        while True:
            try:
                try:
                    status, body, headers = self._one_request(path, None)
                except (OSError, http.client.HTTPException) as e:
                    self._evict_connection()
                    raise _Transient(f"{type(e).__name__}: {e}") from e
                if status in (500, 502, 503, 504):
                    raise _Transient(f"HTTP {status}")
                if status == 404:
                    return None
                if status != 200:
                    raise ObjectStoreError(
                        f"object store GET {self.url_of(path)} failed: "
                        f"HTTP {status}"
                    )
                obs_metrics.SEGSTORE_GETS.labels(kind="lease").inc()
                obs_metrics.SEGSTORE_BYTES.inc(len(body))
                return body, headers.get("etag", "").strip('"')
            except _Transient as e:
                attempt += 1
                obs_metrics.SEGSTORE_RETRIES.inc()
                if attempt >= self.budget.budget:
                    raise ObjectStoreError(
                        f"object store GET {self.url_of(path)} failed "
                        f"after {attempt} attempts (last: {e})"
                    ) from e
                self.backoff.sleep_for(attempt)

    def put_conditional(
        self,
        path: str,
        body: bytes,
        if_match: "Optional[str]" = None,
        if_none_match: bool = False,
    ) -> "Optional[str]":
        """Conditional PUT: the fencing primitive (DESIGN §23).

        ``if_match`` sends ``If-Match: "<etag>"`` (replace exactly the
        version we read); ``if_none_match`` sends ``If-None-Match: *``
        (create only if absent).  Returns the NEW etag on success, or
        None on HTTP 412 — a lost compare-and-swap race, which is a
        deterministic answer and is never retried here.  Transport
        failures retry on the shared backoff, which makes a PUT
        AMBIGUOUS: the first attempt may have been applied before the
        connection died, so the retry can 412 against our own write.
        The caller (ObjectLeaseStore) resolves that by reading the
        record back and comparing owner/epoch — this layer stays a dumb
        transport and reports exactly what the server said."""
        if (if_match is None) == (not if_none_match):
            raise ValueError(
                "put_conditional requires exactly one of if_match / "
                "if_none_match — an unconditional lease write would be "
                "a fencing hole"
            )
        hdrs = {"Content-Length": str(len(body))}
        if if_match is not None:
            hdrs["If-Match"] = f'"{if_match}"'
        else:
            hdrs["If-None-Match"] = "*"
        attempt = 0
        while True:
            try:
                try:
                    status, resp_body, headers = self._one_request(
                        path, None, method="PUT", body=body,
                        extra_headers=hdrs,
                    )
                except (OSError, http.client.HTTPException) as e:
                    self._evict_connection()
                    raise _Transient(f"{type(e).__name__}: {e}") from e
                if status in (500, 502, 503, 504):
                    raise _Transient(f"HTTP {status}")
                if status == 412:
                    return None
                if status not in (200, 201, 204):
                    raise ObjectStoreError(
                        f"object store PUT {self.url_of(path)} failed: "
                        f"HTTP {status}"
                    )
                return headers.get("etag", "").strip('"')
            except _Transient as e:
                attempt += 1
                obs_metrics.SEGSTORE_RETRIES.inc()
                if attempt >= self.budget.budget:
                    raise ObjectStoreError(
                        f"object store PUT {self.url_of(path)} failed "
                        f"after {attempt} attempts (last: {e})"
                    ) from e
                self.backoff.sleep_for(attempt)

    def object_path(self, name: str) -> str:
        from urllib.parse import quote

        return f"{self.bucket_path}/{quote(self.key_prefix + name)}"


def _book_fallback(reason: str) -> None:
    """Every fallback-to-direct-fetch path books its reason — a cache
    bypass is never silent (lint rule 11; same discipline as the fused
    and compaction fallbacks)."""
    obs_metrics.SEGSTORE_FALLBACK.labels(reason=reason).inc()


#: The process-lifetime trust latch: address digests whose on-disk bytes
#: SOME SegmentCache instance in this process already sha256-verified.
#: Deliberately shared across instances — every scan builds its own
#: source/store/cache object over the same directory, and "verify once
#: per process" must survive that churn.  Digests bind store spec + name
#: + size, so two stores can never alias each other's trust.  Set
#: membership/add/discard are GIL-atomic; mutation happens only through
#: the SegmentCache choke points below.
_PROCESS_TRUSTED: "set" = set()


class SegmentCache:
    """Content-verified local chunk cache with LRU size bounding.

    Entry layout: ``DIR/{digest}.seg`` (the raw chunk bytes) +
    ``DIR/{digest}.json`` sidecar ``{name, size, sha256}``, where digest =
    sha256 of the store spec + object name + size — two stores (or a
    re-dumped object of a different size) can never collide.  Writes land
    tmp-file → ``os.replace`` so a crashed writer leaves no partial entry;
    the sidecar lands LAST, so an entry is visible only once both halves
    are durable.  The FIRST hit of an entry each process lifetime
    re-hashes its bytes against the sidecar's sha256 and latches the
    digest as trusted; later hits skip the hash (amortized verify) —
    the cache serves exactly what was fetched and verified, or nothing.
    """

    def __init__(self, directory: str, max_bytes: int, store_key: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_bytes = max_bytes
        self.store_key = store_key
        self._lock = threading.Lock()
        #: The process-wide trust latch (see _PROCESS_TRUSTED) — bound
        #: here so access stays confined to the
        #: _latch_trusted/_unlatch_trusted/_is_trusted choke points
        #: and every trust transition books.
        self._trusted: "set" = _PROCESS_TRUSTED
        #: Running resident-bytes estimate so inserts are O(1): the full
        #: directory sweep (and the estimate's re-sync) only runs when
        #: this crosses the bound — a year-scale fill must not stat the
        #: whole cache on every insert.
        self._total = sum(
            st.st_size
            for st in (
                self._stat(os.path.join(directory, f))
                for f in os.listdir(directory)
                if f.endswith(".seg")
            )
            if st is not None
        )

    @staticmethod
    def _stat(path: str):
        try:
            return os.stat(path)
        except OSError:
            return None

    def _digest(self, name: str, size: int) -> str:
        return hashlib.sha256(
            f"{self.store_key}\n{name}\n{size}".encode()
        ).hexdigest()

    def _paths(self, digest: str) -> "Tuple[str, str]":
        return (
            os.path.join(self.directory, f"{digest}.seg"),
            os.path.join(self.directory, f"{digest}.json"),
        )

    # -- the trust-latch choke points (the ONLY
    # code allowed to touch self._trusted, so every trust transition is
    # auditable and booked) ---------------------------------------------------

    def _is_trusted(self, digest: str) -> bool:
        """Hit-side choke point: True when this process already verified
        the entry's bytes, booking the amortized hit
        (``kta_segstore_cache_verify_latched_total``)."""
        if digest in self._trusted:
            obs_metrics.SEGSTORE_CACHE_VERIFY_LATCHED.inc()
            return True
        return False

    def _latch_trusted(self, digest: str) -> None:
        """Latch an entry whose sha256 JUST verified: later hits this
        process lifetime skip the re-hash."""
        self._trusted.add(digest)

    def _unlatch_trusted(self, digest: str, reason: str) -> None:
        """Drop the trust latch — the on-disk bytes are gone or about to
        change, so the next hit must re-verify (first-touch verification
        is what keeps the never-serve-poison guarantee).  Dropping a
        LATCHED digest is rare enough to narrate."""
        if digest in self._trusted:
            self._trusted.discard(digest)
            obs_events.emit(
                "segment_cache_unlatched", digest=digest, reason=reason
            )

    def get(self, name: str, size: int) -> "Optional[np.ndarray]":
        """Verified chunk bytes for (name, size) as a read-only memmap
        view (zero-copy into the column slicer / fused native pass), or
        None (miss / poisoned — a poisoned entry is evicted and booked,
        the caller re-fetches).

        LOCK-FREE on the read+hash path: entries are immutable once
        renamed in (os.replace is atomic, the sidecar lands last), and a
        concurrent eviction's unlink leaves an already-mapped file
        readable — POSIX unlink semantics — (worst case: this read
        becomes a miss).  Holding the cache lock here would serialize
        every stream's verification hashing behind one core."""
        digest = self._digest(name, size)
        seg, meta = self._paths(digest)
        try:
            with open(meta, "rb") as f:
                sidecar = json.load(f)
            data = np.memmap(seg, dtype=np.uint8, mode="r")
        except (OSError, ValueError):
            obs_metrics.SEGSTORE_CACHE_MISSES.inc()
            return None
        if self._is_trusted(digest):
            # Verify-amortized hit: this process already hashed these
            # bytes once; serve the mapping without re-hashing (the
            # verify-seconds counter stands still, the latched counter
            # advances).
            pass
        else:
            # First touch this process lifetime: the verify residual,
            # booked.  Hashing the mapping faults its pages in — the
            # same IO a read would have paid, minus the copy.
            t0 = _perf_counter()
            content = hashlib.sha256(data).hexdigest()
            obs_metrics.SEGSTORE_CACHE_VERIFY_SECONDS.inc(
                _perf_counter() - t0
            )
            if content != sidecar.get("sha256"):
                # A flipped byte at rest in the CACHE: never serve it —
                # drop the entry, book the reason, fall back to a direct
                # fetch (the store itself is re-verified on that path).
                _book_fallback("cache-poisoned")
                obs_events.emit(
                    "segment_cache_poisoned", name=name, entry=seg
                )
                with self._lock:
                    self._remove(seg, meta)
                obs_metrics.SEGSTORE_CACHE_MISSES.inc()
                return None
            self._latch_trusted(digest)
        obs_metrics.SEGSTORE_CACHE_HITS.inc()
        obs_metrics.SEGSTORE_CACHE_HIT_BYTES.inc(len(data))
        now = None  # touch: mtime = now marks the entry recently used
        try:
            os.utime(seg, now)
        except OSError:
            pass
        return data

    def evict(self, name: str, size: int) -> None:
        """Drop one entry (a STALE hit: its bytes match their sidecar —
        not rot — but no longer match what the store's catalog now
        declares, e.g. the archive was re-dumped at the same size).  The
        caller books the fallback reason and re-fetches."""
        digest = self._digest(name, size)
        self._unlatch_trusted(digest, "evicted-stale")
        with self._lock:
            self._remove(*self._paths(digest))
        obs_metrics.SEGSTORE_CACHE_EVICTIONS.inc()

    def put(self, name: str, size: int, data: bytes) -> None:
        """Insert one verified chunk.  The write itself runs UNLOCKED —
        tmp names are per-thread and the double rename is atomic, so
        concurrent writers of different chunks never serialize their
        hashing/IO; only the LRU sweep takes the lock."""
        digest = self._digest(name, size)
        seg, meta = self._paths(digest)
        # Re-population replaces the on-disk bytes: whatever trust the
        # old bytes earned does not transfer — the next hit re-verifies
        # the NEW bytes at first touch (catching write-path rot too).
        self._unlatch_trusted(digest, "re-populated")
        try:
            tmp = f"{seg}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
            # Re-inserting an existing digest (racing fetches of one
            # chunk, a re-put after an unreadable sidecar) REPLACES its
            # bytes: only the net growth may be added to the running
            # total, or the inflated estimate triggers premature
            # full-directory eviction sweeps.  The stat, the rename, and
            # the total update must be one atom — two racing puts of the
            # SAME digest would otherwise both stat the pre-replace state
            # and both add the full size.  (The expensive body write
            # above stays unlocked.)
            with self._lock:
                replaced = self._stat(seg)
                os.replace(tmp, seg)
                self._total += len(data) - (
                    replaced.st_size if replaced is not None else 0
                )
            mtmp = f"{meta}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(mtmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "name": name,
                        "size": size,
                        "sha256": hashlib.sha256(data).hexdigest(),
                    },
                    f,
                )
            os.replace(mtmp, meta)
        except OSError:
            # An unwritable cache must not fail the scan — the chunk
            # was already fetched and verified; book the bypass.
            _book_fallback("cache-io-error")
            return
        with self._lock:
            if self._total > self.max_bytes:
                self._evict_to_bound(keep=digest)

    def _remove(self, seg: str, meta: str) -> None:
        """Unlink one entry, keeping the resident-bytes estimate in step
        (callers hold the lock)."""
        st = self._stat(seg)
        if st is not None:
            self._total -= st.st_size
        for path in (seg, meta):
            try:
                os.remove(path)
            except OSError:
                pass

    def _evict_to_bound(self, keep: "Optional[str]" = None) -> None:
        """Drop least-recently-used entries until total bytes fit the
        bound (one full sweep, which also re-syncs the running estimate
        against reality — re-puts of an existing digest and external
        deletions drift it).  The just-inserted entry (``keep``)
        survives even when it alone exceeds the bound — a cache that
        immediately discards what it just fetched would thrash forever."""
        entries = []
        total = 0
        for fname in os.listdir(self.directory):
            if not fname.endswith(".seg"):
                continue
            st = self._stat(os.path.join(self.directory, fname))
            if st is None:
                continue
            entries.append((st.st_mtime, st.st_size, fname[: -len(".seg")]))
            total += st.st_size
        entries.sort()
        self._total = total
        for _, size, digest in entries:
            if self._total <= self.max_bytes:
                break
            if digest == keep:
                continue
            # An evicted digest may later be re-filled with fresh bytes
            # at the same path — drop its latch so that first hit
            # re-verifies.
            self._unlatch_trusted(digest, "evicted-lru")
            self._remove(*self._paths(digest))
            obs_metrics.SEGSTORE_CACHE_EVICTIONS.inc()
