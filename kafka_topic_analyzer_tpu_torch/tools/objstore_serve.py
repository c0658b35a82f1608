"""Serve a .ktaseg directory as an S3-shaped object store (DESIGN.md §21;
port of the reference's ``tools/objstore_serve.py``).

The remote segment tier (io/objstore.py + ObjectSegmentStore) speaks a
small, honest subset of S3 path-style HTTP: ListObjectsV2
(``GET /bucket/?list-type=2&prefix=``), whole-object GET with an MD5 ETag,
and ranged GET (``Range: bytes=a-b`` / ``bytes=-n``).  This module is a
local implementation of exactly that subset, so the whole tier — catalog
header probes, read-ahead, retry/budget recovery, cache verification — is
provable (tests) and measurable (tools/bench_segments.py) without real S3:

    python -m kafka_topic_analyzer_tpu_torch.tools.objstore_serve \
        --root ./segments --port 9000 --latency-ms 25
    kafka-topic-analyzer -t orders --source segfile \
        --segment-dir http://127.0.0.1:9000/segments

``latency_ms`` injects a per-request service delay (the wire-RTT stand-in
the read-ahead pool exists to hide); ``fault_hook`` lets a harness script
failures per request — drop the connection, stall past the client timeout,
return 5xx, or corrupt response bytes in flight (see
tests/fake_objstore.py for the scripted wrapper).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple, Union
from urllib.parse import parse_qs, unquote, urlparse
from xml.sax.saxutils import escape

#: fault_hook(key, rng, index) -> one of:
#:   None                   serve normally
#:   ("status", code)       respond with that HTTP status, empty body
#:   "drop"                 close the socket without responding
#:   ("stall", seconds)     sleep that long BEFORE responding (client
#:                          timeouts see a hung server)
#:   ("flip", byte_index)   serve the body with one bit flipped there
#:   ("truncate", nbytes)   serve only the first nbytes of the body
#:                          (Content-Length still claims the full size —
#:                          a mid-GET connection drop)
FaultHook = Callable[[str, Optional[Tuple[Optional[int], int]], int], object]

#: put_fault_hook(key, body, index) -> one of:
#:   None                   apply the PUT normally
#:   ("status", code)       respond with that status; write NOT applied
#:   "drop"                 close the socket, write NOT applied (a plain
#:                          transport failure: the retry is safe)
#:   "lost"                 APPLY the write, then close the socket with
#:                          no response — the ambiguous-PUT case: the
#:                          client cannot know it succeeded, and its
#:                          conditional retry will 412 against its OWN
#:                          write (fleet/lease.py resolves by read-back)
#:   ("race", body2)        install ``body2`` under the key FIRST, then
#:                          evaluate the request's conditions against it
#:                          — a competing writer winning the CAS race
#:                          (the stale-ETag 412 path)
#:   ("skew", seconds)      apply the write with the lease JSON body's
#:                          ``expires_at`` shifted by that many seconds —
#:                          a writer whose clock disagrees with ours
PutFaultHook = Callable[[str, bytes, int], object]


class ObjectStoreHttpServer:
    """A threading HTTP server exposing ``root`` (a directory path, or a
    mutable ``{name: bytes}`` dict) as one S3-shaped bucket."""

    def __init__(
        self,
        root: "Union[str, Dict[str, bytes]]",
        bucket: str = "segments",
        latency_ms: float = 0.0,
        fault_hook: "Optional[FaultHook]" = None,
        put_fault_hook: "Optional[PutFaultHook]" = None,
        send_etag: bool = True,
        max_keys: int = 1000,
        sse: "Optional[str]" = None,
        etag_salt: bytes = b"",
        ignore_range: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.root = root
        self.bucket = bucket
        self.latency_ms = latency_ms
        self.fault_hook = fault_hook
        self.put_fault_hook = put_fault_hook
        self.send_etag = send_etag
        #: LIST page cap (S3 caps at 1000): pages beyond it return
        #: IsTruncated=true + NextContinuationToken, so clients that fail
        #: to paginate see exactly what real S3 would show them.
        self.max_keys = max_keys
        #: When set, object responses carry x-amz-server-side-encryption
        #: (e.g. "aws:kms") — real KMS-encrypted objects have 32-hex
        #: ETags that are NOT the content MD5.
        self.sse = sse
        #: Salts the ETag hash: a 32-hex ETag that never matches the body
        #: MD5 (the SSE-KMS/SSE-C shape, minus the header when sse=None).
        self.etag_salt = etag_salt
        #: Serve every ranged GET as a 200 full-object response (servers
        #: that don't implement Range exist; clients must not burn their
        #: retry budget calling the full body 'truncated').
        self.ignore_range = ignore_range
        self.requests_served = 0
        self._request_index = 0
        self._lock = threading.Lock()
        #: key -> (stat signature, md5) so ETags (whole-object by S3
        #: semantics) are computed once per object version, not per
        #: request — a 32-byte header probe must not cost a full-file
        #: read + hash, or the server's own overhead drowns the injected
        #: latency the benchmarks measure.
        self._etags: "Dict[str, Tuple[object, str]]" = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: D102 — quiet server
                pass

            def do_GET(self):  # noqa: N802 — http.server contract
                outer._handle(self)

            def do_PUT(self):  # noqa: N802 — http.server contract
                outer._handle(self)

        class Server(ThreadingHTTPServer):
            # Many concurrent clients (read-ahead pools x ingest workers)
            # connect in one burst; the http.server default backlog of 5
            # drops SYNs and the kernel's ~1s retransmit would masquerade
            # as store latency.  A real endpoint accepts deeper.
            request_queue_size = 128
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="kta-objstore-serve",
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ObjectStoreHttpServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ObjectStoreHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/{self.bucket}"

    # -- object access -------------------------------------------------------

    def _keys(self) -> "list[str]":
        if isinstance(self.root, dict):
            return sorted(self.root)
        return sorted(
            f for f in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, f))
        )

    def _size(self, key: str) -> "Optional[int]":
        if isinstance(self.root, dict):
            data = self.root.get(key)
            return None if data is None else len(data)
        path = os.path.join(self.root, key)
        try:
            return os.path.getsize(path)
        except OSError:
            return None

    def _read_range(
        self, key: str, rng: "Optional[Tuple[Optional[int], int]]"
    ) -> "Tuple[Optional[bytes], int]":
        """(bytes of the requested range — or the whole object — and the
        full object size).  File roots read ONLY the range: a ranged
        header probe costs a seek + a few bytes, not the chunk."""
        if isinstance(self.root, dict):
            data = self.root.get(key)
            if data is None:
                return None, 0
            full = len(data)
            if rng is None:
                return data, full
            lo, hi = rng
            return (data[-hi:] if hi else b"") if lo is None else (
                data[lo : hi + 1]
            ), full
        path = os.path.join(self.root, key)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                if rng is None:
                    return f.read(), size
                lo, hi = rng
                if lo is None:
                    f.seek(max(0, size - hi))
                    return (f.read() if hi else b""), size
                f.seek(lo)
                return f.read(max(0, hi - lo + 1)), size
        except OSError:
            return None, 0

    def _etag(self, key: str) -> "Optional[str]":
        """Whole-object MD5 (S3 ETag semantics).  Dict roots hash the
        bytes directly (cheap test data; caching under ``id(data)`` can
        serve a STALE ETag after CPython reuses a freed address for a
        replacement object of the same length).  File roots cache per
        object version, keyed on (size, mtime), so a 32-byte header
        probe never costs a full-file read + hash."""
        if isinstance(self.root, dict):
            data = self.root.get(key)
            if data is None:
                return None
            return hashlib.md5(data + self.etag_salt).hexdigest()
        try:
            st = os.stat(os.path.join(self.root, key))
        except OSError:
            return None
        sig = (st.st_size, st.st_mtime_ns)
        cached = self._etags.get(key)
        if cached is not None and cached[0] == sig:
            return cached[1]
        data, _ = self._read_range(key, None)
        if data is None:
            return None
        etag = hashlib.md5(data + self.etag_salt).hexdigest()
        self._etags[key] = (sig, etag)
        return etag

    # -- request handling ----------------------------------------------------

    @staticmethod
    def _parse_range(header: str) -> "Optional[Tuple[Optional[int], int]]":
        m = re.fullmatch(r"bytes=(\d*)-(\d*)", header or "")
        if not m or (not m.group(1) and not m.group(2)):
            return None
        if not m.group(1):  # suffix range: bytes=-n
            return None, int(m.group(2))
        return int(m.group(1)), int(m.group(2) or (1 << 62))

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        with self._lock:
            index = self._request_index
            self._request_index += 1
        parsed = urlparse(req.path)
        parts = [p for p in unquote(parsed.path).split("/") if p]
        if not parts or parts[0] != self.bucket:
            self._respond(req, 404, b"no such bucket")
            return
        if self.latency_ms > 0:
            time.sleep(self.latency_ms / 1000.0)
        query = parse_qs(parsed.query)
        if req.command == "PUT":
            if len(parts) < 2:
                self._respond(req, 400, b"missing key")
                return
            self._handle_put(req, "/".join(parts[1:]), index)
            return
        if len(parts) == 1 and "list-type" in query:
            self._handle_list(req, query)
            return
        if len(parts) < 2:
            self._respond(req, 400, b"missing key")
            return
        self._handle_object(req, "/".join(parts[1:]), index)

    def _handle_list(
        self, req: BaseHTTPRequestHandler, query: "Dict[str, list]"
    ) -> None:
        prefix = query.get("prefix", [""])[0]
        token = query.get("continuation-token", [""])[0]
        try:
            max_keys = int(query.get("max-keys", [str(self.max_keys)])[0])
        except ValueError:
            max_keys = -1
        if max_keys < 1:
            # 0 would paginate forever without progress (page[-1] of an
            # empty page); fail it deterministically.
            self._respond(req, 400, b"bad max-keys")
            return
        # ListObjectsV2 pagination: the continuation token is the last key
        # of the previous page (keys enumerate in lexicographic order, so
        # strictly-greater resumes exactly after it).
        matched = [
            key
            for key in self._keys()
            if key.startswith(prefix) and (not token or key > token)
        ]
        page, truncated = matched[:max_keys], len(matched) > max_keys
        rows = []
        for key in page:
            size = self._size(key)
            if size is None:
                continue
            etag = (self._etag(key) or "") if self.send_etag else ""
            rows.append(
                "<Contents>"
                f"<Key>{escape(key)}</Key><Size>{size}</Size>"
                + (f"<ETag>&quot;{etag}&quot;</ETag>" if etag else "")
                + "</Contents>"
            )
        body = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<ListBucketResult>"
            f"<Name>{escape(self.bucket)}</Name>"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            + (
                f"<NextContinuationToken>{escape(page[-1])}"
                "</NextContinuationToken>"
                if truncated
                else ""
            )
            + f"{''.join(rows)}"
            "</ListBucketResult>"
        ).encode()
        self._respond(req, 200, body, content_type="application/xml")

    def _handle_object(
        self, req: BaseHTTPRequestHandler, key: str, index: int
    ) -> None:
        rng = self._parse_range(req.headers.get("Range", ""))
        action = (
            self.fault_hook(key, rng, index)
            if self.fault_hook is not None
            else None
        )
        if isinstance(action, tuple) and action[0] == "stall":
            time.sleep(action[1])
            action = None
        if action == "drop":
            # Kill the socket without an HTTP response: the client sees a
            # reset/short read mid-GET.
            try:
                req.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            req.close_connection = True
            return
        if isinstance(action, tuple) and action[0] == "status":
            self._respond(req, int(action[1]), b"injected fault")
            return
        # ignore_range mode answers a ranged GET with the full object and
        # a 200 (the fault hook still sees the range the client asked for).
        serve_rng = None if self.ignore_range else rng
        data, _full_size = self._read_range(key, serve_rng)
        if data is None:
            self._respond(req, 404, b"no such key")
            return
        status = 200 if serve_rng is None else 206
        claimed_len = len(data)
        if isinstance(action, tuple) and action[0] == "flip":
            flipped = bytearray(data)
            flipped[action[1] % max(1, len(flipped))] ^= 0x01
            data = bytes(flipped)
        elif isinstance(action, tuple) and action[0] == "truncate":
            data = data[: action[1]]
        headers = {}
        if self.sse:
            headers["x-amz-server-side-encryption"] = self.sse
        if self.send_etag:
            # S3 semantics: the ETag always describes the WHOLE object
            # (the TRUE object — an injected in-flight flip must not
            # change it, exactly like real wire damage would not).
            etag = self._etag(key)
            if etag:
                headers["ETag"] = f'"{etag}"'
        self._respond(
            req, status, data, claimed_len=claimed_len, headers=headers
        )
        with self._lock:
            self.requests_served += 1

    # -- conditional writes (the lease transport, DESIGN.md §23) -------------

    def _write_key(self, key: str, body: bytes) -> str:
        """Install ``body`` under ``key`` and return its new ETag.  File
        roots write tmp-then-replace so a concurrent GET never reads a
        torn object (the same discipline the clients themselves use)."""
        with self._lock:
            if isinstance(self.root, dict):
                self.root[key] = body
            else:
                path = os.path.join(self.root, key)
                tmp = f"{path}.put-tmp"
                with open(tmp, "wb") as f:
                    f.write(body)
                os.replace(tmp, path)
                self._etags.pop(key, None)
        return hashlib.md5(body + self.etag_salt).hexdigest()

    @staticmethod
    def _skew_body(body: bytes, seconds: float) -> bytes:
        """Shift ``expires_at`` in a lease JSON body (the clock-skewed
        writer fault); non-lease bodies pass through untouched."""
        try:
            doc = json.loads(body.decode("utf-8"))
            doc["expires_at"] = float(doc["expires_at"]) + seconds
            return json.dumps(doc, sort_keys=True).encode("utf-8")
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return body

    def _handle_put(
        self, req: BaseHTTPRequestHandler, key: str, index: int
    ) -> None:
        try:
            length = int(req.headers.get("Content-Length", "0") or "0")
        except ValueError:
            self._respond(req, 400, b"bad content-length")
            return
        body = req.rfile.read(length) if length > 0 else b""
        action = (
            self.put_fault_hook(key, body, index)
            if self.put_fault_hook is not None
            else None
        )
        if action == "drop":
            # Plain transport failure: the write was NOT applied, so the
            # client's retry (same condition) is safe.
            try:
                req.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            req.close_connection = True
            return
        if isinstance(action, tuple) and action[0] == "status":
            self._respond(req, int(action[1]), b"injected fault")
            return
        if isinstance(action, tuple) and action[0] == "race":
            # A competing writer lands FIRST; this request's condition is
            # then evaluated against the competitor's object (genuine
            # stale-ETag 412, not an injected status).
            self._write_key(key, bytes(action[1]))
        if isinstance(action, tuple) and action[0] == "skew":
            body = self._skew_body(body, float(action[1]))
        if_match = req.headers.get("If-Match")
        if_none_match = req.headers.get("If-None-Match")
        current = self._etag(key)
        if if_match is not None:
            # If-Match against a missing object fails too: you cannot
            # fence on a version that no longer exists.
            if current is None or if_match.strip('"') != current:
                self._respond(req, 412, b"precondition failed")
                return
        elif if_none_match is not None:
            if current is not None:
                self._respond(req, 412, b"precondition failed")
                return
        etag = self._write_key(key, body)
        if action == "lost":
            # The ambiguous PUT: applied server-side, but the response
            # never reaches the client — its conditional retry will 412
            # against its OWN write (resolved by read-back upstream).
            try:
                req.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            req.close_connection = True
            return
        headers = {"ETag": f'"{etag}"'} if self.send_etag else {}
        self._respond(req, 200, b"", headers=headers)
        with self._lock:
            self.requests_served += 1

    def _respond(
        self,
        req: BaseHTTPRequestHandler,
        status: int,
        body: bytes,
        content_type: str = "application/octet-stream",
        claimed_len: "Optional[int]" = None,
        headers: "Optional[Dict[str, str]]" = None,
    ) -> None:
        try:
            req.send_response(status)
            req.send_header("Content-Type", content_type)
            req.send_header(
                "Content-Length",
                str(len(body) if claimed_len is None else claimed_len),
            )
            for k, v in (headers or {}).items():
                req.send_header(k, v)
            req.end_headers()
            req.wfile.write(body)
            if claimed_len is not None and claimed_len != len(body):
                # Truncation fault: the headers promised more than was
                # written — drop the connection so the client's read fails.
                req.connection.shutdown(socket.SHUT_RDWR)
                req.close_connection = True
        except OSError:
            req.close_connection = True


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="directory of .ktaseg chunks to serve")
    ap.add_argument("--bucket", default="segments",
                    help="bucket name (the URL path prefix)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (announced on stdout)")
    ap.add_argument("--latency-ms", type=float, default=0.0,
                    help="injected per-request service delay")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        ap.error(f"--root {args.root!r} is not a directory")
    server = ObjectStoreHttpServer(
        args.root, bucket=args.bucket, latency_ms=args.latency_ms,
        host=args.host, port=args.port,
    ).start()
    print(f"objstore_serve: {server.url} (root {args.root})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
