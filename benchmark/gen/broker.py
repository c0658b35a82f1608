"""A loopback Kafka broker that serves a `Topic` from its template batches.

Frozen from the analyzer's own benchmark broker, so that a change to the
program cannot move the yardstick. A fetch at offset ``w * R`` of
partition ``p`` is answered with template ``p * T + w % T``, its 8-byte
``base_offset`` patched: the v2 batch CRC covers attributes onward, and
record offset deltas are relative to ``base_offset``, so the patch
retargets a batch to any window at memcpy speed. A response is an iovec
list sent with ``sendmsg``: small headers interleaved with the shared
template tails, never assembled in Python.

``brokers`` listener sockets are ``brokers`` advertised nodes; partition
``p`` is led by node ``p % brokers``. A fetch honours the request's
per-partition and request-level byte budgets, the first batch always
served whole. A ``head`` (anything with a ``.value``) bounds the windows
every partition shows; a ListOffsets request reads it once, so all
partitions of one answer share one head.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import List, Optional

from benchmark.gen import wire
from benchmark.gen.encode import encode_templates
from benchmark.gen.topic import Topic


def _sendmsg_all(conn: socket.socket, bufs: list) -> None:
    views = [memoryview(b) for b in bufs]
    i = 0
    while i < len(views):
        sent = conn.sendmsg(views[i:i + 512])
        while i < len(views) and sent >= len(views[i]):
            sent -= len(views[i])
            i += 1
        if sent:
            views[i] = views[i][sent:]


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class TemplateBroker:
    """Serve one topic of ``P`` partitions, ``windows`` windows each (fewer
    while a ``head`` holds them back)."""

    def __init__(self, topic: Topic, windows: int, brokers: int = 1, head=None):
        buf, starts, lens = encode_templates(topic)
        self._buf = buf
        mv = memoryview(buf)
        #: Per template: (its length, its tail after the base_offset).
        self.tmpl_len = [int(x) for x in lens]
        self.tmpl_tail = [mv[int(s) + 8:int(s) + int(n)] for s, n in zip(starts, lens)]
        self.name = topic.name
        self.P, self.T, self.R = topic.P, topic.T, topic.R
        self.windows = windows
        self.head = head
        self._socks: List[socket.socket] = []
        self.ports: List[int] = []
        for _ in range(max(1, brokers)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            s.listen(64)
            self._socks.append(s)
            self.ports.append(s.getsockname()[1])
        self._stop = threading.Event()

    def visible_windows(self) -> int:
        if self.head is None:
            return self.windows
        return max(0, min(self.windows, int(self.head.value)))

    def start(self) -> "TemplateBroker":
        for s in self._socks:
            threading.Thread(target=self._accept_loop, args=(s,), daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass

    def _accept_loop(self, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                head = _recv_exact(conn, 4)
                if head is None:
                    return
                payload = _recv_exact(conn, struct.unpack(">i", head)[0])
                if payload is None:
                    return
                api_key, api_version, corr, r = wire.decode_request_header(payload)
                body = self._dispatch(api_key, api_version, r)
                if isinstance(body, list):
                    total = sum(len(b) for b in body)
                    _sendmsg_all(conn, [struct.pack(">ii", 4 + total, corr)] + body)
                else:
                    conn.sendall(struct.pack(">ii", 4 + len(body), corr) + body)

    def _fetch_response(self, parts, max_bytes: int) -> list:
        R, T = self.R, self.T
        visible = self.visible_windows()
        end = visible * R
        budget = max_bytes
        served_any = False
        topic = self.name.encode()
        iov = [struct.pack(">iiH", 0, 1, len(topic)) + topic + struct.pack(">i", len(parts))]
        for pid, offset, pmax in parts:
            if not 0 <= pid < self.P:
                iov.append(struct.pack(">ihqqii", pid, wire.ERR_UNKNOWN_TOPIC_OR_PARTITION,
                                       -1, -1, 0, 0))
                continue
            w0 = offset // R  # align down; clients skip the records below
            lim = min(pmax, budget)
            n = size = 0
            base = pid * T
            while w0 + n < visible and (size < lim or (n == 0 and not served_any)):
                size += self.tmpl_len[base + (w0 + n) % T]
                n += 1
            served_any = served_any or n > 0
            budget = max(0, budget - size)
            iov.append(struct.pack(">ihqqii", pid, 0, end, end, 0, size))
            for w in range(w0, w0 + n):
                iov.append(struct.pack(">q", w * R))
                iov.append(self.tmpl_tail[base + w % T])
        return iov

    def _dispatch(self, api_key: int, api_version: int, r: wire.Reader):
        if api_key == wire.API_VERSIONS:
            return wire.encode_api_versions_response()
        if api_key == wire.API_METADATA:
            asked = wire.decode_metadata_request(r)
            nb = len(self.ports)
            topics = []
            for name in asked or [self.name]:
                if name != self.name:
                    topics.append((wire.ERR_UNKNOWN_TOPIC_OR_PARTITION, name, []))
                else:
                    topics.append((0, name, [(p, p % nb) for p in range(self.P)]))
            brokers = {i: ("127.0.0.1", port) for i, port in enumerate(self.ports)}
            return wire.encode_metadata_response(brokers, topics, api_version)
        if api_key == wire.API_LIST_OFFSETS:
            topic, parts = wire.decode_list_offsets_request(r)
            end = self.visible_windows() * self.R
            results = []
            for pid, ts in parts:
                if topic != self.name or not 0 <= pid < self.P:
                    results.append((pid, wire.ERR_UNKNOWN_TOPIC_OR_PARTITION, -1, -1))
                elif ts == wire.EARLIEST_TIMESTAMP:
                    results.append((pid, 0, -1, 0))
                elif ts == wire.LATEST_TIMESTAMP:
                    results.append((pid, 0, -1, end))
                else:
                    results.append((pid, 0, ts, 0))
            return wire.encode_list_offsets_response(topic, results)
        if api_key == wire.API_FETCH:
            topic, parts, max_bytes = wire.decode_fetch_request(r)
            if topic != self.name:
                parts = [(-1, off, pmax) for _, off, pmax in parts]
            return self._fetch_response(parts, max_bytes)
        raise ValueError(f"benchmark broker: unsupported api {api_key}")


class _Head:
    """The head a `BrokerProcess` child serves, raised by whoever holds
    the other end of its connection (a pipe: no shared memory file)."""

    def __init__(self, value: int, conn):
        self.value = value
        self._conn = conn
        threading.Thread(target=self._follow, daemon=True).start()

    def _follow(self) -> None:
        try:
            while True:
                self.value = self._conn.recv()
        except (EOFError, OSError):
            pass


def _broker_child(pipe, config: dict, seed: int, name: str, windows: int,
                  head: "int | None", head_conn) -> None:
    """Build the templates, serve, report the ports, block until told to
    stop; then report this process's CPU seconds."""
    topic = Topic(config, seed, name=name)
    held = None if head is None else _Head(head, head_conn)
    broker = TemplateBroker(topic, windows, topic.brokers, held).start()
    pipe.send(broker.ports)
    try:
        pipe.recv()
    except EOFError:
        pass
    broker.stop()
    pipe.send(time.process_time())


class BrokerProcess:
    """`TemplateBroker` in a child process of its own, so that serving
    takes no interpreter time from the program under test. A context
    manager; ``ports`` lists its nodes once it is up. ``head`` (windows
    per partition, or None for all ``windows``) starts a moving head, which
    `set_head` raises, or any process given ``head_conn`` by sending the
    new head on it."""

    def __init__(self, config: dict, seed: int, name: str, windows: int,
                 head: "int | None" = None):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self._head_recv, self.head_conn = self._ctx.Pipe(duplex=False)
        self._args = (config, seed, name, windows, head)
        self.ports: List[int] = []
        #: CPU seconds the broker process used, known once it stopped.
        self.cpu_s: "float | None" = None

    def set_head(self, windows: int) -> None:
        self.head_conn.send(int(windows))

    def __enter__(self) -> "BrokerProcess":
        self._pipe, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(target=_broker_child,
                                       args=(child, *self._args, self._head_recv),
                                       daemon=True)
        self._proc.start()
        child.close()
        self._head_recv.close()
        return self

    def wait_ready(self, timeout: float = 300.0) -> List[int]:
        deadline = time.monotonic() + timeout
        while not self._pipe.poll(0.2):
            if not self._proc.is_alive():
                raise RuntimeError(
                    f"benchmark broker exited with code {self._proc.exitcode}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"benchmark broker not up within {timeout:.0f} s")
        self.ports = self._pipe.recv()
        return self.ports

    @property
    def bootstrap(self) -> str:
        return f"127.0.0.1:{self.ports[0]}"

    def __exit__(self, *exc) -> None:
        try:
            self._pipe.send("stop")
            if self._pipe.poll(10):
                self.cpu_s = self._pipe.recv()
        except (OSError, EOFError):
            pass
        self._proc.join(10)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(5)
