"""The follow cell's load, in a process of its own: a producer that raises
the broker's head on an open-loop schedule, and a dashboard client that
subscribes to the service's SSE stream.

- The client connects to ``/events`` at once. Each frame is recorded with
  its arrival (monotonic and wall clock), its ``seq``, its ``report_ts``
  (the document's publish time) and the records its document covers; then
  the client fetches ``/report.json``, as a dashboard does on a new seq,
  and keeps the newest document.
- The window opens with the first frame: the service publishes once its
  first pass, over the backlog, is done. From then on,
  step ``k`` (k = 1, 2, ...) is due at ``open + k / steps_per_s``: at its
  due time the producer makes window ``backlog + k`` of every partition
  visible and stamps the step. Steps stop being due after ``seconds``.
- After the window the client waits until a frame covers the last step
  (at most ``settle_s``), then hands everything to the parent.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time


def _frames(sock: socket.socket):
    """Yield (monotonic, wall, data dict) per SSE ``publish`` frame."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            return
        buf += chunk
    buf = buf.split(b"\r\n\r\n", 1)[1]
    while True:
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            mono, wall = time.monotonic(), time.time()
            data = None
            for line in block.split(b"\n"):
                if line.startswith(b"data: "):
                    data = json.loads(line[6:])
            if data is not None:
                yield mono, wall, data
        chunk = sock.recv(65536)
        if not chunk:
            return
        buf += chunk


def load_main(pipe, head, port: int, per_step: int, backlog: int,
              steps_per_s: float, seconds: float, settle_s: float) -> None:
    """``head``: the broker's head connection; ``per_step``: records one
    step adds (a window of every partition); ``backlog``: windows per
    partition visible before the window opens."""
    frames: list = []
    docs: dict = {}
    lock = threading.Lock()
    covered = threading.Condition(lock)
    deadline = time.monotonic() + 300.0
    sock = None
    while sock is None:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            if time.monotonic() > deadline:
                pipe.send(("error", "the service's port never opened"))
                return
            time.sleep(0.2)
    sock.settimeout(None)
    sock.sendall(b"GET /events HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n")

    def listen() -> None:
        try:
            follow_stream()
        except OSError:
            pass  # the stream closed under the reader at the end

    def follow_stream() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for mono, wall, data in _frames(sock):
            with lock:
                frames.append((mono, wall, data))
                covered.notify_all()
            try:
                conn.request("GET", "/report.json")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status == 200:
                    doc = json.loads(body)
                    with lock:
                        docs["latest"] = (mono, doc)
            except (OSError, http.client.HTTPException, ValueError):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    threading.Thread(target=listen, daemon=True).start()

    def wait_records(n: int, until: float) -> bool:
        """Wait for a frame whose document covers ``n`` records."""
        with lock:
            while not frames or frames[-1][2].get("records", 0) < n:
                left = until - time.monotonic()
                if left <= 0:
                    return False
                covered.wait(left)
            return True

    if not wait_records(0, deadline):
        pipe.send(("error", "the service never published"))
        return
    t_open = time.monotonic()
    pipe.send(("open", t_open))
    stamps = []
    k = 0
    while True:
        due = t_open + (k + 1) / steps_per_s
        if due > t_open + seconds:
            break
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        k += 1
        head.send(backlog + k)
        stamps.append(time.monotonic())
    t_close = t_open + seconds
    with lock:
        in_window = docs.get("latest")
    wait_records((backlog + k) * per_step, time.monotonic() + settle_s)
    with lock:
        sent = list(frames)
    pipe.send(("done", {
        "t_open": t_open, "t_close": t_close, "t_done": time.monotonic(), "stamps": stamps,
        "frames": [(m, w, d) for m, w, d in sent],
        "window_doc": in_window[1] if in_window else None,
    }))
    sock.close()
