"""The port's serving plane (``serve/state.py``, ``serve/push.py`` and the
routes of ``obs/exporters.py``) against the reference's, over HTTP.

Each scenario runs once per package: the same published documents (the
same scripted publish clock), the same alert-engine evaluations and the
same history rows, served by that package's exporter on an ephemeral
port, fetched with the same requests.  Tolerance: exact — status codes,
the framing and cache headers, and body bytes (identity and the
publish-time gzip variant, which ``mtime=0`` makes deterministic) are
equal.  Routes: ``/report.json`` (404 without a service, 503 before the
first publish, ETag and ``If-None-Match`` → 304, ``Accept-Encoding:
gzip``, ``--no-serve-gzip``), ``/healthz`` (404 without an engine, 503
before the first evaluation, 200 healthy, 503 firing, 304), ``/history``
(404 without a store, windows, priced queries, 400 on bad parameters,
304) and ``/events`` (one SSE frame per publish, catch-up on connect,
404 without a publisher).  Every HTTP read has a deadline.
"""

from __future__ import annotations

import gzip
import http.client
import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
from port_instruments import drop_port_only

import kafka_topic_analyzer_tpu.config as ref_config
import kafka_topic_analyzer_tpu.obs.exporters as ref_exporters
import kafka_topic_analyzer_tpu.obs.health as ref_health
import kafka_topic_analyzer_tpu.obs.history as ref_history
import kafka_topic_analyzer_tpu.obs.registry as ref_registry
import kafka_topic_analyzer_tpu.serve.push as ref_push
import kafka_topic_analyzer_tpu.serve.state as ref_state
import kafka_topic_analyzer_tpu_torch.config as port_config
import kafka_topic_analyzer_tpu_torch.obs.exporters as port_exporters
import kafka_topic_analyzer_tpu_torch.obs.health as port_health
import kafka_topic_analyzer_tpu_torch.obs.history as port_history
import kafka_topic_analyzer_tpu_torch.obs.registry as port_registry
import kafka_topic_analyzer_tpu_torch.serve.push as port_push
import kafka_topic_analyzer_tpu_torch.serve.state as port_state

PKGS = {
    "port": SimpleNamespace(
        config=port_config, exporters=port_exporters, health=port_health,
        history=port_history, registry=port_registry, push=port_push,
        state=port_state,
    ),
    "ref": SimpleNamespace(
        config=ref_config, exporters=ref_exporters, health=ref_health,
        history=ref_history, registry=ref_registry, push=ref_push,
        state=ref_state,
    ),
}

#: Headers that frame or validate a response (the Date/Server headers
#: carry the wall clock and the Python version string).
COMPARED = ("Content-Type", "Content-Length", "Content-Encoding", "ETag",
            "Cache-Control", "Vary", "Connection")


def _clear(pkg) -> None:
    pkg.state.set_active(None)
    pkg.push.set_active(None)
    pkg.health.set_active(None)
    pkg.history.set_active(None)
    pkg.registry.default_registry().reset()


@pytest.fixture(autouse=True)
def _reset():
    for pkg in PKGS.values():
        _clear(pkg)
    yield
    for pkg in PKGS.values():
        _clear(pkg)


def _fetch(port, path, headers=None):
    """(status, compared headers, body); error statuses return theirs."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            status, hdr, body = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, hdr, body = e.code, e.headers, e.read()
    return status, {k: hdr.get(k) for k in COMPARED if hdr.get(k)}, body


def _both(scenario):
    """Run ``scenario(pkg, port)`` against each package's exporter; return
    {name: result}."""
    out = {}
    for name, pkg in PKGS.items():
        exporter = pkg.exporters.PrometheusExporter(0)
        try:
            out[name] = scenario(pkg, exporter.port)
        finally:
            exporter.close()
            _clear(pkg)
    return out


def _doc(hint: int, pad: int = 600) -> dict:
    """A report-ish document big enough to clear the gzip floor."""
    return {"topic": "t", "hint": hint, "pad": "x" * pad,
            "overall": {"count": 100 * hint}}


def test_report_json_conditional_and_gzip_equal_the_reference():
    def scenario(pkg, port):
        got = [_fetch(port, "/report.json")]  # 404: no service
        svc = pkg.state.ServiceState(clock=lambda: 1000.0)
        pkg.state.set_active(svc)
        got.append(_fetch(port, "/report.json"))  # 503: nothing published
        svc.publish(_doc(1), summary={"records": 100})
        got.append(_fetch(port, "/report.json"))
        got.append(_fetch(port, "/report.json", {"If-None-Match": '"r1"'}))
        got.append(_fetch(port, "/report.json", {"Accept-Encoding": "gzip"}))
        got.append(_fetch(port, "/report.json",
                          {"If-None-Match": '"r1"', "Accept-Encoding": "gzip"}))
        got.append(_fetch(port, "/report.json", {"Accept-Encoding": "gzip;q=0"}))
        svc.publish(_doc(2))
        got.append(_fetch(port, "/report.json", {"If-None-Match": '"r1"'}))
        got.append(_fetch(port, "/report.json", {"If-None-Match": '"r2"'}))
        got.append(_fetch(port, "/report.json?topic=nope"))
        svc.publish({"topic": "t"})  # under the gzip floor
        got.append(_fetch(port, "/report.json", {"Accept-Encoding": "gzip"}))
        off = pkg.state.ServiceState(clock=lambda: 1000.0, gzip_enabled=False)
        pkg.state.set_active(off)
        off.publish(_doc(3))
        got.append(_fetch(port, "/report.json", {"Accept-Encoding": "gzip"}))
        return got

    res = _both(scenario)
    assert res["port"] == res["ref"]
    codes = [g[0] for g in res["port"]]
    assert codes == [404, 503, 200, 304, 200, 304, 200, 200, 304, 404, 200, 200]
    identity, gz = res["port"][2][2], res["port"][4][2]
    assert res["port"][4][1]["Content-Encoding"] == "gzip"
    assert gzip.decompress(gz) == identity
    assert json.loads(identity)["seq"] == 1
    assert "Content-Encoding" not in res["port"][10][1]
    assert "Content-Encoding" not in res["port"][11][1]


def test_healthz_codes_equal_the_reference():
    def scenario(pkg, port):
        got = [_fetch(port, "/healthz")]  # 404: no engine
        cond = {"on": None}
        clock = {"t": 0.0}
        eng = pkg.health.HealthEngine(
            [pkg.health.AlertRule("r", "scripted", lambda ctx: cond["on"])],
            cfg=pkg.config.HealthConfig(eval_interval_s=0.001),
            clock=lambda: clock["t"], wall_clock=lambda: 500.0,
        )
        pkg.health.set_active(eng)
        got.append(_fetch(port, "/healthz"))  # 503: not yet evaluated
        eng.evaluate({})
        got.append(_fetch(port, "/healthz"))
        got.append(_fetch(port, "/healthz", {"If-None-Match": '"e1"'}))
        cond["on"] = {"n": 3}
        clock["t"] = 1.0
        eng.evaluate({})
        got.append(_fetch(port, "/healthz"))
        got.append(_fetch(port, "/healthz", {"If-None-Match": '"e1"'}))
        return got

    res = _both(scenario)
    assert res["port"] == res["ref"]
    assert [g[0] for g in res["port"]] == [404, 503, 200, 304, 503, 503]
    firing = json.loads(res["port"][4][2])
    assert firing["firing"][0]["evidence"] == {"n": 3}


def test_history_route_equal_the_reference(tmp_path):
    def scenario(pkg, port):
        got = [_fetch(port, "/history")]  # 404: no store
        clk = {"t": 1000.0}
        store = pkg.history.HistoryStore(
            str(tmp_path / type(pkg).__name__ / pkg.history.__name__),
            max_bytes=1 << 16, clock=lambda: clk["t"],
        )
        store.register_kinds({"records": "cum", "depth": "inst"})
        for i in range(40):
            clk["t"] = 1000.0 + i
            store.append({"records": 10.0 * i, "depth": float(i % 5)})
        pkg.history.set_active(store)
        got.append(_fetch(port, "/history"))
        got.append(_fetch(port, "/history?t0=1005&t1=1010&tracks=records"))
        got.append(_fetch(port, "/history?max_points=8"))
        etag = got[-1][1]["ETag"]
        got.append(_fetch(port, "/history?max_points=8", {"If-None-Match": etag}))
        got.append(_fetch(port, "/history?t0=soon"))
        got.append(_fetch(port, "/history?max_points=0"))
        store.append({"records": 999.0, "depth": 0.0})
        got.append(_fetch(port, "/history?max_points=8", {"If-None-Match": etag}))
        store.close()
        return got

    res = _both(scenario)
    assert res["port"] == res["ref"]
    assert [g[0] for g in res["port"]] == [404, 200, 200, 200, 304, 400, 400, 200]
    window = json.loads(res["port"][2][2])
    assert window["t"] == [1005.0 + i for i in range(6)]
    assert list(window["tracks"]) == ["records"]
    assert json.loads(res["port"][3][2])["points"] <= 8


def _read_sse_frame(resp, deadline_s=5.0):
    """One SSE frame (its lines up to the blank line), comments skipped;
    None at the end of the stream."""
    deadline = time.monotonic() + deadline_s
    lines = []
    while time.monotonic() < deadline:
        line = resp.readline()
        if not line:
            return None
        line = line.rstrip(b"\r\n")
        if line.startswith(b":"):
            continue
        if line == b"":
            if lines:
                return lines
            continue
        lines.append(line)
    raise AssertionError("no SSE frame within the deadline")


def _wait(predicate, deadline_s=5.0) -> None:
    deadline = time.monotonic() + deadline_s
    while not predicate():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def test_sse_frames_equal_the_reference():
    def scenario(pkg, port):
        status404 = _fetch(port, "/events")[0]
        svc = pkg.state.ServiceState(clock=lambda: 1000.0)
        pkg.state.set_active(svc)
        pub = pkg.push.SsePublisher().start()
        pkg.push.set_active(pub)
        svc.publish(_doc(1), summary={"records": 100, "passes": 1})
        _wait(lambda: pub._last_frame is not None)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("GET", "/events")
            resp = conn.getresponse()
            head = (resp.status, resp.headers["Content-Type"],
                    resp.headers["Cache-Control"])
            frames = [_read_sse_frame(resp)]  # catch-up
            _wait(lambda: pub.subscribers == 1)
            for i in (2, 3):
                svc.publish(_doc(i), summary={"records": 100 * i, "passes": i})
                frames.append(_read_sse_frame(resp))
            pub.stop()
            frames.append(_read_sse_frame(resp))  # stream closed: None
        finally:
            conn.close()
            pub.stop()
        return status404, head, frames, pub.offered, pub.delivered

    res = _both(scenario)
    assert res["port"] == res["ref"]
    status404, head, frames, offered, delivered = res["port"]
    assert status404 == 404
    assert head == (200, "text/event-stream", "no-store")
    assert frames[-1] is None
    ids = [dict(l.split(b": ", 1) for l in f)[b"id"] for f in frames[:-1]]
    assert ids == [b"1", b"2", b"3"]
    data = json.loads(dict(l.split(b": ", 1) for l in frames[2])[b"data"])
    assert data["seq"] == 3 and data["records"] == 300
    assert (offered, delivered) == (3, 2)


def test_sse_slow_subscriber_is_evicted_and_booked():
    pub = port_push.SsePublisher(queue_len=2).start()
    svc = port_state.ServiceState()
    port_push.set_active(pub)
    try:
        sub = pub.subscribe()
        for i in range(6):
            svc.publish(_doc(i))
        _wait(lambda: sub.closed)
        dropped = port_registry.default_registry().snapshot()[
            "kta_serve_sse_dropped_total"]["samples"]
        assert any(s["labels"] == {"reason": "slow-client"} and s["value"] == 1
                   for s in dropped)
        _wait(lambda: b"id: 6" in (pub._last_frame or b""))
        late = pub.subscribe()  # catch-up: the newest frame at once
        assert b"id: 6" in late.next_frame(timeout=5)
    finally:
        pub.stop()


def test_unknown_route_and_keepalive_framing_equal_the_reference():
    def scenario(pkg, port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        out = []
        try:
            for path in ("/nope", "/flight", "/metrics", "/healthz"):
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                # /metrics: the length of the reference's families (the
                # port adds exactly its own, `port_instruments.PORT_ONLY`).
                out.append((resp.status,
                            resp.headers["Content-Length"] if path != "/metrics"
                            else str(len(drop_port_only(body))),
                            body if path != "/metrics" else b""))
        finally:
            conn.close()
        return out

    res = _both(scenario)
    assert res["port"] == res["ref"]
    assert [s for s, _, _ in res["port"]] == [404, 404, 200, 404]


@pytest.mark.parametrize("argv,message", [
    (["--history-bytes", "1000", "--snapshot-dir", "SNAP"],
     "error: --history-bytes must be >= 4096\n"),
    (["--history-bytes", "65536"],
     "error: --history-bytes requires --snapshot-dir (the telemetry history "
     "lives next to the checkpoints so a restarted service resumes both "
     "from one place)\n"),
    ([], None),
], ids=["too-small", "no-snapshot-dir", "wired"])
def test_cli_history_bytes(tmp_path, capsys, argv, message):
    """``--history-bytes``: the reference's refusals, word for word; wired,
    the store lands in ``SNAPSHOT_DIR/_kta_history`` in the reference's
    format and ``--stats`` prints the HEALTH digest."""
    from kafka_topic_analyzer_tpu import cli as ref_cli
    from kafka_topic_analyzer_tpu_torch import cli

    snap = str(tmp_path / "snap")
    argv = [a.replace("SNAP", snap) for a in argv] or [
        "--history-bytes", "65536", "--snapshot-dir", snap, "--stats"]
    base = ["-t", "h", "--source", "synthetic", "--synthetic",
            "partitions=2,messages=2000,keys=50", "--quiet", *argv]
    rc = cli.main(base + ["--device", "cpu"])
    out, err = capsys.readouterr()
    if message is not None:
        assert (rc, out, err) == (1, "", message)
        assert ref_cli.main(base) == 1
        assert capsys.readouterr().err == message
        return
    assert rc == 0 and "HEALTH: ok" in err
    store = ref_history.HistoryStore(str(tmp_path / "snap" / "_kta_history"))
    window = store.window()
    store.close()
    assert store.epoch == 2 and window["t"]  # the port's rows, epoch 1
    assert window["kinds"]["records"] == "cum"


def test_bench_serve_fleet_stops_when_told():
    """`tools/bench_serve.run_fleet` polls until its ``stop`` event is set,
    well before its ``seconds``, and books conditional polls: one gzip
    body per publish, 304s between."""
    import threading

    from kafka_topic_analyzer_tpu_torch.tools.bench_serve import run_fleet

    pkg = PKGS["port"]
    svc = pkg.state.ServiceState(clock=lambda: 1000.0)
    pkg.state.set_active(svc)
    svc.publish(_doc(1), summary={"records": 100})
    exporter = pkg.exporters.PrometheusExporter(0)
    stop = threading.Event()
    timer = threading.Timer(0.5, stop.set)
    try:
        timer.start()
        t0 = time.monotonic()
        doc = run_fleet(exporter.port, 3, 20.0, 30.0, True, stop=stop)
        took = time.monotonic() - t0
    finally:
        timer.cancel()
        exporter.close()
    assert took < 10.0 and doc["seconds"] < 10.0
    assert doc["polls"] > 3 and doc["errors"] == 0
    assert doc["gzip_bodies"] == 3  # each poller's first poll; one publish
    assert doc["not_modified"] == doc["polls"] - 3
