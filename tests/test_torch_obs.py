"""The port's telemetry core (`kafka_topic_analyzer_tpu_torch.obs`) against
the reference's: registry instruments and the snapshot/merge algebra,
Prometheus text exposition, the event bus and its JSONL sink, the span
tracer, the flight recorder and the scrape endpoint (ported from
``tests/test_obs.py`` and the sampler units of ``tests/test_flight.py``,
run against the port's modules).

Where both packages can take the same input, both do: the same bookings
into a registry of each give equal snapshots and equal exposition text,
and the two instrument catalogs declare the same families (name, type,
help, labels, merge policy, buckets).
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from kafka_topic_analyzer_tpu.obs import metrics as ref_metrics
from kafka_topic_analyzer_tpu.obs import registry as ref_registry
from kafka_topic_analyzer_tpu_torch.obs import events, trace
from kafka_topic_analyzer_tpu_torch.obs import flight as obs_flight
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import registry as port_registry
from kafka_topic_analyzer_tpu_torch.obs.exporters import CONTENT_TYPE, PrometheusExporter
from kafka_topic_analyzer_tpu_torch.obs.flight import FlightRecorder
from kafka_topic_analyzer_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    merge_snapshots,
    render_prometheus,
)


@pytest.fixture(autouse=True)
def _reset_registry():
    default_registry().reset()
    yield
    default_registry().reset()
    obs_flight.set_active(None)


# ---------------------------------------------------------------------------
# instruments


def test_counter_monotonic():
    c = Counter("c_total", "help")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_inc():
    g = Gauge("g", "help")
    g.set(7)
    g.inc(3)
    assert g.value == 10.0


def test_histogram_bucket_placement():
    h = Histogram("h", "help", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 4.0, 5.0):
        h.observe(v)
    s = h.samples()[0]
    # le is inclusive (Prometheus contract): 1.0 lands in le=1, 4.0 in le=4.
    assert s["counts"] == [2, 1, 1, 1]
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(12.0)


@pytest.mark.parametrize("buckets", [(2.0, 1.0), (1.0, 1.0), ()])
def test_histogram_rejects_bad_buckets(buckets):
    with pytest.raises(ValueError):
        Histogram("h", "help", buckets=buckets)


def test_histogram_time_context():
    h = Histogram("h", "help", buckets=(10.0,))
    with h.time():
        pass
    s = h.samples()[0]
    assert s["count"] == 1
    assert 0 <= s["sum"] < 10.0


def test_labels_children_and_validation():
    c = Counter("c_total", "help", labelnames=("partition",))
    c.labels(0).inc()
    c.labels(partition=0).inc()
    c.labels("1").inc(5)
    by = {tuple(s["labels"].items()): s["value"] for s in c.samples()}
    assert by[(("partition", "0"),)] == 2.0
    assert by[(("partition", "1"),)] == 5.0
    with pytest.raises(ValueError):
        c.labels("0", "extra")
    with pytest.raises(ValueError):
        Counter("c", "help", labelnames=("bad-name",))


def test_registry_get_or_create_and_conflicts():
    reg = MetricsRegistry()
    a = reg.counter("x_total", "help")
    assert reg.counter("x_total", "other help") is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", "now a gauge?")
    with pytest.raises(ValueError):
        reg.counter("bad name", "help")


def test_registry_reset_keeps_registrations():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "help")
    h = reg.histogram("h", "help", buckets=(1.0,))
    c.inc(3)
    h.observe(0.5)
    reg.reset()
    assert c.value == 0.0
    assert reg.counter("x_total", "help") is c
    assert h.samples()[0]["count"] == 0


# ---------------------------------------------------------------------------
# Prometheus text exposition


def test_render_prometheus_counter_and_histogram():
    reg = MetricsRegistry()
    reg.counter("kta_x_total", "records\nseen").inc(3)
    h = reg.histogram("kta_lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = render_prometheus(reg.snapshot())
    assert "# HELP kta_x_total records seen\n" in text  # newline escaped
    assert "# TYPE kta_x_total counter\n" in text
    assert "kta_x_total 3\n" in text
    assert 'kta_lat_seconds_bucket{le="0.1"} 1\n' in text
    assert 'kta_lat_seconds_bucket{le="1"} 2\n' in text
    assert 'kta_lat_seconds_bucket{le="+Inf"} 3\n' in text  # cumulative
    assert "kta_lat_seconds_count 3\n" in text


def test_render_prometheus_label_escaping():
    reg = MetricsRegistry()
    reg.gauge("g", "help", labelnames=("t",)).labels('a"b\\c\nd').set(1)
    text = render_prometheus(reg.snapshot())
    assert 'g{t="a\\"b\\\\c\\nd"} 1' in text


# ---------------------------------------------------------------------------
# merge algebra


def _snap(build, registry=MetricsRegistry):
    reg = registry()
    build(reg)
    return reg.snapshot()


def test_merge_counters_add_gauges_max():
    a = _snap(lambda r: (r.counter("c_total", "h").inc(2),
                         r.gauge("g", "h").set(5)))
    b = _snap(lambda r: (r.counter("c_total", "h").inc(3),
                         r.gauge("g", "h").set(4)))
    merged = merge_snapshots([a, b])
    assert merged["c_total"]["samples"][0]["value"] == 5.0
    assert merged["g"]["samples"][0]["value"] == 5.0


def test_merge_sum_policy_gauge():
    a = _snap(lambda r: r.gauge("deg", "h", merge="sum").set(2))
    b = _snap(lambda r: r.gauge("deg", "h", merge="sum").set(3))
    merged = merge_snapshots([a, b])
    assert merged["deg"]["samples"][0]["value"] == 5.0
    assert a["deg"]["merge"] == "sum"
    with pytest.raises(ValueError):
        MetricsRegistry().gauge("bad", "h", merge="median")


def test_merge_disjoint_labels_union():
    a = _snap(lambda r: r.gauge("lag", "h", labelnames=("p",)).labels(0).set(10))
    b = _snap(lambda r: r.gauge("lag", "h", labelnames=("p",)).labels(1).set(20))
    merged = merge_snapshots([a, b])
    assert [
        (s["labels"]["p"], s["value"]) for s in merged["lag"]["samples"]
    ] == [("0", 10.0), ("1", 20.0)]


def test_merge_histogram_bucket_mismatch_raises():
    a = _snap(lambda r: r.histogram("h", "h", buckets=(1.0, 2.0)).observe(1))
    b = _snap(lambda r: r.histogram("h", "h", buckets=(1.0, 4.0)).observe(1))
    with pytest.raises(ValueError, match="bucket layouts"):
        merge_snapshots([a, b])


def test_merge_type_conflict_raises():
    a = _snap(lambda r: r.counter("m_total", "h").inc())
    b = _snap(lambda r: r.gauge("m_total", "h").set(1))
    with pytest.raises(ValueError, match="conflicting types"):
        merge_snapshots([a, b])


def test_merge_does_not_mutate_inputs():
    a = _snap(lambda r: r.counter("c_total", "h").inc(1))
    b = _snap(lambda r: r.counter("c_total", "h").inc(2))
    merge_snapshots([a, b])
    merge_snapshots([a, b])
    assert a["c_total"]["samples"][0]["value"] == 1.0


def test_merge_n_shards_equals_observing_union_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    buckets = (0.001, 0.01, 0.1, 1.0, 10.0)
    samples_strategy = st.lists(
        st.lists(st.floats(min_value=0.0, max_value=100.0, allow_nan=False,
                           allow_infinity=False), max_size=30),
        min_size=1, max_size=6,
    )

    @settings(max_examples=60, deadline=None)
    @given(shards=samples_strategy)
    def law(shards):
        snaps = []
        union_reg = MetricsRegistry()
        uh = union_reg.histogram("h", "help", buckets=buckets)
        uc = union_reg.counter("n_total", "help")
        for values in shards:
            reg = MetricsRegistry()
            h = reg.histogram("h", "help", buckets=buckets)
            c = reg.counter("n_total", "help")
            for v in values:
                h.observe(v)
                c.inc()
                uh.observe(v)
                uc.inc()
            snaps.append(reg.snapshot())
        merged = merge_snapshots(snaps)
        want = union_reg.snapshot()
        got_h, want_h = merged["h"]["samples"][0], want["h"]["samples"][0]
        assert got_h["counts"] == want_h["counts"]
        assert got_h["count"] == want_h["count"]
        assert got_h["sum"] == pytest.approx(want_h["sum"])
        assert merged["n_total"]["samples"][0]["value"] == \
            want["n_total"]["samples"][0]["value"]

    law()


# ---------------------------------------------------------------------------
# the same bookings in both packages


def _book(reg) -> None:
    """A mix of every instrument kind, labelled and not, with the values
    the scan books (integers, fractions, a histogram past its buckets)."""
    reg.counter("kta_records_total", "records\nseen").inc(12345)
    reg.counter("kta_seconds_total", "secs").inc(0.125)
    by = reg.counter("kta_fallback_total", "by reason", labelnames=("reason",))
    by.labels("compressed").inc(7)
    by.labels(reason='odd "name"').inc(2)
    reg.gauge("kta_lag", "lag", labelnames=("partition",)).labels(3).set(99)
    reg.gauge("kta_degraded", "deg", merge="sum").set(2)
    h = reg.histogram("kta_batch_records", "rows", buckets=(1.0, 1024.0, 262144.0))
    for v in (0.5, 1024.0, 262144.0, 1e9):
        h.observe(v)


def test_same_bookings_give_equal_snapshots_and_exposition():
    port = _snap(_book)
    ref = _snap(_book, ref_registry.MetricsRegistry)
    assert port == ref
    assert render_prometheus(port) == ref_registry.render_prometheus(ref)
    merged = merge_snapshots([port, _snap(_book)])
    ref_merged = ref_registry.merge_snapshots([ref, _snap(_book, ref_registry.MetricsRegistry)])
    assert merged == ref_merged
    assert render_prometheus(merged) == ref_registry.render_prometheus(ref_merged)


def _catalog(module) -> dict:
    out = {}
    for inst in module._REG.instruments():
        out[inst.name] = (inst.kind, inst.help, inst.labelnames,
                          getattr(inst, "merge", None), getattr(inst, "buckets", None))
    return out


def test_instrument_catalog_equals_the_reference():
    port, ref = _catalog(obs_metrics), _catalog(ref_metrics)
    assert sorted(port) == sorted(ref)
    assert port == ref
    assert len(port) > 100


# ---------------------------------------------------------------------------
# event bus


def test_emit_without_sinks_is_noop():
    events.emit("anything", x=1)


def test_jsonl_sink_and_capture(tmp_path):
    path = tmp_path / "events.jsonl"
    clock = iter([10.0, 11.5])
    sink = events.JsonlEventLog(str(path), clock=lambda: next(clock))
    events.add_sink(sink)
    try:
        events.emit("scan_start", topic="t", partitions=3)
        events.emit("scan_end", topic="t", records=5)
    finally:
        events.remove_sink(sink)
        sink.close()
    docs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [d["type"] for d in docs] == ["scan_start", "scan_end"]
    assert docs[0]["ts"] == 10.0
    assert docs[0]["partitions"] == 3
    assert docs[1]["records"] == 5


def test_failing_sink_is_detached():
    calls = []

    def bad(etype, fields):
        calls.append(etype)
        raise RuntimeError("disk full")

    events.add_sink(bad)
    try:
        events.emit("one")
        events.emit("two")  # bad sink already detached; no raise
    finally:
        events.remove_sink(bad)
    assert calls == ["one"]


def test_heartbeat_rate_limit_and_force():
    t = [0.0]
    hb = events.Heartbeat(10.0, clock=lambda: t[0])
    assert hb.ready()
    t[0] = 5.0
    assert not hb.ready()
    t[0] = 10.0
    assert hb.ready()
    t[0] = 11.0
    hb.force()
    assert hb.ready()


# ---------------------------------------------------------------------------
# span tracer


def test_tracer_spans_and_chrome_format(tmp_path):
    t = [0.0]
    tr = trace.SpanTracer(clock=lambda: t[0])
    with tr.span("fetch", cat="io"):
        t[0] += 0.25
    tr.add_complete("decode", 1.0, 0.5, cat="io", args={"n": 3})
    doc = tr.chrome_trace()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["fetch"]["ph"] == "X"
    assert ev["fetch"]["dur"] == pytest.approx(0.25e6)
    assert ev["decode"]["ts"] == pytest.approx(1.0e6)
    assert ev["decode"]["args"] == {"n": 3}
    path = tmp_path / "trace.json"
    tr.write(str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_tracer_counter_events_equal_the_reference():
    from kafka_topic_analyzer_tpu.obs import trace as ref_trace

    docs = []
    for module in (trace, ref_trace):
        tr = module.SpanTracer(clock=lambda: 2.0)
        tr.add_counter("flight", {"dispatch_inflight": 2.0, "lag": 7}, t_s=1.5)
        tr.add_complete("ingest", 1.0, 0.25, cat="stage")
        docs.append([{k: v for k, v in e.items() if k not in ("pid", "tid")}
                     for e in tr.events()])
    assert docs[0] == docs[1]
    assert [e["ph"] for e in docs[0]] == ["C", "X"]


def test_maybe_span_active_and_inactive():
    with trace.maybe_span("idle"):
        pass
    tr = trace.SpanTracer()
    trace.set_active(tr)
    try:
        with trace.maybe_span("work"):
            pass
    finally:
        trace.set_active(None)
    assert [e["name"] for e in tr.events()] == ["work"]


def test_telemetry_session_bad_trace_path_fails_fast(tmp_path):
    from kafka_topic_analyzer_tpu_torch.obs import telemetry_session

    with pytest.raises(OSError):
        with telemetry_session(trace_json=str(tmp_path / "no" / "t.json")):
            raise AssertionError("session body must not run")


def test_telemetry_session_write_failure_does_not_mask(tmp_path):
    from kafka_topic_analyzer_tpu_torch.obs import telemetry_session

    trace_path = tmp_path / "t.json"
    events_path = tmp_path / "e.jsonl"

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        with telemetry_session(events_jsonl=str(events_path), trace_json=str(trace_path)):
            trace_path.unlink()
            trace_path.mkdir()
            raise Boom()
    assert events._sinks == []


# ---------------------------------------------------------------------------
# flight recorder


def test_recorder_samples_synchronized_tracks():
    clk = {"t": 100.0}
    rec = FlightRecorder(interval_s=0.5, clock=lambda: clk["t"])
    rec.sample_once()
    clk["t"] = 101.0
    obs_metrics.STAGE_SECONDS.labels(stage="ingest").inc(0.7)
    obs_metrics.DISPATCH_INFLIGHT.set(2)
    rec.sample_once()
    s = rec.series()
    assert s["t"] == [0.0, 1.0]
    assert s["tracks"]["stage_ingest_s"] == [0.0, 0.7]
    assert s["tracks"]["dispatch_inflight"] == [0.0, 2.0]
    assert s["kinds"]["stage_ingest_s"] == "cum"
    assert s["kinds"]["dispatch_inflight"] == "inst"
    assert all(len(v) == 2 for v in s["tracks"].values())
    assert obs_metrics.FLIGHT_SAMPLES.value == 2
    json.dumps(s)


def test_recorder_tracks_equal_the_reference():
    from kafka_topic_analyzer_tpu.obs.flight import FlightRecorder as RefRecorder

    ref_registry.default_registry().reset()
    try:
        series = []
        for rec_cls in (FlightRecorder, RefRecorder):
            rec = rec_cls(interval_s=0.5, clock=lambda: 0.0)
            rec.sample_once()
            series.append(rec.series())
    finally:
        ref_registry.default_registry().reset()
    assert series[0]["kinds"] == series[1]["kinds"]
    assert series[0]["tracks"] == series[1]["tracks"]


def test_recorder_ring_decimates_and_doubles_interval():
    clk = {"t": 0.0}
    rec = FlightRecorder(interval_s=1.0, max_samples=16, clock=lambda: clk["t"])
    for i in range(17):
        clk["t"] = float(i)
        rec.sample_once()
    s = rec.series()
    assert s["t"] == [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0, 16.0]
    assert s["interval_s"] == 2.0
    assert all(len(v) == 9 for v in s["tracks"].values())


def test_recorder_thread_start_stop():
    rec = FlightRecorder(interval_s=0.01)
    rec.start()
    with pytest.raises(RuntimeError):
        rec.start()
    time.sleep(0.08)
    rec.stop()
    n = len(rec.series()["t"])
    assert n >= 2
    time.sleep(0.03)
    assert len(rec.series()["t"]) == n
    rec.stop()


def test_recorder_emits_chrome_counter_tracks():
    tracer = trace.SpanTracer()
    trace.set_active(tracer)
    try:
        rec = FlightRecorder(interval_s=0.5, clock=lambda: 0.0)
        obs_metrics.DISPATCH_INFLIGHT.set(1)
        rec.sample_once()
    finally:
        trace.set_active(None)
    counters = [e for e in tracer.events() if e["ph"] == "C"]
    assert len(counters) == 1
    assert counters[0]["name"] == "flight"
    assert counters[0]["args"]["dispatch_inflight"] == 1.0
    assert "stage_ingest_s" not in counters[0]["args"]
    json.dumps(tracer.chrome_trace())


# ---------------------------------------------------------------------------
# scrape endpoint


def test_prometheus_exporter_serves_registry():
    reg = MetricsRegistry()
    reg.counter("kta_test_total", "scrape me").inc(7)
    exporter = PrometheusExporter(0, registry=reg)
    try:
        url = f"http://127.0.0.1:{exporter.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"] == CONTENT_TYPE
        assert "kta_test_total 7\n" in body
        reg.counter("kta_test_total", "").inc()
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert "kta_test_total 8\n" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        exporter.close()


def test_flight_endpoint_serves_active_series():
    exporter = PrometheusExporter(0)
    try:
        url = f"http://127.0.0.1:{exporter.port}/flight"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 404
        rec = FlightRecorder(interval_s=0.5, clock=lambda: 0.0)
        rec.sample_once()
        obs_flight.set_active(rec)
        with urllib.request.urlopen(url, timeout=5) as resp:
            doc = json.loads(resp.read().decode())
            etag = resp.headers["ETag"]
        assert doc["t"] == [0.0]
        assert "stage_ingest_s" in doc["tracks"]
        req = urllib.request.Request(url, headers={"If-None-Match": etag})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 304
        with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                    timeout=5) as resp:
            assert "kta_flight_samples_total 1" in resp.read().decode()
    finally:
        obs_flight.set_active(None)
        exporter.close()


def test_registry_hammer_no_lost_updates():
    """Concurrent inc/observe/labels() from 8 threads lose nothing, and one
    label set resolves to one child."""
    import threading

    reg = MetricsRegistry()
    counter = reg.counter("h_total", "hammered counter")
    labeled = reg.counter("h_by_worker_total", "per-worker", labelnames=("w",))
    gauge = reg.gauge("h_gauge", "hammered gauge")
    hist = reg.histogram("h_hist", "hammered histogram", buckets=(1.0, 10.0))
    n_threads, n_ops = 8, 2_000
    start = threading.Barrier(n_threads)
    children = [None] * n_threads

    def worker(t: int) -> None:
        start.wait()
        for i in range(n_ops):
            counter.inc()
            labeled.labels(w=t % 2).inc(2)
            gauge.inc(1)
            hist.observe(float(i % 20))
        children[t] = labeled.labels(w=t % 2)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.value == gauge.value == n_threads * n_ops
    snap = reg.snapshot()
    by_w = {s["labels"]["w"]: s["value"] for s in snap["h_by_worker_total"]["samples"]}
    assert by_w == {"0": n_threads * n_ops, "1": n_threads * n_ops}
    assert snap["h_hist"]["samples"][0]["count"] == n_threads * n_ops
    assert children[0] is children[2]


def test_default_registry_is_the_ports_own():
    assert port_registry.default_registry() is not ref_registry.default_registry()
    assert obs_metrics.SCAN_RECORDS is not ref_metrics.SCAN_RECORDS
    obs_metrics.SCAN_RECORDS.inc(5)
    assert default_registry().snapshot()["kta_scan_records_total"]["samples"][0]["value"] == 5
