"""The port's alert engine, telemetry history and trend doctor
(``obs/health.py``, ``obs/history.py``, ``obs/doctor.diagnose_trends``)
against the reference's.

Every comparison is exact: both engines are driven through the same
scripted clock (monotonic and wall) with the same registry snapshots and
extras, and every published health document — rule states, evidence,
``since_s``/``firing_s``, the verdict — must be equal, as must the
transition counters each package books.  History stores written by one
package are read by the other (same on-disk format), and the trend
doctor gives the same findings over the same windows.  The engine's
tests read scripted clocks and never sleep; the two follow-service tests
at the end (a lag-divergence fault flipping ``/healthz`` and healing, a
dead broker raising the watermark-outage alert) poll with deadlines.
"""

from __future__ import annotations

import os

import pytest

from kafka_topic_analyzer_tpu.config import HealthConfig as RefHealthConfig
from kafka_topic_analyzer_tpu.obs import doctor as ref_doctor
from kafka_topic_analyzer_tpu.obs import health as ref_health
from kafka_topic_analyzer_tpu.obs import history as ref_history
from kafka_topic_analyzer_tpu.obs import metrics as ref_metrics
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu_torch.config import HealthConfig
from kafka_topic_analyzer_tpu_torch.obs import doctor, events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import flight as obs_flight
from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
from kafka_topic_analyzer_tpu_torch.obs import history as obs_history
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.flight import FlightRecorder
from kafka_topic_analyzer_tpu_torch.obs.health import (
    FIRING,
    OK,
    PENDING,
    RESOLVING,
    AlertRule,
    HealthEngine,
    built_in_rules,
)
from kafka_topic_analyzer_tpu_torch.obs.history import (
    HistoryStore,
    track_delta,
    track_rate,
)
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()
    obs_health.set_active(None)
    obs_history.set_active(None)
    obs_flight.set_active(None)


@pytest.fixture()
def event_log():
    events = []
    sink = lambda etype, fields: events.append((etype, fields))  # noqa: E731
    obs_events.add_sink(sink)
    yield events
    obs_events.remove_sink(sink)


# ---------------------------------------------------------------------------
# the rule state machine (scripted clock)


class _Cond:
    """A scriptable rule condition."""

    def __init__(self):
        self.value = None  # evidence dict or None

    def __call__(self, ctx):
        return self.value


def _engine(rule, clock):
    return HealthEngine(
        [rule], cfg=HealthConfig(eval_interval_s=0.001),
        clock=lambda: clock["t"], wall_clock=lambda: 1234.0,
    )


def _transitions(rule, state) -> float:
    return obs_metrics.ALERTS_TRANSITIONS.labels(rule=rule, state=state).value


def test_rule_fires_immediately_without_for_duration(event_log):
    cond = _Cond()
    clock = {"t": 0.0}
    eng = _engine(AlertRule("r", "test rule", cond), clock)
    doc = eng.evaluate({})
    assert doc["healthy"] and not doc["firing"]
    cond.value = {"n": 7}
    doc = eng.evaluate({})
    assert not doc["healthy"]
    assert doc["firing"][0]["evidence"] == {"n": 7}
    assert _transitions("r", FIRING) == 1
    assert obs_metrics.ALERTS_FIRING.labels(rule="r").value == 1
    assert ("alert_firing", {"rule": "r", "state": "firing",
                             "evidence": {"n": 7}}) in event_log
    assert eng.healthz()[0] == 503
    cond.value = None
    doc = eng.evaluate({})
    assert doc["healthy"] and eng.healthz()[0] == 200
    assert obs_metrics.ALERTS_FIRING.labels(rule="r").value == 0


def test_rule_for_duration_blip_and_flap_suppression(event_log):
    cond = _Cond()
    clock = {"t": 0.0}
    eng = _engine(
        AlertRule("r", "test rule", cond, for_s=5.0, resolve_s=5.0), clock
    )
    states = []
    # A blip shorter than for_s never fires; then a held condition does;
    # a flap inside the resolve window re-arms without a second firing.
    script = [(0, {"n": 1}), (2, None), (3, {"n": 2}), (9, {"n": 3}),
              (10, None), (12, {"n": 4}), (13, None), (19, None)]
    for t, value in script:
        clock["t"] = float(t)
        cond.value = value
        states.append(eng.evaluate({})["rules"][0]["state"])
    assert states == [PENDING, OK, PENDING, FIRING, RESOLVING, FIRING,
                      RESOLVING, OK]
    assert [e for e, _ in event_log].count("alert_firing") == 1
    assert [e for e, _ in event_log].count("alert_cleared") == 1
    assert _transitions("r", FIRING) == 2
    assert _transitions("r", OK) == 2


def test_broken_rule_never_raises_and_duplicates_refused():
    def boom(ctx):
        raise RuntimeError("rule bug")

    eng = HealthEngine([AlertRule("b", "broken", boom)])
    assert eng.evaluate({})["healthy"]
    with pytest.raises(ValueError, match="duplicate"):
        HealthEngine([AlertRule("x", "a", boom), AlertRule("x", "b", boom)])


# ---------------------------------------------------------------------------
# built-in rules: the port's documents equal the reference's


def _snap(lag=0.0, records=0.0, degraded=0.0, corrupt=0.0, refresh=0.0,
          lost=0.0, truncated=0.0, regressions=0.0) -> dict:
    def one(value, labels=None):
        return {"type": "counter",
                "samples": [{"labels": labels or {}, "value": float(value)}]}

    snap = {
        "kta_follow_lag_records": one(lag),
        "kta_scan_records_total": one(records),
        "kta_scan_degraded_partitions": one(degraded),
        "kta_corrupt_frames_total": one(corrupt, {"kind": "crc"}),
        "kta_watermark_refresh_failures_total": one(refresh),
        "kta_log_watermark_regressions_total": one(regressions),
    }
    snap["kta_log_lost_records_total"] = {
        "type": "counter",
        "samples": [
            {"labels": {"reason": "retention"}, "value": float(lost)},
            {"labels": {"reason": "truncation"}, "value": float(truncated)},
        ],
    }
    return snap


def _scenario_lag():
    lags = [0, 100, 300, 700, 1500, 3000, 6000, 0, 0, 0, 0, 0]
    return [(t, _snap(lag=v, records=10 * t), None) for t, v in enumerate(lags)]


def _scenario_lag_shrinking():
    lags = [10000, 8000, 6000, 4000, 2000, 500]
    return [(t, _snap(lag=v, records=1000 * t), None) for t, v in enumerate(lags)]


def _scenario_degraded():
    return [(t, _snap(degraded=d), None) for t, d in enumerate([0, 2, 2, 0, 0, 0])]


def _scenario_corruption():
    return [(t, _snap(corrupt=c), None)
            for t, c in enumerate([0, 0, 3, 3, 3, 3, 3, 3, 3, 3])]


def _scenario_outage():
    return [(t, _snap(refresh=r), None)
            for t, r in enumerate([0, 1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4])]


def _scenario_throughput():
    # 100 records/s for 12 s, then a collapse while lag remains.
    out, rec = [], 0.0
    for t in range(24):
        rec += 100.0 if t < 12 else 5.0
        out.append((t, _snap(lag=500, records=rec), None))
    return out


def _scenario_loss():
    return [(t, _snap(lost=lo, truncated=tr, regressions=tr // 10), None)
            for t, (lo, tr) in enumerate(
                [(0, 0), (0, 0), (40, 0), (40, 20), (40, 20), (40, 20)])]


def _scenario_fleet_extras():
    # The fleet-only rules read extras the port's fleet will supply; the
    # code is ported and must answer exactly as the reference does.
    return [
        (0, _snap(), {"topics": {"a": 0, "b": 0}}),
        (1, _snap(), {"topics": {"a": 50, "b": 0}, "failed_topics": ["b"]}),
        (2, _snap(), None),
        (3, _snap(), {"topics": {"a": 80, "b": 0}, "failed_topics": []}),
    ]


SCENARIOS = {
    "lag-growth": _scenario_lag,
    "lag-shrinking": _scenario_lag_shrinking,
    "degraded": _scenario_degraded,
    "corruption-storm": _scenario_corruption,
    "watermark-outage": _scenario_outage,
    "throughput-regression": _scenario_throughput,
    "lost-range-truncation": _scenario_loss,
    "fleet-extras": _scenario_fleet_extras,
}

FAST = dict(eval_interval_s=0.001, for_s=2.0, resolve_s=2.0,
            lag_window_s=2.0, lag_min_growth=10, storm_window_s=4.0,
            outage_window_s=4.0, throughput_window_s=4.0,
            throughput_baseline_s=10.0, retention_s=60.0)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_health_documents_equal_the_reference(name):
    """Tolerance: exact — every document of the script, clock readings
    included (both engines read the same scripted clocks)."""
    clock = {"t": 0.0}
    port = HealthEngine(
        built_in_rules(HealthConfig(**FAST)), cfg=HealthConfig(**FAST),
        clock=lambda: clock["t"], wall_clock=lambda: 1000.0 + clock["t"],
    )
    ref = ref_health.HealthEngine(
        ref_health.built_in_rules(RefHealthConfig(**FAST)),
        cfg=RefHealthConfig(**FAST),
        clock=lambda: clock["t"], wall_clock=lambda: 1000.0 + clock["t"],
    )
    fired = set()
    for t, snap, extras in SCENARIOS[name]():
        clock["t"] = float(t)
        pdoc = port.evaluate(snap, extras)
        rdoc = ref.evaluate(snap, extras)
        assert pdoc == rdoc, t
        fired |= {r["rule"] for r in pdoc["firing"]}
        assert port.healthz_entry() == ref.healthz_entry()
        assert port.alerts_block("a") == ref.alerts_block("a")
    for rule in port.rules:
        for state in (OK, PENDING, FIRING, RESOLVING):
            assert _transitions(rule.name, state) == (
                ref_metrics.ALERTS_TRANSITIONS.labels(
                    rule=rule.name, state=state
                ).value
            ), (rule.name, state)
    # Each scenario exercises the rule it is named after.
    expect = {
        "lag-growth": {"lag-growth"},
        "lag-shrinking": set(),
        "degraded": {"degraded-partitions"},
        "corruption-storm": {"corruption-storm"},
        "watermark-outage": {"watermark-refresh-outage"},
        "throughput-regression": {"throughput-regression"},
        "lost-range-truncation": {"lost-range", "truncation"},
        "fleet-extras": {"fleet-topic-failure"},
    }[name]
    assert expect <= fired or (not expect and not fired)


# ---------------------------------------------------------------------------
# telemetry history: the reference's on-disk format, both ways


def _store(tmp_path, clk, mod=obs_history, **kw):
    kw.setdefault("max_bytes", 1 << 16)
    return mod.HistoryStore(str(tmp_path / "hist"), clock=lambda: clk["t"], **kw)


def test_history_round_trip_and_downsample_exactness(tmp_path):
    clk = {"t": 1000.0}
    s = _store(tmp_path, clk)
    s.register_kinds({"records": "cum", "depth": "inst"})
    for i in range(8):
        clk["t"] = 1000.0 + i
        s.append({"records": i * 100.0, "depth": float(i)})
    w = s.window()
    assert w["t"] == [1000.0 + i for i in range(8)]
    t1 = s.tier_rows(1)
    assert [r[2]["records"] for r in t1] == [100.0, 300.0, 500.0, 700.0]
    assert [r[2]["depth"] for r in t1] == [0.5, 2.5, 4.5, 6.5]
    assert s.window(t0=1002.0, t1=1004.0)["t"] == [1002.0, 1003.0, 1004.0]
    assert track_delta(w, "records") == 700.0
    assert track_rate(w, "records") == pytest.approx(100.0)
    s.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_history_store_is_read_by_the_other_package(tmp_path, writer):
    """A store written by one package (with a restart: two epochs,
    rotated and evicted segments, a severed last line) reopens in either
    package with the same rows: the windows, the priced queries and the
    query bodies agree exactly, and the severed line alone is lost."""
    import shutil

    mods = {"port": obs_history, "ref": ref_history}
    clk = {"t": 2000.0}
    kw = dict(max_bytes=8192, tiers=3)
    s = _store(tmp_path, clk, mods[writer], **kw)
    s.register_kinds({"records": "cum", "depth": "inst"})
    for i in range(300):
        clk["t"] = 2000.0 + i
        s.append({"records": 10.0 * i, "depth": float(i % 7)})
    s.close()
    clk["t"] = 2400.0
    s = _store(tmp_path, clk, mods[writer], **kw)
    for i in range(5):
        clk["t"] = 2400.0 + i
        s.append({"records": 3.0 * i, "depth": 1.0})
    # SIGKILL-shaped: no close, last line severed.
    open_path = os.path.join(str(tmp_path / "hist"), "tier0", "open.jsonl")
    data = open(open_path, "rb").read()
    with open(open_path, "wb") as f:
        f.write(data[:-5])
    shutil.copytree(str(tmp_path / "hist"), str(tmp_path / "copy" / "hist"))
    clk["t"] = 2500.0
    windows = []
    for mod, where in ((obs_history, tmp_path), (ref_history, tmp_path / "copy")):
        r = _store(where, clk, mod, **kw)
        assert r.epoch == 3
        windows.append((r.window(), r.window(max_points=20),
                        r.window_bytes(None, None, None, 20)))
        r.close()
    (pw, pq, (pbody, petag)), (rw, rq, (rbody, retag)) = windows
    assert pw == rw and pq == rq and pbody == rbody and petag == retag
    assert set(pw["epoch"]) == {1, 2}
    assert pw["tracks"]["records"][-1] == 9.0  # 12.0 was severed
    assert pw["kinds"] == {"depth": "inst", "records": "cum"}
    assert track_delta(pw, "records") == ref_history.track_delta(rw, "records")


def test_telemetry_session_history_resumes_across_sessions(tmp_path):
    """``--history-bytes`` wiring: the store opens next to the
    checkpoints, implies the recorder, installs the alert engine, and a
    second session serves the first one's rows with a bumped epoch."""
    from kafka_topic_analyzer_tpu_torch.obs import telemetry_session

    hist = str(tmp_path / "hist")
    with telemetry_session(history_dir=hist, history_bytes=65536):
        rec = obs_flight.active()
        assert rec is not None
        assert obs_health.active() is not None
        obs_metrics.SCAN_RECORDS.inc(10)
        rec.sample_once()
        assert len(obs_history.active().window()["t"]) >= 1
    assert obs_history.active() is None
    assert obs_health.active() is None
    with telemetry_session(history_dir=hist, history_bytes=65536):
        store = obs_history.active()
        w = store.window()
        assert store.epoch == 2 and 1 in w["epoch"]


def test_recorder_feeds_history_and_survives_sink_failure(tmp_path):
    rec = FlightRecorder(interval_s=0.5, clock=lambda: 0.0)
    s = HistoryStore(str(tmp_path / "hist"), clock=lambda: 500.0)
    rec.attach_history(s)
    obs_metrics.SCAN_RECORDS.inc(42)
    rec.sample_once()
    w = s.window()
    assert w["tracks"]["records"] == [42.0]
    assert w["kinds"]["records"] == "cum"
    assert w["kinds"]["dispatch_inflight"] == "inst"

    def boom(values, t=None):
        raise OSError("disk full")

    s.append = boom
    rec.sample_once()  # must not raise
    assert rec._history is None
    assert len(rec.series()["t"]) == 2
    s.close()


# ---------------------------------------------------------------------------
# trend doctor


def _win(t, tracks, epoch=None):
    return {"t": t, "epoch": epoch or [1] * len(t), "tracks": tracks}


TREND_WINDOWS = {
    "droop": _win([0.0, 10.0, 20.0, 30.0, 35.0, 40.0],
                  {"records": [0.0, 1000.0, 2000.0, 3000.0, 3050.0, 3100.0]}),
    "lag-divergence": _win([0.0, 10.0, 20.0, 30.0],
                           {"follow_lag": [100.0, 400.0, 900.0, 2000.0]}),
    "retry-storm": _win([0.0, 10.0, 20.0, 30.0, 35.0, 40.0],
                        {"backoff_sleeps": [0.0, 1.0, 1.0, 2.0, 20.0, 60.0]}),
    "quiet": _win([0.0, 10.0, 20.0, 30.0],
                  {"records": [0.0, 100.0, 200.0, 300.0],
                   "backoff_sleeps": [0.0, 0.0, 0.0, 0.0]}),
    "verify-bound": _win([0.0, 10.0, 20.0, 30.0],
                         {"cache_verify_s": [0.0, 5.0, 10.0, 15.0],
                          "cache_hit_bytes": [0.0, 1e9, 2e9, 3e9]}),
    "epoch-reset": _win([0.0, 10.0, 20.0, 30.0, 40.0, 50.0],
                        {"records": [0.0, 1000.0, 2000.0, 0.0, 1000.0, 2000.0]},
                        epoch=[1, 1, 1, 2, 2, 2]),
    "fetch-bound": _win([0.0, 10.0, 20.0, 30.0],
                        {"fetch_sched_wait_s": [0.0, 5.0, 10.0, 15.0],
                         "fetch_sched_queue": [8.0, 9.0, 8.0, 9.0],
                         "fetch_sched_inflight": [2.0, 2.0, 2.0, 2.0]}),
}


@pytest.mark.parametrize("name", sorted(TREND_WINDOWS))
def test_trend_findings_equal_the_reference(name):
    """Tolerance: exact (same findings, summaries and evidence)."""
    w = TREND_WINDOWS[name]
    found = doctor.diagnose_trends(w)
    assert found == ref_doctor.diagnose_trends(w)
    kinds = {f["kind"] for f in found}
    assert (name in kinds) if name not in ("quiet", "epoch-reset", "droop") \
        else (kinds == ({"throughput-droop"} if name == "droop" else set()))


# ---------------------------------------------------------------------------
# the engine inside a follow service: a lag-divergence fault flips
# /healthz to 503 within polls and heals back to 200; a dead broker
# raises the watermark-refresh-outage alert


class _DivergingSource:
    """A topic whose head runs away while stalled: polls see a growing
    end offset but no record is served, so the cursor cannot advance.
    Healing serves the real synthetic records and pins the head."""

    def __init__(self, inner):
        self.inner = inner
        self.stalled = True
        self._head = dict(inner.watermarks()[1])

    def partitions(self):
        return self.inner.partitions()

    def is_empty(self):
        return False

    def watermarks(self):
        return self.inner.watermarks()[0], dict(self._head)

    def refresh_watermarks(self):
        if self.stalled:
            for p in self._head:
                self._head[p] += 50
        else:
            self._head = dict(self.inner.watermarks()[1])
        return self.watermarks()

    def batches(self, batch_size, partitions=None, start_at=None):
        if self.stalled:
            return iter(())
        return self.inner.batches(batch_size, partitions=partitions,
                                  start_at=start_at)


def _wait(pred, what, deadline_s=20.0):
    import time

    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _follow_with(src, engine, topic, steer):
    import threading

    from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, FollowConfig
    from kafka_topic_analyzer_tpu_torch.serve.follow import FollowService

    svc = FollowService(
        topic, src,
        CpuExactBackend(AnalyzerConfig(num_partitions=2, batch_size=64),
                        init_now_s=10**10),
        64, FollowConfig(poll_interval_s=0.02, idle_backoff_max_s=0.04,
                         window_count=0),
        health=engine,
    )
    errors = []

    def run_steer():
        try:
            steer(svc)
        except BaseException as e:  # surfaced after the join
            errors.append(e)
        finally:
            svc.request_stop("test")

    t = threading.Thread(target=run_steer)
    t.start()
    result = svc.run()
    t.join(timeout=60)
    if errors:
        raise errors[0]
    return result, svc


def test_follow_lag_divergence_flips_healthz_and_heals(event_log):
    import json
    import urllib.error
    import urllib.request

    from kafka_topic_analyzer_tpu_torch.io.synthetic import (
        SyntheticSource,
        SyntheticSpec,
    )
    from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter
    from kafka_topic_analyzer_tpu_torch.serve import state as serve_state

    src = _DivergingSource(SyntheticSource(SyntheticSpec(
        num_partitions=2, messages_per_partition=100, keys_per_partition=20)))
    cfg = HealthConfig(**dict(FAST, for_s=0.05, resolve_s=0.05,
                              lag_window_s=0.08, lag_min_growth=1))
    engine = HealthEngine(built_in_rules(cfg), cfg=cfg)
    exporter = PrometheusExporter(0)

    def probe():
        url = f"http://127.0.0.1:{exporter.port}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def steer(svc):
        _wait(lambda: probe()[0] == 503 and any(
            r["rule"] == "lag-growth" for r in probe()[1]["firing"]),
            "/healthz 503 on lag divergence")
        src.stalled = False
        _wait(lambda: probe()[0] == 200, "/healthz 200 after heal and resolve")

    try:
        result, svc = _follow_with(src, engine, "diverge.topic", steer)
    finally:
        exporter.close()
        serve_state.set_active(None)
    assert result.metrics.overall_count == 200
    fired = [f for e, f in event_log if e == "alert_firing"]
    resolved = [f for e, f in event_log if e == "alert_resolved"]
    assert any(f["rule"] == "lag-growth" for f in fired)
    assert any(f["rule"] == "lag-growth" for f in resolved)
    doc = svc.state.snapshot()
    assert doc["health"]["healthy"]


def test_follow_watermark_outage_alert():
    from fake_broker import FakeBroker
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
    from kafka_topic_analyzer_tpu_torch.serve import state as serve_state

    records = {p: [(i, 1_600_000_000_000 + i, f"k{i}".encode(), b"v" * 10)
                   for i in range(40)] for p in range(2)}
    cfg = HealthConfig(**dict(FAST, for_s=0.05, resolve_s=0.05,
                              outage_window_s=30.0))
    engine = HealthEngine(built_in_rules(cfg), cfg=cfg)
    broker = FakeBroker("outage.topic", records).start()
    src = KafkaWireSource(
        f"127.0.0.1:{broker.port}", "outage.topic",
        overrides={"retry.backoff.ms": "2", "reconnect.backoff.max.ms": "8",
                   "transport.retry.budget": "2"},
    )

    def steer(svc):
        _wait(lambda: engine.doc() is not None and svc.passes >= 1,
              "the first pass")
        broker.kill()  # every re-poll now exhausts its budget
        _wait(lambda: any(r["rule"] == "watermark-refresh-outage"
                          for r in (engine.doc() or {}).get("firing", [])),
              "the watermark outage alert")

    try:
        result, _ = _follow_with(src, engine, "outage.topic", steer)
    finally:
        src.close()
        broker.stop()
        serve_state.set_active(None)
    assert result.metrics.overall_count == 80
    assert obs_metrics.WATERMARK_REFRESH_FAILURES.value >= 1
