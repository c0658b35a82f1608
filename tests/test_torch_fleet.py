"""The port's fleet mode (``fleet/`` package, ``cli.run_fleet``) against
the reference's, on the same numpy-seeded `FakeBroker` clusters: the
reference's fleet runs its JAX backend on the CPU, the port's runs
``TorchBackend(device="cpu")``.

Tolerance: exact.  Discovery lists and filters, every scheduler decision
of seeded admit/release/rebalance sequences, each topic's ``to_dict``
document of a batch fleet (swept over workers x superbatch), the status
table and the ``--fleet --json`` document (bar the clock fields:
durations, the doctor's timing-driven verdicts, telemetry, the ``flight``
and ``wire`` digests, whose byte counts read process-wide counters that
concurrent topics share), checkpoints written by one package's fleet
follow and resumed by the other's, ``/report.json`` rollup and
``?topic=`` documents.  One ``cuda`` test runs two backends on two
streams in two threads against a serial run; it skips without a card.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fake_broker import CorruptionInjector, FakeBroker
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefAnalyzerConfig
from kafka_topic_analyzer_tpu.config import DispatchConfig as RefDispatchConfig
from kafka_topic_analyzer_tpu.config import FollowConfig as RefFollowConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.fleet import discovery as ref_discovery
from kafka_topic_analyzer_tpu.fleet.scheduler import FleetScheduler as RefScheduler
from kafka_topic_analyzer_tpu.fleet.scheduler import TopicSeed as RefSeed
from kafka_topic_analyzer_tpu.fleet.service import FleetService as RefFleetService
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefSource
from kafka_topic_analyzer_tpu.io.kafka_wire import (
    discover_cluster_topics as ref_discover_cluster_topics,
)
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu.report import render_fleet_status as ref_render_status
from kafka_topic_analyzer_tpu.serve import state as ref_serve_state
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.checkpoint import list_topic_snapshots
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    DispatchConfig,
    FollowConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.fleet.discovery import (
    DiscoveredTopic,
    discover_topics,
    filter_topics,
    parse_globs,
)
from kafka_topic_analyzer_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    TopicSeed,
)
from kafka_topic_analyzer_tpu_torch.fleet.service import FleetService
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import (
    KafkaWireSource,
    discover_cluster_topics,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.report import render_fleet_status
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state

pytestmark = pytest.mark.fleet

TOPICS = ["fleet.a", "fleet.b", "fleet.c"]
N_PARTS = 4
PHASE1_N = 60
PHASE2_N = 30
FULL_N = PHASE1_N + PHASE2_N
FAST_RETRY = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}
FAST = "retry.backoff.ms=5,reconnect.backoff.max.ms=40"
FAST_FOLLOW = dict(poll_interval_s=0.02, idle_backoff_max_s=0.05)
CFG = dict(
    batch_size=64, count_alive_keys=True, alive_bitmap_bits=16,
    enable_hll=True, hll_p=8, enable_quantiles=True,
    quantiles_per_partition=True,
)


def _mk_records(salt: int, partition: int, lo: int, n: int):
    """Records made from a numpy generator seeded by (salt, partition):
    keys of 17 per partition (one in five null), values 15-25 B (one in
    seven a tombstone)."""
    rng = np.random.default_rng([salt, partition])
    sizes = rng.integers(15, 26, size=lo + n)
    out = []
    for i in range(lo, lo + n):
        key = f"k{salt}-{partition}-{i % 17}".encode() if i % 5 else None
        value = bytes(int(sizes[i])) if i % 7 else None
        out.append((i, 1_600_000_000_000 + i * 1000, key, value))
    return out


def _topic_records(salt: int, n: int, lo: int = 0):
    return {p: _mk_records(salt, p, lo, n) for p in range(N_PARTS)}


FULL = {t: _topic_records(i, FULL_N) for i, t in enumerate(TOPICS)}
PHASE1 = {t: _topic_records(i, PHASE1_N) for i, t in enumerate(TOPICS)}
INTERNAL = {"__consumer_offsets": {0: _mk_records(99, 0, 0, 5)}}


def _mk_broker(records_by_topic, **kw):
    names = list(records_by_topic)
    return FakeBroker(
        names[0], records_by_topic[names[0]],
        extra_topics={t: records_by_topic[t] for t in names[1:]},
        internal_topics=dict(INTERNAL), max_records_per_fetch=48, **kw,
    )


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()
    serve_state.set_active(None)
    ref_serve_state.set_active(None)


def _doc(result) -> dict:
    return result.metrics.to_dict(result.start_offsets, result.end_offsets)


def _port_backend(parts=N_PARTS, superbatch=1, depth=2):
    return TorchBackend(
        AnalyzerConfig(num_partitions=parts, **CFG), init_now_s=10**10,
        device="cpu", dispatch=DispatchConfig(superbatch=superbatch, depth=depth),
    )


def _ref_backend(parts=N_PARTS, superbatch=1, depth=2):
    return TpuBackend(
        RefAnalyzerConfig(num_partitions=parts, **CFG),
        dispatch=RefDispatchConfig(superbatch=superbatch, depth=depth),
        init_now_s=10**10,
    )


def _fleet(pkg, broker, topics=TOPICS, worker_budget=3, dispatch_budget=3,
           max_concurrent=3, superbatch=1, follow=None, **kw):
    """A fleet service of ``pkg`` ("port" or "ref") over ``broker``."""
    port = pkg == "port"
    sched = (FleetScheduler if port else RefScheduler)(
        worker_budget, dispatch_budget, max_concurrent
    )
    source_cls = KafkaWireSource if port else RefSource
    backend = _port_backend if port else _ref_backend

    def source_factory(topic):
        return source_cls(f"127.0.0.1:{broker.port}", topic,
                          overrides=dict(FAST_RETRY))

    def backend_factory(topic, parts, grant):
        return backend(parts, superbatch, grant.dispatch_depth)

    seeds = [(TopicSeed if port else RefSeed)(name=t, partitions=N_PARTS)
             for t in topics]
    follow_cls = FollowConfig if port else RefFollowConfig
    return (FleetService if port else RefFleetService)(
        seeds, source_factory, backend_factory, 64, sched,
        follow=follow_cls(**follow) if follow is not None else None, **kw,
    )


def _wait_for(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def solo():
    """Solo scans of each topic: the reference's and the port's documents
    (equal, or nothing else here could be)."""
    docs = {}
    with _mk_broker(FULL) as broker:
        for topic in TOPICS:
            src = RefSource(f"127.0.0.1:{broker.port}", topic,
                            overrides=dict(FAST_RETRY))
            ref = _doc(ref_run_scan(topic, src, _ref_backend(), 64))
            src.close()
            src = KafkaWireSource(f"127.0.0.1:{broker.port}", topic,
                                  overrides=dict(FAST_RETRY))
            port = _doc(run_scan(topic, src, _port_backend(), 64))
            src.close()
            assert port == ref, topic
            docs[topic] = port
    return docs


# ---------------------------------------------------------------------------
# discovery


def test_discover_cluster_topics_equals_the_reference():
    with _mk_broker(FULL) as broker:
        port = discover_cluster_topics(f"127.0.0.1:{broker.port}")
        ref = ref_discover_cluster_topics(f"127.0.0.1:{broker.port}")
    key = lambda mds: sorted(  # noqa: E731
        (t.name, t.error, int(t.is_internal), len(t.partitions)) for t in mds
    )
    assert key(port) == key(ref)
    assert {t.name for t in port} == set(TOPICS) | {"__consumer_offsets"}
    assert obs_metrics.FLEET_TOPICS_DISCOVERED.value == len(TOPICS) + 1


@pytest.mark.parametrize("kw", [
    {},
    {"include": ["*.a"]},
    {"include": ["fleet.*"], "exclude": ["*.b"]},
    {"include_internal": True},
    {"include": ["nothing.*"]},
], ids=["default", "include", "include-exclude", "internal", "no-match"])
def test_discovery_filters_equal_the_reference(kw):
    with _mk_broker(FULL) as broker:
        bootstrap = f"127.0.0.1:{broker.port}"
        port = discover_topics(bootstrap, **kw)
        ref = ref_discovery.discover_topics(bootstrap, **kw)
    assert [(d.name, d.partitions, d.internal) for d in port] == [
        (d.name, d.partitions, d.internal) for d in ref
    ]
    if not kw:
        assert [d.name for d in port] == sorted(TOPICS)


def test_discovery_sees_topics_created_mid_run():
    with _mk_broker(FULL) as broker:
        bootstrap = f"127.0.0.1:{broker.port}"
        broker.create_topic("fleet.new", {0: _mk_records(7, 0, 0, 10)})
        broker.create_topic("__txn_state", {0: _mk_records(8, 0, 0, 3)},
                            internal=True)
        names = [d.name for d in discover_topics(bootstrap)]
        assert names == [d.name for d in ref_discovery.discover_topics(bootstrap)]
    assert names == sorted(TOPICS + ["fleet.new"])


def test_filter_topics_and_globs_equal_the_reference():
    rows = [("orders", 4, False), ("orders.dlq", 1, False), ("users", 2, False),
            ("__consumer_offsets", 50, True), ("__unflagged_system", 1, True)]
    port = [DiscoveredTopic(*r) for r in rows]
    ref = [ref_discovery.DiscoveredTopic(*r) for r in rows]
    for kw in ({}, {"include": ["orders*"]},
               {"include": ["orders*"], "exclude": ["*.dlq"]},
               {"include_internal": True}, {"include": []}):
        assert [t.name for t in filter_topics(port, **kw)] == [
            t.name for t in ref_discovery.filter_topics(ref, **kw)
        ], kw
    assert filter_topics([]) == []
    for spec in (" a , b ,", None, "", "x"):
        assert parse_globs(spec) == ref_discovery.parse_globs(spec)
    assert [t.name for t in filter_topics(port)] == ["orders", "orders.dlq", "users"]


# ---------------------------------------------------------------------------
# the admission scheduler


def _invariants(sched, partitions):
    assert sched.workers_granted <= sched.worker_budget
    assert sched.dispatch_granted <= sched.dispatch_budget
    assert sched.active <= sched.max_concurrent
    for t, g in sched.grants().items():
        assert g.workers >= 1 and g.dispatch_depth >= 1
        assert g.workers <= max(1, partitions[t])


def _ops(seed: int, n_ops: int = 40):
    """A seeded admit/release/rebalance script: (budgets, partitions,
    [(op, argument)])."""
    rng = random.Random(seed)
    budgets = (rng.randint(1, 16), rng.randint(1, 8), rng.randint(1, 6))
    partitions = {f"t{i}": rng.randint(1, 12) for i in range(rng.randint(1, 10))}
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            ops.append(("admit", [
                (t, partitions[t], rng.randint(0, 1000))
                for t in rng.sample(sorted(partitions),
                                    rng.randint(1, len(partitions)))
            ]))
        elif r < 0.7:
            ops.append(("release", rng.random()))
        else:
            ops.append(("rebalance", {
                t: rng.choice(["ingest-bound", "dispatch-bound", "balanced"])
                for t in sorted(partitions)
            }))
    return budgets, partitions, ops


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_scheduler_budget_conservation_property(seed):
    """Granted workers and dispatch tokens stay within the budgets, every
    grant keeps >= 1 of each and workers stay within the partition count,
    at every point of any admit/release/rebalance sequence."""
    (wb, db, mc), partitions, ops = _ops(seed)
    sched = FleetScheduler(wb, db, mc)
    for op, arg in ops:
        if op == "admit":
            sched.admit([TopicSeed(t, p, lag=lag) for t, p, lag in arg])
        elif op == "release":
            grants = sorted(sched.grants())
            if grants:
                sched.release(grants[int(arg * len(grants))])
        else:
            sched.rebalance({t: v for t, v in arg.items() if t in sched.grants()})
        _invariants(sched, partitions)


@pytest.mark.parametrize("seed", range(12))
def test_scheduler_decisions_equal_the_reference(seed):
    """The same admit/release/rebalance script through both schedulers:
    every return value, every grant table and every booked admission are
    equal after every step."""
    (wb, db, mc), partitions, ops = _ops(seed)
    port, ref = FleetScheduler(wb, db, mc), RefScheduler(wb, db, mc)
    grants = lambda s: {t: (g.workers, g.dispatch_depth)  # noqa: E731
                        for t, g in s.grants().items()}
    for op, arg in ops:
        if op == "admit":
            got = port.admit([TopicSeed(t, p, lag=lag) for t, p, lag in arg])
            want = ref.admit([RefSeed(t, p, lag=lag) for t, p, lag in arg])
            assert {t: (g.workers, g.dispatch_depth) for t, g in got.items()} == {
                t: (g.workers, g.dispatch_depth) for t, g in want.items()}
        elif op == "release":
            names = sorted(port.grants())
            if names:
                name = names[int(arg * len(names))]
                port.release(name)
                ref.release(name)
        else:
            assert port.rebalance(dict(arg)) == ref.rebalance(dict(arg))
        assert grants(port) == grants(ref)
    from kafka_topic_analyzer_tpu.obs import metrics as ref_metrics

    for reason in ("admitted-poll", "deferred-budget", "released"):
        assert obs_metrics.FLEET_ADMISSIONS.labels(
            reason=reason, instance="solo").value == ref_metrics.FLEET_ADMISSIONS.labels(
            reason=reason, instance="solo").value, reason


@pytest.mark.parametrize("mc", [1, 2, 3, 5])
def test_plan_waves_equal_the_reference(mc):
    rng = random.Random(mc)
    rows = [(f"t{i}", rng.randint(1, 8), rng.choice([0, rng.randint(1, 500)]))
            for i in range(9)]
    port = FleetScheduler(8, 4, mc).plan_waves([TopicSeed(*r) for r in rows])
    ref = RefScheduler(8, 4, mc).plan_waves([RefSeed(*r) for r in rows])
    assert port == ref
    assert sorted(t for w in port for t in w) == sorted(r[0] for r in rows)
    assert all(len(w) <= mc for w in port)
    assert FleetScheduler(8, 4, mc).plan_waves([]) == []


def test_rebalance_rule():
    sched = FleetScheduler(worker_budget=6, dispatch_budget=4, max_concurrent=2)
    sched.admit([TopicSeed("a", 8, lag=100), TopicSeed("b", 8, lag=90)])
    ga, gb = sched.grant_for("a"), sched.grant_for("b")
    assert sched.rebalance({"a": "dispatch-bound", "b": "ingest-bound"}) > 0
    assert sched.grant_for("a").workers < ga.workers
    assert sched.grant_for("b").dispatch_depth == 1
    assert sched.grant_for("b").workers > gb.workers
    assert sched.rebalance({"a": "balanced", "b": "balanced"}) == 0
    assert obs_metrics.FLEET_REBALANCES.labels(instance="solo").value > 0


# ---------------------------------------------------------------------------
# batch fleets against the reference's


@pytest.mark.parametrize("workers,superbatch", [(1, 1), (4, 1), (1, 4), (4, 4)])
def test_fleet_batch_equals_the_reference(solo, workers, superbatch):
    kw = dict(worker_budget=workers * len(TOPICS),
              dispatch_budget=2 * len(TOPICS), superbatch=superbatch)
    with _mk_broker(FULL) as broker:
        port = _fleet("port", broker, **kw).run_batch()
        ref = _fleet("ref", broker, **kw).run_batch()
    assert set(port.results) == set(ref.results) == set(TOPICS)
    for topic in TOPICS:
        assert port.statuses[topic].status == "ok"
        assert _doc(port.results[topic]) == _doc(ref.results[topic]) == solo[topic]
        assert port.results[topic].ingest_workers == ref.results[topic].ingest_workers
        assert port.results[topic].ingest_workers == min(workers, N_PARTS)
    drop = ("verdict",)
    strip = lambda doc: {t: {k: v for k, v in s.items() if k not in drop}  # noqa: E731
                         for t, s in doc["fleet"]["statuses"].items()}
    assert strip(port.rollup) == strip(ref.rollup)
    assert port.rollup["fleet"]["totals"] == ref.rollup["fleet"]["totals"]
    assert port.rollup["fleet"]["top_topics"] == ref.rollup["fleet"]["top_topics"]


def test_fleet_under_tight_dispatch_budget_scans_every_topic(solo):
    with _mk_broker(FULL) as broker:
        fr = _fleet("port", broker, worker_budget=6, dispatch_budget=1).run_batch()
    assert set(fr.results) == set(TOPICS)
    for topic in TOPICS:
        assert _doc(fr.results[topic]) == solo[topic]


def test_one_poisoned_topic_is_isolated(solo):
    corruption = CorruptionInjector().corrupt_length(partition=0, chunk=0)
    with _mk_broker(FULL, corruption=corruption) as broker:
        fr = _fleet("port", broker).run_batch()
        ref = _fleet("ref", broker).run_batch()
    assert fr.statuses["fleet.a"].status == ref.statuses["fleet.a"].status == "failed"
    assert fr.statuses["fleet.a"].error == ref.statuses["fleet.a"].error
    assert fr.any_failed and cli.fleet_exit(fr) == 1
    for topic in ("fleet.b", "fleet.c"):
        assert fr.statuses[topic].status == "ok"
        assert _doc(fr.results[topic]) == solo[topic]
    assert fr.rollup["fleet"]["status_counts"] == {"failed": 1, "ok": 2}
    table = render_fleet_status(fr.rollup)
    assert "FAILED" in table and "unaffected" in table
    assert table == ref_render_status(fr.rollup)


def test_empty_topic_is_a_status_row():
    records = dict(FULL)
    records["fleet.empty"] = {p: [] for p in range(N_PARTS)}
    with _mk_broker(records) as broker:
        fr = _fleet("port", broker, topics=TOPICS + ["fleet.empty"]).run_batch()
    assert fr.statuses["fleet.empty"].status == "empty"
    assert "fleet.empty" not in fr.results
    assert all(fr.statuses[t].status == "ok" for t in TOPICS)
    assert obs_metrics.FLEET_ADMISSIONS.labels(
        reason="skipped-empty", instance="solo").value == 1


def test_fleet_admissions_are_booked():
    with _mk_broker(FULL) as broker:
        _fleet("port", broker).run_batch()
    for reason in ("admitted-seed", "released"):
        assert obs_metrics.FLEET_ADMISSIONS.labels(
            reason=reason, instance="solo").value == len(TOPICS)


# ---------------------------------------------------------------------------
# fleet follow: SIGTERM → per-topic checkpoints → resume in either package


@pytest.mark.parametrize("first,second", [("port", "ref"), ("ref", "port")])
def test_fleet_follow_checkpoints_resume_across_packages(tmp_path, solo, first, second):
    snap = str(tmp_path / "snaps")
    follow = dict(FAST_FOLLOW, checkpoint_every_s=0.0)
    phase1 = N_PARTS * PHASE1_N

    def published(svc, topic):
        doc = svc.state.snapshot(topic)
        return doc["overall"]["count"] if doc else -1

    with _mk_broker(PHASE1) as broker:
        svc = _fleet(first, broker, follow=follow, snapshot_dir=snap)
        restore = svc.install_signal_handlers()
        try:
            killer = threading.Thread(target=lambda: (
                _wait_for(lambda: all(published(svc, t) >= phase1 for t in TOPICS),
                          what="phase-1 fleet reports"),
                os.kill(os.getpid(), signal.SIGTERM),
            ))
            killer.start()
            fr1 = svc.run_follow()
            killer.join()
        finally:
            restore()
    assert svc._stop_reason == "SIGTERM"
    inventory = list_topic_snapshots(snap)
    assert set(inventory) == set(TOPICS)
    for t in TOPICS:
        assert fr1.results[t].metrics.overall_count == phase1
        assert inventory[t]["records_seen"] == phase1
        assert os.path.exists(os.path.join(snap, t, "scan_snapshot.npz"))
    with _mk_broker(FULL) as broker:
        svc2 = _fleet(second, broker, follow=follow, snapshot_dir=snap, resume=True)
        stopper = threading.Thread(target=lambda: (
            _wait_for(lambda: all(published(svc2, t) >= N_PARTS * FULL_N
                                  for t in TOPICS), what="resumed fleet reports"),
            svc2.request_stop("test"),
        ))
        stopper.start()
        fr2 = svc2.run_follow()
        stopper.join()
    for t in TOPICS:
        assert _doc(fr2.results[t]) == solo[t]  # no loss, no double count


def test_fleet_follow_rediscovers_a_created_topic():
    with _mk_broker(PHASE1) as broker:
        bootstrap = f"127.0.0.1:{broker.port}"

        def rediscover():
            return [TopicSeed(name=d.name, partitions=d.partitions)
                    for d in discover_topics(bootstrap)]

        svc = _fleet("port", broker, follow=FAST_FOLLOW, rediscover=rediscover,
                     rediscover_every=2)

        def steer():
            _wait_for(lambda: svc.state.snapshot("fleet.a") is not None,
                      what="initial fleet report")
            broker.create_topic("fleet.created", {0: _mk_records(42, 0, 0, 20)})
            _wait_for(lambda: (svc.state.snapshot("fleet.created") or {}).get(
                "overall", {}).get("count", 0) >= 20, what="created-topic report")
            svc.request_stop("test")

        t = threading.Thread(target=steer)
        t.start()
        fr = svc.run_follow()
        t.join()
    assert fr.results["fleet.created"].metrics.overall_count == 20
    assert fr.statuses["fleet.created"].status == "ok"


def test_fleet_follow_stops_when_every_topic_failed():
    def dead_source(topic):
        raise OSError("connection refused")

    svc = FleetService(
        [TopicSeed(name=t, partitions=1) for t in ("a", "b")], dead_source,
        lambda t, parts, grant: None, 64, FleetScheduler(2, 2, 2),
        follow=FollowConfig(**FAST_FOLLOW),
    )
    t0 = time.monotonic()
    fr = svc.run_follow()
    assert time.monotonic() - t0 < 10.0
    assert svc._stop_reason == "all-failed"
    assert all(s.status == "failed" for s in fr.statuses.values())
    assert fr.results == {}


def test_poll_failure_releases_a_held_grant():
    class _BoomSource:
        def partitions(self):
            return [0]

        def refresh_watermarks(self):
            raise OSError("broker gone")

    scheduler = FleetScheduler(2, 2, 2)
    svc = FleetService([TopicSeed("t", 1)], lambda t: _BoomSource(),
                       lambda *a: None, 64, scheduler,
                       follow=FollowConfig(**FAST_FOLLOW))
    scheduler.admit([TopicSeed("t", 1, lag=5)])
    assert svc._poll_topic(svc.scans["t"]) == 0
    assert svc.scans["t"].status.status == "failed"
    assert scheduler.active == 0 and scheduler.workers_granted == 0


# ---------------------------------------------------------------------------
# /report.json: the rollup and ?topic= routing


def test_report_json_serves_the_rollup_and_each_topic(solo):
    from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter

    exporter = PrometheusExporter(0)
    base = f"http://127.0.0.1:{exporter.port}/report.json"
    try:
        serve_state.set_active(None)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base, timeout=5)
        assert exc.value.code == 404
        with _mk_broker(FULL) as broker:
            svc = _fleet("port", broker)
            serve_state.set_active(svc.state)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base, timeout=5)
            assert exc.value.code == 503  # nothing published yet
            fr = svc.run_batch()
        with urllib.request.urlopen(base, timeout=5) as resp:
            rollup = json.loads(resp.read())
        assert rollup["fleet"]["topics"] == len(TOPICS)
        assert rollup["fleet"]["totals"] == fr.rollup["fleet"]["totals"]
        for topic in TOPICS:
            with urllib.request.urlopen(f"{base}?topic={topic}", timeout=5) as resp:
                doc = json.loads(resp.read())
            assert doc["topic"] == topic
            assert doc["overall"] == solo[topic]["overall"]
            assert doc["partitions"] == solo[topic]["partitions"]
            assert doc["fleet"]["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "?topic=nope", timeout=5)
        assert exc.value.code == 404
    finally:
        serve_state.set_active(None)
        exporter.close()


# ---------------------------------------------------------------------------
# the CLI against the reference CLI

#: Per-topic document keys whose values are clock readings or read
#: process-wide counters that concurrent topics share.
CLOCKED = ("duration_secs", "telemetry", "flight", "wire")


def _both(argv, capsys, port_extra=("--device", "cpu"), ref_extra=("--backend", "tpu")):
    out = []
    for main, extra in ((cli.main, port_extra), (ref_cli.main, ref_extra)):
        default_registry().reset()
        ref_registry().reset()
        rc = main([*argv, *extra])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def _unclocked_rollup(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    doc.pop("duration_secs", None)
    doc["fleet"].pop("verdict_counts", None)
    for s in doc["fleet"]["statuses"].values():
        s.pop("verdict", None)
    for tdoc in doc.get("topics", {}).values():
        for key in CLOCKED:
            tdoc.pop(key, None)
        tdoc["fleet"].pop("verdict", None)
    return doc


def _unclocked_table(text: str) -> str:
    """The status table without its verdict column (the doctor's verdict
    reads stage timings), its cells and its rules' last segment alike
    (the column's width is the verdict's)."""
    out = []
    for line in text.splitlines():
        sep = "+" if line.startswith("+") else "|"
        cells = line.split(sep)
        out.append(sep.join(cells[:-2]) if len(cells) > 3 else line)
    return "\n".join(out)


@pytest.mark.parametrize("flags", [
    ["-c", "--distinct-keys"],
    ["-c", "--ingest-workers", "6", "--superbatch", "2", "--fleet-concurrency", "2"],
    ["--quantiles-per-partition", "--wire-format", "v4", "--batch-size", "1024"],
], ids=["sketches", "workers-superbatch", "v4"])
def test_cli_fleet_json_equals_the_reference(flags, capsys, solo):
    with _mk_broker(FULL) as broker:
        (prc, pout, perr), (rrc, rout, rerr) = _both(
            ["-t", "*", "--fleet", "-b", f"127.0.0.1:{broker.port}",
             "--librdkafka", FAST, "--json", "--quiet", *flags], capsys)
    assert prc == rrc == 0
    port, ref = json.loads(pout), json.loads(rout)
    assert set(port["topics"]) == set(TOPICS)  # internal excluded
    assert _unclocked_rollup(port) == _unclocked_rollup(ref)
    assert perr.splitlines()[:2] == rerr.splitlines()[:2]  # the banners
    for topic in TOPICS:
        assert port["topics"][topic]["overall"]["count"] == solo[topic]["overall"]["count"]


def test_cli_fleet_report_and_status_table_equal_the_reference(capsys):
    with _mk_broker(FULL) as broker:
        (prc, pout, perr), (rrc, rout, rerr) = _both(
            ["-t", "fleet.*", "--fleet", "--fleet-exclude", "*.c",
             "-b", f"127.0.0.1:{broker.port}", "--librdkafka", FAST,
             "-c", "--quiet", "--stats"], capsys)
    assert prc == rrc == 0
    timed = ("Scanning took", "Estimated Msg")
    lines = lambda t: "\n".join(  # noqa: E731
        l for l in t.splitlines() if not any(x in l for x in timed))
    assert _unclocked_table(lines(pout)) == _unclocked_table(lines(rout))
    assert "fleet.c" not in pout and "Topic" in pout
    assert pout.count("FLEET: 2 topic(s) (of 2 discovered)") == 1
    # --stats writes the same table to stderr.
    table = pout[pout.index("=" * 120 + "\nFLEET"):]
    assert _unclocked_table(table) in _unclocked_table(perr)


def test_cli_multi_topic_follow_runs_through_the_fleet(capsys):
    with _mk_broker(FULL) as broker:
        (prc, pout, _), (rrc, rout, _) = _both(
            ["-t", "fleet.a,fleet.b", "-b", f"127.0.0.1:{broker.port}",
             "--librdkafka", FAST, "--follow", "--follow-idle-exit", "0.2",
             "--poll-interval", "0.02", "--json", "--quiet"], capsys)
    assert prc == rrc == 0
    port, ref = json.loads(pout), json.loads(rout)
    assert set(port["fleet"]["statuses"]) == {"fleet.a", "fleet.b"}
    for topic in ("fleet.a", "fleet.b"):
        assert port["topics"][topic]["overall"] == ref["topics"][topic]["overall"]
        assert port["topics"][topic]["overall"]["count"] == N_PARTS * FULL_N


@pytest.mark.parametrize("argv,needle", [
    (["--fleet", "--mesh", "2"], "--fleet does not support --mesh"),
    (["--fleet", "--source", "synthetic"], "--fleet requires --source kafka"),
    (["--fleet", "--dump-segments", "d"], "--fleet does not support --dump-segments"),
    (["--fleet", "--from-timestamp", "0"], "--fleet does not support --from-timestamp"),
    (["--fleet", "--fleet-concurrency", "0"], "--fleet-concurrency must be >= 1"),
    (["--follow", "--source", "synthetic"], "--fleet requires --source kafka"),
], ids=["mesh", "source", "dump", "from-timestamp", "concurrency", "list-follow"])
def test_cli_fleet_refusals_equal_the_reference(argv, needle, capsys):
    (prc, pout, perr), (rrc, rout, rerr) = _both(
        ["-t", "a,b" if "--follow" in argv else "*", "-b", "127.0.0.1:1", *argv],
        capsys)
    assert prc == rrc == 1 and pout == rout == ""
    assert needle in perr
    assert perr == rerr  # the reference's message, verbatim


def test_dispatch_depth_bounds_the_fleet_under_the_default_backend(capsys):
    """The port's default backend is the torch backend (``gpu``): its
    --dispatch-depth is the fleet's global in-flight budget, as under the
    reference's ``tpu``; the oracle's budget is the concurrency."""
    with _mk_broker(FULL) as broker:
        args = ["-t", "*", "--fleet", "-b", f"127.0.0.1:{broker.port}",
                "--librdkafka", FAST, "--quiet", "--json", "--dispatch-depth", "5",
                "--ingest-workers", "3", "--device", "cpu"]
        rc = cli.main(args)
        err = capsys.readouterr().err
        assert rc == 0 and "dispatch budget 5, concurrency 3" in err
        rc = cli.main(args + ["--dispatch-depth", "1"])
        out, err = capsys.readouterr()
        assert rc == 0 and "dispatch budget 1, concurrency 3" in err
        # One token: the three topics ran one after the other, each at
        # depth 1, and every topic was still scanned.
        doc = json.loads(out)
        assert set(doc["topics"]) == set(TOPICS)
        assert all(d["dispatch_depth"] == 1 for d in doc["topics"].values())
        assert obs_metrics.FLEET_ADMISSIONS.labels(
            reason="deferred-budget", instance="solo").value >= 2
        rc = cli.main(args + ["--backend", "cpu"])
        err = capsys.readouterr().err
        assert rc == 0 and "dispatch budget 3, concurrency 3" in err


def test_set_dispatch_depth_clamps_at_the_constructed_depth():
    backend = _port_backend(superbatch=2, depth=3)
    assert backend.dispatch_depth == 3
    backend.set_dispatch_depth(1)
    assert backend.dispatch_depth == backend._queue.depth == 1
    backend.set_dispatch_depth(8)  # grows clamp at construction
    assert backend.dispatch_depth == backend._queue.depth == 3
    backend.set_dispatch_depth(0)
    assert backend.dispatch_depth == 1
    ref = _ref_backend(superbatch=2, depth=3)
    for d in (1, 8, 0, 2):
        backend.set_dispatch_depth(d)
        ref.set_dispatch_depth(d)
        assert backend.dispatch_depth == ref.dispatch_depth
    from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend

    oracle = CpuExactBackend(AnalyzerConfig(num_partitions=N_PARTS, **CFG))
    oracle.set_dispatch_depth(4)  # no dispatch queue: nothing to bound
    assert oracle.dispatch_depth == 1


def test_backend_refuses_a_stream_off_its_device():
    with pytest.raises(ValueError, match="CUDA stream"):
        TorchBackend(AnalyzerConfig(num_partitions=1, **CFG), device="cpu",
                     pooled_stream=True)


# ---------------------------------------------------------------------------
# on the card: concurrent backends on their own streams


@pytest.mark.cuda
def test_two_backends_on_two_streams_in_two_threads_equal_a_serial_run():
    """Two topics' scans at once, each backend on a stream leased from the
    process's pool and driven from its own thread (the fleet's shape),
    against the same two scans one after the other on the default
    stream."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from kafka_topic_analyzer_tpu_torch.io.synthetic import (
        SyntheticSource,
        SyntheticSpec,
    )

    cfgs = [dict(CFG, batch_size=4096, alive_bitmap_bits=24),
            dict(CFG, batch_size=4096, alive_bitmap_bits=24, wire_format=4)]
    specs = [SyntheticSpec(num_partitions=4, messages_per_partition=60_000,
                           keys_per_partition=5_000, seed=s) for s in (1, 2)]

    def scan(i, pooled=False, built=None):
        backend = TorchBackend(AnalyzerConfig(num_partitions=4, **cfgs[i]),
                               init_now_s=10**10, device="cuda",
                               pooled_stream=pooled)
        if built is not None:
            built(i, backend)
        doc = _doc(run_scan(f"t{i}", SyntheticSource(specs[i]), backend, 4096,
                            ingest_workers=2))
        backend.close()
        return doc

    serial = [scan(0), scan(1)]
    out, streams = [None, None], [None, None]
    barrier = threading.Barrier(2)

    def built(i, backend):
        # Both backends hold their leases before either scans: two at once.
        streams[i] = backend.stream
        barrier.wait(timeout=120)

    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, scan(i, pooled=True, built=built))) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert streams[0] is not streams[1]
    assert out == serial


# ---------------------------------------------------------------------------
# the template broker's several topics (chip_smoke's fleet cluster, small)


def test_template_broker_serves_several_topics_to_the_fleet(capsys):
    """One bootstrap, salted topics: all-topics metadata lists each with
    its internal flag, the single-topic form keeps its unsalted keys, and
    a fleet over the glob admits the matching topics and counts each
    topic's records."""
    from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import (
        TemplateBroker,
        build_templates,
        topic_layout,
    )

    spec = dict(partitions=2, windows=3, R=50, n_templates=2, vmin=10, vmax=40,
                tombstone_every=5)
    extra = [dict(spec, name=f"orders.{i}", salt=i) for i in (1, 2)] + [
        dict(spec, name="orders.dlq", salt=9, windows=1),
        dict(spec, name="__consumer_offsets", salt=10, windows=1, internal=True),
    ]
    base = build_templates(50, 2, 10, 40, tombstone_every=5)
    salted = build_templates(50, 2, 10, 40, tombstone_every=5, salt=1)
    keys = lambda t: {k for _, (_, k, _) in kc.decode_record_batches(t)}  # noqa: E731
    assert all(k.startswith(b"k") for k in keys(base[0]))
    assert keys(base[0]).isdisjoint(keys(salted[0]))
    with TemplateBroker("orders.0", 2, 3, base, 50,
                        extra_topics=[topic_layout(s, 0) for s in extra]) as broker:
        bootstrap = f"127.0.0.1:{broker.port}"
        mds = {t.name: t for t in discover_cluster_topics(bootstrap)}
        assert set(mds) == {"orders.0", "orders.1", "orders.2", "orders.dlq",
                            "__consumer_offsets"}
        assert mds["__consumer_offsets"].is_internal == 1
        assert mds["orders.1"].is_internal == 0
        rc = cli.main(["-t", "orders.*", "--fleet", "--fleet-exclude", "*.dlq",
                       "-b", bootstrap, "--json", "--quiet", "-c",
                       "--alive-bitmap-bits", "20", "--batch-size", "64",
                       "--device", "cpu"])
        out, err = capsys.readouterr()
    assert rc == 0, err
    assert "Fleet discovery: 3 topic(s) matched orders.* minus *.dlq" in err
    doc = json.loads(out)
    assert set(doc["topics"]) == {"orders.0", "orders.1", "orders.2"}
    for t in doc["topics"].values():
        assert t["overall"]["count"] == 2 * 3 * 50
