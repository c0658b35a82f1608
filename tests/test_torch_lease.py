"""The port's topic leases (``fleet/lease.py``, the epoch fence of
``checkpoint.py`` and ``engine.run_scan(lease_epoch=)``) against the
reference's.

Tolerance: exact.  Lease records are the same bytes in both packages: a
record either package writes, to a file store or an object store, is read
by the other, and managers of the two packages contend for one store
under the same epoch rules.  The stores' compare-and-swap races (a
competing rename between replace and read-back, a live or stale lock, a
corrupt record, two instances reading "absent" at once, the ambiguous
retried PUT, a competing PUT, a 503, a clock-skewed writer), renewal
through a store outage, the checkpoint fence (a snapshot the port wrote
under epoch 2 refuses the reference's epoch-1 save and load, and the
other way round), the lease alert rules, the CLI's store selection, and
two fleet instances: crash failover by lease expiry with byte-identical
results, the paused zombie fenced at its checkpoint, and SIGTERM handing
every lease back.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import pytest

from fake_broker import FakeBroker
from fake_objstore import FakeObjectStore
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu import checkpoint as ref_checkpoint
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefAnalyzerConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.fleet import lease as ref_lease
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefSource
from kafka_topic_analyzer_tpu.io.objstore import RetryingHttp as RefHttp
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu.serve import state as ref_serve_state
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.checkpoint import (
    StaleLeaseEpochError,
    list_topic_snapshots,
    load_snapshot,
    save_snapshot,
    snapshot_info,
    topic_snapshot_dir,
)
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    DispatchConfig,
    FollowConfig,
    HealthConfig,
    LeaseConfig,
    SegmentFetchConfig,
    TransportRetryConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.fleet.lease import (
    LEASE_DIR_NAME,
    FileLeaseStore,
    Lease,
    LeaseManager,
    ObjectLeaseStore,
)
from kafka_topic_analyzer_tpu_torch.fleet.scheduler import FleetScheduler, TopicSeed
from kafka_topic_analyzer_tpu_torch.fleet.service import FleetService
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.objstore import RetryingHttp
from kafka_topic_analyzer_tpu_torch.io.retry import Backoff
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.health import HealthEngine, built_in_rules
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state

pytestmark = pytest.mark.lease

TOPICS = ["lease.a", "lease.b"]
N_PARTS = 2
PHASE1_N = 96
PHASE2_N = 48
FULL_N = PHASE1_N + PHASE2_N
FAST_RETRY = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}
FAST_FOLLOW = dict(poll_interval_s=0.02, idle_backoff_max_s=0.05)


class _Clock:
    """The shared fake wall clock lease expiry runs on."""

    def __init__(self, t: float = 1_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _mk_records(salt: int, partition: int, lo: int, n: int):
    return [
        (i, 1_600_000_000_000 + i * 1000,
         f"k{salt}-{partition}-{i % 13}".encode() if i % 5 else None,
         bytes(11 + ((i + salt) % 7)) if i % 7 else None)
        for i in range(lo, lo + n)
    ]


def _topic_records(salt: int, n: int, lo: int = 0):
    return {p: _mk_records(salt, p, lo, n) for p in range(N_PARTS)}


def _mk_broker(records_by_topic, **kw):
    names = list(records_by_topic)
    return FakeBroker(
        names[0], records_by_topic[names[0]],
        extra_topics={t: records_by_topic[t] for t in names[1:]},
        max_records_per_fetch=48, **kw,
    )


def _cfg(parts=N_PARTS) -> AnalyzerConfig:
    return AnalyzerConfig(num_partitions=parts, batch_size=64,
                          count_alive_keys=True, alive_bitmap_bits=16)


def _backend(parts=N_PARTS, depth=2) -> TorchBackend:
    return TorchBackend(_cfg(parts), init_now_s=10**10, device="cpu",
                        dispatch=DispatchConfig(depth=depth))


def _source(broker, topic):
    return KafkaWireSource(f"127.0.0.1:{broker.port}", topic,
                           overrides=dict(FAST_RETRY))


def _doc(result) -> dict:
    return result.metrics.to_dict(result.start_offsets, result.end_offsets)


def _fleet(broker, topics=TOPICS, *, leases=None, instance="solo", follow=None,
           snapshot_dir=None, resume=False, max_concurrent=3):
    return FleetService(
        [TopicSeed(name=t, partitions=N_PARTS) for t in topics],
        lambda topic: _source(broker, topic),
        lambda topic, parts, grant: _backend(parts, grant.dispatch_depth),
        64, FleetScheduler(3, 3, max_concurrent, instance=instance),
        follow=follow, snapshot_dir=snapshot_dir, resume=resume,
        leases=leases, instance=instance,
    )


def _wait_for(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _acq(outcome: str, instance: str) -> float:
    return obs_metrics.LEASE_ACQUISITIONS.labels(outcome=outcome, instance=instance).value


def _renewals(outcome: str, instance: str) -> float:
    return obs_metrics.LEASE_RENEWALS.labels(outcome=outcome, instance=instance).value


def _losses(instance: str) -> float:
    return obs_metrics.LEASE_LOSSES.labels(instance=instance).value


def _failovers(instance: str) -> float:
    return obs_metrics.FLEET_FAILOVERS.labels(instance=instance).value


def _fetch_cfg() -> SegmentFetchConfig:
    return SegmentFetchConfig(
        retry=TransportRetryConfig(backoff_ms=1, backoff_max_ms=2,
                                   retry_budget=4, jitter=0.0),
        timeout_s=5.0,
    )


def _obj_store(server) -> ObjectLeaseStore:
    return ObjectLeaseStore(RetryingHttp(server.url, _fetch_cfg()))


def _ref_obj_store(server):
    from kafka_topic_analyzer_tpu.config import SegmentFetchConfig as RefFetch
    from kafka_topic_analyzer_tpu.config import TransportRetryConfig as RefRetry

    cfg = RefFetch(retry=RefRetry(backoff_ms=1, backoff_max_ms=2,
                                  retry_budget=4, jitter=0.0), timeout_s=5.0)
    return ref_lease.ObjectLeaseStore(RefHttp(server.url, cfg))


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()
    serve_state.set_active(None)
    ref_serve_state.set_active(None)


# ---------------------------------------------------------------------------
# records, read across packages


@pytest.mark.parametrize("owner", ["i-1", None])
def test_lease_record_bytes_equal_the_reference(owner):
    kw = dict(topic="t.x", owner=owner, epoch=3, expires_at=12.5, acquired_at=2.5)
    port, ref = Lease(**kw), ref_lease.Lease(**kw)
    assert port.to_json() == ref.to_json()
    assert Lease.from_json(ref.to_json()) == port
    assert LEASE_DIR_NAME == ref_lease.LEASE_DIR_NAME == "_kta_leases"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_file_store_records_are_read_by_the_other_package(tmp_path, writer):
    port, ref = FileLeaseStore(str(tmp_path)), ref_lease.FileLeaseStore(str(tmp_path))
    w, r = (port, ref) if writer == "port" else (ref, port)
    mk = Lease if writer == "port" else ref_lease.Lease
    token = w.write("t.x", mk(topic="t.x", owner="A", epoch=4, expires_at=10.0,
                              acquired_at=0.0), None)
    assert token is not None
    got, tok = r.read("t.x")
    assert (got.owner, got.epoch, got.expires_at) == ("A", 4, 10.0)
    assert tok == token
    assert os.path.exists(tmp_path / "_kta_leases" / "t.x.json")
    # The reader's CAS takes the writer's record as its token.
    released = (ref_lease.Lease if writer == "port" else Lease)(
        topic="t.x", owner=None, epoch=4, expires_at=0.0, acquired_at=0.0)
    assert r.write("t.x", released, tok) is not None
    assert w.owners() == r.owners() == set()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_object_store_records_are_read_by_the_other_package(writer):
    with FakeObjectStore({}) as server:
        port, ref = _obj_store(server), _ref_obj_store(server)
        w, r = (port, ref) if writer == "port" else (ref, port)
        mk = Lease if writer == "port" else ref_lease.Lease
        token = w.write("t", mk(topic="t", owner="A", epoch=2, expires_at=10.0,
                                acquired_at=0.0), None)
        got, tok = r.read("t")
        assert (got.owner, got.epoch) == ("A", 2) and tok == token
        assert "_kta_leases/t.json" in server.root
        assert w.owners() == r.owners() == {"A"}


def test_managers_of_both_packages_share_the_epoch_rules(tmp_path):
    """A port manager and a reference manager contend for one file store:
    held elsewhere is refused, a release keeps the epoch, the successor
    bumps it, and a takeover after expiry books a failover."""
    clock = _Clock()
    a = LeaseManager(FileLeaseStore(str(tmp_path)), "A", ttl_s=5.0, clock=clock)
    b = ref_lease.LeaseManager(ref_lease.FileLeaseStore(str(tmp_path)), "B",
                               ttl_s=5.0, clock=clock)
    assert a.acquire("t") == 1
    assert b.acquire("t") is None
    a.release("t")
    assert b.acquire("t") == 2
    assert a.acquire("t") is None
    clock.advance(6.0)  # B's lease expires unrenewed
    fo0 = _failovers("A")
    assert a.acquire("t") == 3
    assert _failovers("A") - fo0 == 1
    assert b.renew("t") is False  # the zombie sees the successor
    rec, _ = FileLeaseStore(str(tmp_path)).read("t")
    assert (rec.owner, rec.epoch) == ("A", 3)


# ---------------------------------------------------------------------------
# FileLeaseStore


def test_file_store_round_trip_and_owners(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    assert store.read("t") == (None, None)
    lease = Lease(topic="t", owner="A", epoch=1, expires_at=10.0, acquired_at=0.0)
    token = store.write("t", lease, None)
    got, tok = store.read("t")
    assert got == lease and tok is not None
    assert store.owners() == {"A"}
    released = Lease(topic="t", owner=None, epoch=1, expires_at=0.0, acquired_at=0.0)
    assert store.write("t", released, token) is not None
    assert store.owners() == set()


def test_file_store_lost_race_detected_by_read_back(tmp_path):
    racer = FileLeaseStore(str(tmp_path))

    def competing_write(topic):
        theirs = Lease(topic=topic, owner="B", epoch=9, expires_at=99.0,
                       acquired_at=0.0)
        with open(racer._path(topic), "wb") as f:
            f.write(theirs.to_json())

    store = FileLeaseStore(str(tmp_path), verify_hook=competing_write)
    mine = Lease(topic="t", owner="A", epoch=1, expires_at=10.0, acquired_at=0.0)
    assert store.write("t", mine, None) is None
    got, _ = store.read("t")
    assert (got.owner, got.epoch) == ("B", 9)


def test_file_store_lock_contention(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    lease = Lease(topic="t", owner="A", epoch=1, expires_at=10.0, acquired_at=0.0)
    lock = store._path("t") + ".lock"
    with open(lock, "w"):
        pass
    assert store.write("t", lease, None) is None  # a live writer's lock
    old = time.time() - FileLeaseStore.LOCK_STALE_S - 1.0
    os.utime(lock, (old, old))
    assert store.write("t", lease, None) is not None  # a crashed writer's
    assert not os.path.exists(lock)


def test_file_store_corrupt_record_carries_a_cas_token(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    with open(store._path("t"), "wb") as f:
        f.write(b"{not json")
    got, token = store.read("t")
    assert got is None and token is not None
    lease = Lease(topic="t", owner="A", epoch=1, expires_at=10.0, acquired_at=0.0)
    assert store.write("t", lease, None) is None
    assert store.write("t", lease, token) is not None
    assert store.read("t")[0] == lease


def test_file_store_concurrent_acquire_grants_exactly_one(tmp_path):
    """Two managers, one of each package, both read the same absent
    record (a barrier forces it) and then write: exactly one holds epoch
    1."""
    barrier = threading.Barrier(2)

    class PortBarrier(FileLeaseStore):
        def read(self, topic):
            out = super().read(topic)
            barrier.wait(timeout=10)
            return out

    class RefBarrier(ref_lease.FileLeaseStore):
        def read(self, topic):
            out = super().read(topic)
            barrier.wait(timeout=10)
            return out

    clock = _Clock()
    mgrs = {"A": LeaseManager(PortBarrier(str(tmp_path)), "A", ttl_s=30.0, clock=clock),
            "B": ref_lease.LeaseManager(RefBarrier(str(tmp_path)), "B", ttl_s=30.0,
                                        clock=clock)}
    got = {}
    threads = [threading.Thread(target=lambda n=n: got.__setitem__(n, mgrs[n].acquire("t")))
               for n in mgrs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    winners = {n for n, e in got.items() if e is not None}
    assert len(winners) == 1, got
    winner = winners.pop()
    assert got[winner] == 1
    rec, _ = FileLeaseStore(str(tmp_path)).read("t")
    assert (rec.owner, rec.epoch) == (winner, 1)


# ---------------------------------------------------------------------------
# ObjectLeaseStore


def test_object_store_create_replace_and_stale_etag():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        a1 = Lease(topic="t", owner="A", epoch=1, expires_at=10.0, acquired_at=0.0)
        token = store.write("t", a1, None)
        assert token and store.read("t") == (a1, token)
        a1r = Lease(topic="t", owner="A", epoch=1, expires_at=20.0, acquired_at=0.0)
        token2 = store.write("t", a1r, token)
        assert token2 and token2 != token
        server.root["_kta_leases/t.json"] = Lease(
            topic="t", owner="B", epoch=2, expires_at=30.0, acquired_at=0.0).to_json()
        a1rr = Lease(topic="t", owner="A", epoch=1, expires_at=40.0, acquired_at=0.0)
        assert store.write("t", a1rr, token2) is None


def test_object_store_ambiguous_put_resolved_by_read_back():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        token = store.write("t", Lease(topic="t", owner="A", epoch=1,
                                       expires_at=10.0, acquired_at=0.0), None)
        server.script_put("_kta_leases/t.json", "lost")
        renewal = Lease(topic="t", owner="A", epoch=1, expires_at=20.0, acquired_at=0.0)
        assert store.write("t", renewal, token) is not None
        assert store.read("t")[0] == renewal
        assert server.puts["_kta_leases/t.json"] >= 2


def test_object_store_race_loses_acquire():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        clock = _Clock()
        competitor = Lease(topic="t", owner="B", epoch=1,
                           expires_at=clock() + 60.0, acquired_at=clock())
        server.script_put("_kta_leases/t.json", ("race", competitor.to_json()))
        mgr = LeaseManager(store, "A", ttl_s=30.0, clock=clock)
        assert mgr.acquire("t") is None
        assert _acq("lost-race", "A") == 1
        assert store.read("t")[0].owner == "B"


def test_object_store_transient_5xx_retried():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        server.script_put("_kta_leases/t.json", ("status", 503))
        assert store.write("t", Lease(topic="t", owner="A", epoch=1, expires_at=10.0,
                                      acquired_at=0.0), None) is not None
        assert server.puts["_kta_leases/t.json"] == 2


def test_object_store_corrupt_record_is_recoverable():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        server.root["_kta_leases/t.json"] = b"{not json"
        got, token = store.read("t")
        assert got is None and token is not None
        assert LeaseManager(store, "A", ttl_s=30.0, clock=_Clock()).acquire("t") == 1


def test_object_store_clock_skew_expires_lease_early():
    with FakeObjectStore({}) as server:
        store = _obj_store(server)
        clock = _Clock()
        server.script_put("_kta_leases/t.json", ("skew", -100.0))
        assert LeaseManager(store, "A", ttl_s=30.0, clock=clock).acquire("t") == 1
        assert store.read("t")[0].expires_at <= clock()
        assert LeaseManager(store, "B", ttl_s=30.0, clock=clock).acquire("t") == 2
        assert _failovers("B") == 1


# ---------------------------------------------------------------------------
# LeaseManager


def test_acquire_epoch_rules_and_release(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    clock = _Clock()
    a = LeaseManager(store, "A", ttl_s=30.0, clock=clock)
    b = LeaseManager(store, "B", ttl_s=30.0, clock=clock)
    assert a.acquire("t") == 1 and a.acquire("t") == 1
    assert _acq("acquired", "A") == 1
    assert a.is_held("t") and a.epoch("t") == 1
    assert obs_metrics.LEASE_HELD.labels(topic="t", instance="A").value == 1
    assert b.acquire("t") is None and _acq("held-elsewhere", "B") == 1
    a.release("t")
    assert not a.is_held("t") and _acq("released", "A") == 1
    rec, _ = store.read("t")
    assert rec.owner is None and rec.epoch == 1
    assert b.acquire("t") == 2
    assert a.known_instances() == ["A", "B"] and b.held_topics() == ["t"]


def test_expired_lease_takeover_and_zombie_fencing(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    clock = _Clock()
    a = LeaseManager(store, "A", ttl_s=5.0, clock=clock)
    b = LeaseManager(store, "B", ttl_s=5.0, clock=clock)
    assert a.acquire("t") == 1
    clock.advance(6.0)
    assert b.acquire("t") == 2
    assert _acq("takeover", "B") == 1 and _failovers("B") == 1
    assert a.is_held("t")  # the zombie's stale local view
    assert a.renew("t") is False
    assert _losses("A") == 1 and not a.is_held("t")
    rec, _ = store.read("t")
    assert (rec.owner, rec.epoch) == ("B", 2)


def test_renewal_outage_defers_until_local_expiry(tmp_path):
    class FlakyStore(FileLeaseStore):
        fail_writes = False

        def write(self, topic, lease, token):
            if self.fail_writes:
                raise OSError("store outage")
            return super().write(topic, lease, token)

    store = FlakyStore(str(tmp_path))
    clock = _Clock()
    backoff = Backoff(TransportRetryConfig(backoff_ms=1, backoff_max_ms=2, jitter=0.0),
                      sleep=lambda s: None)
    mgr = LeaseManager(store, "A", ttl_s=10.0, clock=clock, backoff=backoff,
                       renew_attempts=2)
    assert mgr.acquire("t") == 1
    store.fail_writes = True
    clock.advance(3.0)
    assert mgr.renew("t") is True and _renewals("deferred", "A") == 1
    store.fail_writes = False
    assert mgr.renew("t") is True and _renewals("renewed", "A") == 1
    store.fail_writes = True
    clock.advance(11.0)
    assert mgr.renew("t") is False
    assert _losses("A") == 1 and not mgr.is_held("t")


# ---------------------------------------------------------------------------
# the checkpoint epoch fence, across packages


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_epoch_fence_across_packages(tmp_path, writer):
    """A snapshot stamped with epoch 2 by one package refuses the other
    package's epoch-1 save and load, and resumes under epoch 3."""
    topic = "lease.f"
    d = str(tmp_path / "snap")
    records = {topic: {0: _mk_records(3, 0, 0, 40)}}
    ref_cfg = RefAnalyzerConfig(num_partitions=1, batch_size=64,
                                count_alive_keys=True, alive_bitmap_bits=16)
    with _mk_broker(records) as broker:
        if writer == "port":
            backend = _backend(1)
            res = run_scan(topic, _source(broker, topic), backend, 64,
                           snapshot_dir=d, final_snapshot=True, lease_epoch=2)
        else:
            backend = TpuBackend(ref_cfg, init_now_s=10**10)
            res = ref_run_scan(topic, RefSource(f"127.0.0.1:{broker.port}", topic,
                                                overrides=dict(FAST_RETRY)),
                               backend, 64, snapshot_dir=d, final_snapshot=True,
                               lease_epoch=2)
    assert snapshot_info(d)["lease_epoch"] == 2
    state = _backend(1).get_state()
    with pytest.raises(StaleLeaseEpochError, match="STALE-LEASE-EPOCH"):
        save_snapshot(d, topic, _cfg(1), state, res.next_offsets,
                      int(res.metrics.overall_count), 10**10, lease_epoch=1)
    with pytest.raises(StaleLeaseEpochError, match="STALE-LEASE-EPOCH"):
        load_snapshot(d, topic, _cfg(1), lease_epoch=1)
    with pytest.raises(ref_checkpoint.StaleLeaseEpochError, match="STALE-LEASE-EPOCH"):
        ref_checkpoint.load_snapshot(d, topic, ref_cfg, lease_epoch=1)
    assert load_snapshot(d, topic, _cfg(1), lease_epoch=3) is not None
    assert load_snapshot(d, topic, _cfg(1)) is not None  # epoch-less scans
    # A stale run_scan resume is fenced too.
    with _mk_broker(records) as broker:
        with pytest.raises(StaleLeaseEpochError):
            run_scan(topic, _source(broker, topic), _backend(1), 64,
                     snapshot_dir=d, resume=True, lease_epoch=1)


def test_topic_snapshot_dirs_equal_the_reference(tmp_path):
    assert topic_snapshot_dir("/d", "a.b") == ref_checkpoint.topic_snapshot_dir("/d", "a.b")
    assert list_topic_snapshots(str(tmp_path / "none")) == {}
    os.makedirs(tmp_path / "bad.topic")
    with open(tmp_path / "bad.topic" / "scan_snapshot.npz", "wb") as f:
        f.write(b"not a zip")
    assert list_topic_snapshots(str(tmp_path)) == \
        ref_checkpoint.list_topic_snapshots(str(tmp_path)) == {}


# ---------------------------------------------------------------------------
# health rules and the CLI


def test_lease_alert_rules_fire_and_resolve():
    clock = {"t": 0.0}
    cfg = HealthConfig(eval_interval_s=0.001, storm_window_s=2.0, resolve_s=1.0)
    eng = HealthEngine(built_in_rules(cfg), cfg=cfg, clock=lambda: clock["t"])

    def snap(losses, failovers):
        return {
            "kta_lease_losses_total": {
                "type": "counter", "samples": [{"labels": {}, "value": losses}]},
            "kta_fleet_failovers_total": {
                "type": "counter", "samples": [{"labels": {}, "value": failovers}]},
        }

    eng.evaluate(snap(0, 0))
    clock["t"] = 1.0
    firing = {r["rule"]: r for r in eng.evaluate(snap(2, 1))["firing"]}
    assert firing["lease_lost"]["evidence"]["lease_losses"] == 2
    assert firing["failover"]["evidence"]["failovers"] == 1
    for t in (4.0, 5.5, 7.0):
        clock["t"] = t
        doc = eng.evaluate(snap(2, 1))
    assert doc["healthy"]


def test_lease_config_and_store_selection(tmp_path):
    assert not LeaseConfig().enabled and LeaseConfig(instance_id="i-1").enabled
    for bad in (dict(ttl_s=0.0), dict(store="zookeeper")):
        with pytest.raises(ValueError):
            LeaseConfig(instance_id="i", **bad)
    cfg = LeaseConfig(instance_id="i-1", ttl_s=5.0)
    mgr = cli.make_lease_manager(cfg, snapshot_dir=str(tmp_path))
    assert isinstance(mgr.store, FileLeaseStore)
    assert (mgr.instance, mgr.ttl_s) == ("i-1", 5.0)
    assert isinstance(cli.make_lease_manager(cfg, store_spec="http://127.0.0.1:9/b").store,
                      ObjectLeaseStore)
    with pytest.raises(ValueError, match="remote --segment-dir"):
        cli.make_lease_manager(LeaseConfig(instance_id="i", store="object"),
                               snapshot_dir=str(tmp_path), store_spec="./segments")
    with pytest.raises(ValueError, match="needs a lease store"):
        cli.make_lease_manager(LeaseConfig(instance_id="i", store="file"))


def test_instance_id_without_the_fleet_is_refused_as_the_reference(capsys):
    argv = ["-t", "t", "--source", "synthetic", "--synthetic", "partitions=1,messages=4",
            "--backend", "cpu", "--native", "off", "--quiet", "--instance-id", "i-1"]
    rc = cli.main(argv)
    err = capsys.readouterr().err
    assert rc == 1 and "--instance-id" in err and "--fleet" in err
    assert ref_cli.main(argv) == 1
    assert capsys.readouterr().err == err


def test_cli_instance_needs_a_lease_store(capsys):
    with _mk_broker({"lease.a": _topic_records(0, 4)}) as broker:
        argv = ["-t", "*", "--fleet", "-b", f"127.0.0.1:{broker.port}",
                "--instance-id", "a", "--quiet"]
        rc = cli.main(argv + ["--device", "cpu"])
        out, err = capsys.readouterr()
        assert rc == 1 and "needs a lease store" in err
        assert ref_cli.main(argv + ["--backend", "tpu"]) == 1
        assert capsys.readouterr() == (out, err)


# ---------------------------------------------------------------------------
# fleets of instances


def test_topic_lag_gauge_only_counts_the_holder(tmp_path):
    topic = "lease.lag"
    with _mk_broker({topic: _topic_records(1, 24)}) as broker:
        store = FileLeaseStore(str(tmp_path))
        clock = _Clock()
        mgr_b = LeaseManager(store, "B", ttl_s=60.0, clock=clock)
        assert mgr_b.acquire(topic) == 1
        mgr_a = LeaseManager(store, "A", ttl_s=60.0, clock=clock)
        svc = _fleet(broker, topics=[topic], leases=mgr_a, instance="A")
        lag = svc._poll_topic(svc.scans[topic])
        assert lag == N_PARTS * 24
        gauge = obs_metrics.FLEET_TOPIC_LAG.labels(topic=topic, instance="A")
        assert gauge.value == 0
        mgr_b.release(topic)
        assert mgr_a.acquire(topic) == 2
        svc._poll_topic(svc.scans[topic])
        assert gauge.value == lag


def _solo_referee():
    full = {t: _topic_records(i, FULL_N) for i, t in enumerate(TOPICS)}
    out = {}
    with _mk_broker(full) as broker:
        for t in TOPICS:
            src = RefSource(f"127.0.0.1:{broker.port}", t, overrides=dict(FAST_RETRY))
            ref_cfg = RefAnalyzerConfig(num_partitions=N_PARTS, batch_size=64,
                                        count_alive_keys=True, alive_bitmap_bits=16)
            out[t] = _doc(ref_run_scan(t, src, TpuBackend(ref_cfg, init_now_s=10**10), 64))
            src.close()
    return out


def test_two_instance_crash_failover_equals_the_reference_solo_scans(tmp_path):
    snap = str(tmp_path / "snaps")
    clock = _Clock()
    follow = FollowConfig(**dict(FAST_FOLLOW, checkpoint_every_s=0.0))
    referee = _solo_referee()
    phase1 = {t: _topic_records(i, PHASE1_N) for i, t in enumerate(TOPICS)}
    with _mk_broker(phase1, response_delay=lambda *_: 0.03) as broker:
        mgr_a = LeaseManager(FileLeaseStore(snap), "A", ttl_s=5.0, clock=clock)
        svc_a = _fleet(broker, leases=mgr_a, instance="A", follow=follow,
                       snapshot_dir=snap)
        th = threading.Thread(target=svc_a.run_follow)
        th.start()
        _wait_for(lambda: set(mgr_a.held_topics()) == set(TOPICS),
                  what="instance A to hold every lease")
        svc_a.kill()
        th.join(timeout=60)
        assert not th.is_alive()
        assert FileLeaseStore(snap).owners() == {"A"}  # dangling, as a crash leaves
        inv = list_topic_snapshots(snap)
        assert set(inv) == set(TOPICS)
        assert all(i["records_seen"] == N_PARTS * PHASE1_N for i in inv.values())
        clock.advance(6.0)
        broker.response_delay = None
        for i, t in enumerate(TOPICS):
            for p, recs in _topic_records(i, PHASE2_N, lo=PHASE1_N).items():
                broker.produce(p, recs, topic=t)
        mgr_b = LeaseManager(FileLeaseStore(snap), "B", ttl_s=5.0, clock=clock)
        svc_b = _fleet(broker, leases=mgr_b, instance="B", follow=follow,
                       snapshot_dir=snap, resume=True)
        out = {}
        th2 = threading.Thread(target=lambda: out.setdefault("fr", svc_b.run_follow()))
        th2.start()

        def published(t):
            doc = svc_b.state.snapshot(t)
            return doc["overall"]["count"] if doc else -1

        _wait_for(lambda: all(published(t) >= N_PARTS * FULL_N for t in TOPICS),
                  what="instance B to catch up")
        svc_b.request_stop("test")
        th2.join(timeout=60)
    fr = out["fr"]
    assert _acq("takeover", "B") == len(TOPICS) == _failovers("B")
    for t in TOPICS:
        assert _doc(fr.results[t]) == referee[t]
    assert fr.rollup["fleet"]["instance"] == "B"
    assert "B" in fr.rollup["fleet"]["instances"]
    assert svc_b.state.snapshot(TOPICS[0])["instance"] == "B"


def test_paused_zombie_is_fenced_at_its_checkpoint(tmp_path):
    """Instance A holds the backlogged topic's lease with no pass running
    (one admission slot), freezes at the post-renew gate, its lease
    expires, a reference successor scans the topic under epoch 2; on
    unpause A's pass must be refused at the checkpoint: status fenced,
    the loss booked, the successor's snapshot untouched."""
    snap = str(tmp_path / "snaps")
    clock = _Clock()
    follow = FollowConfig(**dict(FAST_FOLLOW, checkpoint_every_s=0.0))
    big, zombie = "lease.big", "lease.z"
    records = {big: _topic_records(3, FULL_N), zombie: _topic_records(7, PHASE1_N)}
    with _mk_broker(records, response_delay=lambda *_: 0.05) as broker:
        store = FileLeaseStore(snap)
        mgr_a = LeaseManager(store, "A", ttl_s=5.0, clock=clock)
        svc = _fleet(broker, topics=[big, zombie], leases=mgr_a, instance="A",
                     follow=follow, snapshot_dir=snap, max_concurrent=1)
        out = {}
        th = threading.Thread(target=lambda: out.setdefault("fr", svc.run_follow()))
        th.start()
        try:
            _wait_for(lambda: mgr_a.is_held(zombie), what="A to hold the lease")
            svc.pause()
            _wait_for(lambda: svc.paused and mgr_a.is_held(zombie),
                      what="A frozen at the gate")
            broker.response_delay = None
            clock.advance(6.0)
            mgr_b = ref_lease.LeaseManager(ref_lease.FileLeaseStore(snap), "B",
                                           ttl_s=60.0, clock=clock)
            assert mgr_b.acquire(zombie) == 2
            ref_cfg = RefAnalyzerConfig(num_partitions=N_PARTS, batch_size=64,
                                        count_alive_keys=True, alive_bitmap_bits=16)
            src = RefSource(f"127.0.0.1:{broker.port}", zombie, overrides=dict(FAST_RETRY))
            res_b = ref_run_scan(zombie, src, TpuBackend(ref_cfg, init_now_s=10**10), 64,
                                 snapshot_dir=topic_snapshot_dir(snap, zombie),
                                 final_snapshot=True, lease_epoch=2)
            src.close()
            assert res_b.metrics.overall_count == N_PARTS * PHASE1_N
            svc.unpause()
            _wait_for(lambda: svc.scans[zombie].status.status == "fenced",
                      what="the zombie's pass to be fenced")
        finally:
            svc.unpause()
            svc.request_stop("test")
            th.join(timeout=60)
        assert not th.is_alive()
    fr = out["fr"]
    assert svc._stop_reason == "test"
    assert fr.statuses[zombie].status == "fenced"
    assert "STALE-LEASE-EPOCH" in fr.statuses[zombie].error
    assert _losses("A") == 1 and not mgr_a.is_held(zombie)
    info = snapshot_info(topic_snapshot_dir(snap, zombie))
    assert info["lease_epoch"] == 2 and info["records_seen"] == N_PARTS * PHASE1_N
    rec, _ = store.read(zombie)
    assert (rec.owner, rec.epoch) == ("B", 2)


def test_sigterm_releases_every_lease(tmp_path):
    snap = str(tmp_path / "snaps")
    clock = _Clock()
    follow = FollowConfig(**dict(FAST_FOLLOW, checkpoint_every_s=0.0))
    phase1 = {t: _topic_records(i, PHASE1_N) for i, t in enumerate(TOPICS)}
    with _mk_broker(phase1, response_delay=lambda *_: 0.05) as broker:
        store = FileLeaseStore(snap)
        mgr_a = LeaseManager(store, "A", ttl_s=30.0, clock=clock)
        svc = _fleet(broker, leases=mgr_a, instance="A", follow=follow,
                     snapshot_dir=snap, max_concurrent=1)
        restore = svc.install_signal_handlers()
        out = {}
        th = threading.Thread(target=lambda: out.setdefault("fr", svc.run_follow()))
        try:
            th.start()
            _wait_for(lambda: set(mgr_a.held_topics()) == set(TOPICS),
                      what="instance A to hold every lease")
            os.kill(os.getpid(), signal.SIGTERM)
            th.join(timeout=60)
        finally:
            restore()
        assert not th.is_alive()
    assert svc._stop_reason == "SIGTERM"
    for t in TOPICS:
        rec, _ = store.read(t)
        assert rec.owner is None and rec.epoch == 1
    mgr_b = LeaseManager(store, "B", ttl_s=30.0, clock=clock)
    assert all(mgr_b.acquire(t) == 2 for t in TOPICS)
    inv = list_topic_snapshots(snap)
    assert inv and all(i["records_seen"] == N_PARTS * PHASE1_N and i["lease_epoch"] == 1
                       for i in inv.values())
