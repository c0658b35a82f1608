"""What the port's fleet measures of itself, on the host: each topic's wait
for its grant (span ``fleet-admit``, ``kta_fleet_admission_wait_seconds_
total``), each topic pass (span ``fleet-pass``, ``kta_fleet_pass_seconds_
total``) and the high-water mark of the device bytes its live backends
hold at once (``kta_device_resident_bytes_max``): a batch fleet closes
each topic's backend when its pass ends, so only the admitted topics'.

The fleet audits the benchmark's TPC-C change-data-capture topics (nine
one-partition topics, `benchmark.gen.tpcc_cdc`) from its loopback cluster
through the CLI in this process, with ``--trace-json``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import threading

import pytest

from benchmark.gen.cluster import ClusterBroker
from benchmark.gen.tpcc_cdc import TpccCdc
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends import gpu
from kafka_topic_analyzer_tpu_torch.backends.base import resident_bytes_live
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.obs import trace
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from port_instruments import PORT_ONLY
from test_torch_tpcc_fleet import tiny_config

FLEET_NAMES = ("kta_device_resident_bytes_max", "kta_fleet_admission_wait_seconds_total",
               "kta_fleet_pass_seconds_total")


@pytest.fixture(scope="module")
def cluster():
    config = tiny_config()
    config["topic"].update(records_per_batch=50)
    db = TpccCdc(config, 2**31 + 33)
    broker = ClusterBroker(db.topics, config["topic"]["brokers"]).start()
    yield config, db, broker
    broker.stop()


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    trace.set_active(None)
    yield
    trace.set_active(None)
    default_registry().reset()


def traced_fleet(config, broker, tmp_path) -> "tuple[dict, list[dict]]":
    path = tmp_path / "host.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["-b", f"127.0.0.1:{broker.ports[0]}", "--quiet", *config["argv"],
                         "--trace-json", str(path)]) == 0
    return default_registry().snapshot(), json.loads(path.read_text())["traceEvents"]


def value(snap: dict, name: str) -> float:
    return snap[name]["samples"][0]["value"]


def test_fleet_spans_nest_and_carry_topic_scan_and_parent(cluster, tmp_path):
    config, db, broker = cluster
    _, events = traced_fleet(config, broker, tmp_path)
    spans = [e for e in events if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in spans}
    passes = {e["args"]["topic"]: e for e in spans if e["name"] == "fleet-pass"}
    admits = {e["args"]["topic"]: e for e in spans if e["name"] == "fleet-admit"}
    names = {t.name for t in db.topics}
    assert set(passes) == set(admits) == names
    fleet_scan = {e["args"]["scan"] for e in list(passes.values()) + list(admits.values())}
    assert len(fleet_scan) == 1
    for topic, p in passes.items():
        a = admits[topic]
        assert p["cat"] == a["cat"] == "fleet"
        assert p["args"]["workers"] >= 1 and p["args"]["dispatch_depth"] >= 1
        # Both on the thread that ran the pass, the wait first.
        assert a["tid"] == p["tid"] and a["args"]["parent"] == p["args"]["parent"]
        assert a["ts"] + a["dur"] <= p["ts"] + 1.0
        inner = [e for e in spans if e["tid"] == p["tid"] and e is not p
                 and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        stages = [e for e in inner if e["cat"] == "stage"]
        assert {"dispatch", "finalize"} <= {e["name"] for e in stages}
        for e in inner:
            # Every span of the scan lies under the pass, with the scan's
            # own number.
            up = e
            while up["args"]["parent"] != p["args"]["id"]:
                up = by_id[up["args"]["parent"]]
            assert e["args"]["scan"] not in fleet_scan


def test_fleet_counters_equal_their_spans(cluster, tmp_path):
    config, db, broker = cluster
    snap, events = traced_fleet(config, broker, tmp_path)
    for name, family in (("fleet-admit", "kta_fleet_admission_wait_seconds_total"),
                         ("fleet-pass", "kta_fleet_pass_seconds_total")):
        durs = [e["dur"] / 1e6 for e in events if e["ph"] == "X" and e["name"] == name]
        assert len(durs) == len(db.topics)
        assert value(snap, family) == pytest.approx(sum(durs), rel=1e-9, abs=1e-9)
    # A batch fleet's topics wait for their waves: some wait is booked.
    assert value(snap, "kta_fleet_admission_wait_seconds_total") > 0


def test_resident_max_is_the_live_backends_sum_and_falls_back(cluster, tmp_path, monkeypatch):
    config, db, broker = cluster
    gc.collect()
    before = resident_bytes_live()
    # Count the topics' backends live at once, from their booking to their
    # close, under one lock with both.
    lock, live, most = threading.Lock(), [0], [0]
    real_book, real_close = gpu.book_resident, TorchBackend.close

    def book(backend, owners):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
            return real_book(backend, owners)

    def close(backend):
        with lock:
            live[0] -= backend.state is not None
            real_close(backend)

    monkeypatch.setattr(gpu, "book_resident", book)
    monkeypatch.setattr(TorchBackend, "close", close)
    snap, _ = traced_fleet(config, broker, tmp_path)
    # Each pass closed its backend: the bytes are off the live sum at once.
    assert live[0] == 0
    assert resident_bytes_live() == before
    booked = sum(s["value"] for s in snap["kta_device_resident_bytes_total"]["samples"])
    topics = len(db.topics)
    # One-partition topics of one configuration: the same bytes each.
    assert booked > 0 and booked % topics == 0
    # The dispatch budget (2) admits fewer topics at once than the fleet has.
    assert 1 <= most[0] <= 2 < topics
    mark = value(snap, "kta_device_resident_bytes_max")
    assert mark == before + most[0] * booked // topics < before + booked
    # One backend after the fleet adds its own bytes; the mark stays.
    one = TorchBackend(AnalyzerConfig(num_partitions=1, batch_size=1024, count_alive_keys=True,
                                      alive_bitmap_bits=20), device="cpu")
    assert resident_bytes_live() == before + (1 << 20) // 8 + 104
    assert value(default_registry().snapshot(), "kta_device_resident_bytes_max") == mark
    del one
    gc.collect()
    assert resident_bytes_live() == before


def test_a_backend_released_while_another_books_does_not_deadlock(monkeypatch):
    from kafka_topic_analyzer_tpu_torch.backends import base
    from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

    class Owner:
        pass

    gc.collect()
    before = resident_bytes_live()
    old = [Owner()]
    base.book_resident(old[0], {"alive": 100})
    set_max = obs_metrics.DEVICE_RESIDENT_MAX.set

    def set_and_collect(v):
        # The collector may run here, on the booking thread, inside its lock.
        old.clear()
        set_max(v)

    monkeypatch.setattr(obs_metrics.DEVICE_RESIDENT_MAX, "set", set_and_collect)
    new = Owner()
    done = threading.Thread(target=base.book_resident, args=(new, {"alive": 10**15}),
                            daemon=True)
    done.start()
    done.join(10)
    assert not done.is_alive()
    assert resident_bytes_live() == before + 10**15
    del new
    gc.collect()
    assert resident_bytes_live() == before


def test_the_fleet_instruments_are_port_only():
    snap = default_registry().snapshot()
    for name in FLEET_NAMES:
        kind, labels = PORT_ONLY[name]
        assert snap[name]["type"] == kind
        assert all(tuple(s["labels"]) == labels for s in snap[name]["samples"])
