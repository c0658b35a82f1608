"""The lifetime of a fleet topic's device state, on the host: a batch fleet
closes each topic's backend when that topic's pass ends (however it ended),
before the next admission, and books ``kta_fleet_backends_released_total``;
a fleet follow keeps its backends for the next pass.  `TorchBackend.close`
frees the state at once and once.  Backends on the card lease their CUDA
stream from the process's pool (`gpu.StreamPool`) and give it back at close,
so the next topic's state reuses the freed memory on the same stream.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import pytest

from fake_broker import CorruptionInjector, FakeBroker
from kafka_topic_analyzer_tpu_torch.backends import gpu
from kafka_topic_analyzer_tpu_torch.backends.base import resident_bytes_live
from kafka_topic_analyzer_tpu_torch.backends.gpu import StreamPool, TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, FollowConfig
from kafka_topic_analyzer_tpu_torch.fleet.scheduler import FleetScheduler, TopicSeed
from kafka_topic_analyzer_tpu_torch.fleet.service import FleetService
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.report import render_telemetry_stats
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state

TOPICS = ["rel.a", "rel.b", "rel.c", "rel.d"]
N_PARTS = 2
CFG = dict(batch_size=64, count_alive_keys=True, alive_bitmap_bits=16, enable_hll=True,
           hll_p=8, enable_quantiles=True)
FAST_RETRY = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}


def _records(salt: int, partition: int, n: int = 150):
    sizes = np.random.default_rng([salt, partition]).integers(15, 26, size=n)
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{salt}-{partition}-{i % 13}".encode() if i % 5 else None,
             bytes(int(sizes[i])) if i % 7 else None) for i in range(n)]


def _broker(**kw) -> FakeBroker:
    topics = {t: {p: _records(i, p) for p in range(N_PARTS)} for i, t in enumerate(TOPICS)}
    return FakeBroker(TOPICS[0], topics[TOPICS[0]],
                      extra_topics={t: topics[t] for t in TOPICS[1:]},
                      max_records_per_fetch=48, **kw)


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    yield
    default_registry().reset()
    serve_state.set_active(None)


class _Recorder:
    """A backend factory that logs, in order, each admission, each backend's
    construction and each close, with the thread that made it."""

    def __init__(self, monkeypatch):
        self.log: "list[tuple]" = []
        self.backends: "list[TorchBackend]" = []
        self._lock = threading.Lock()
        real_close = TorchBackend.close

        def close(backend):
            self._note("close", backend.topic)
            real_close(backend)

        monkeypatch.setattr(TorchBackend, "close", close)

    def _note(self, *what) -> None:
        with self._lock:
            self.log.append((*what, threading.get_ident()))

    def factory(self, topic, parts, grant):
        backend = TorchBackend(AnalyzerConfig(num_partitions=parts, **CFG),
                               init_now_s=10**10, device="cpu")
        backend.topic = topic
        self.backends.append(backend)
        self._note("build", topic)
        return backend

    def scheduler(self, *budgets) -> FleetScheduler:
        scheduler = FleetScheduler(*budgets)
        real_admit = scheduler.admit

        def admit(ready, *a, **k):
            grants = real_admit(ready, *a, **k)
            self._note("admit", tuple(sorted(grants)))
            return grants

        scheduler.admit = admit
        return scheduler


def _service(broker, recorder: _Recorder, follow=None) -> FleetService:
    def source(topic):
        return KafkaWireSource(f"127.0.0.1:{broker.port}", topic, overrides=dict(FAST_RETRY))

    # Four topics, two dispatch tokens: two admission rounds.
    return FleetService([TopicSeed(name=t, partitions=N_PARTS) for t in TOPICS], source,
                        recorder.factory, 64, recorder.scheduler(4, 2, 4), follow=follow)


def test_a_batch_fleet_closes_each_backend_at_its_pass_end(monkeypatch):
    rec = _Recorder(monkeypatch)
    # The first topic's first fetch is poisoned: its pass raises.
    corruption = CorruptionInjector().corrupt_length(partition=0, chunk=0)
    with _broker(corruption=corruption) as broker:
        svc = _service(broker, rec)
        fr = svc.run_batch()
    assert fr.statuses[TOPICS[0]].status == "failed"
    assert all(fr.statuses[t].status == "ok" for t in TOPICS[1:])
    assert len(rec.backends) == len(TOPICS)
    assert all(scan.backend is None for scan in svc.scans.values())
    assert all(b.state is None for b in rec.backends)
    log = rec.log
    admits = [i for i, e in enumerate(log) if e[0] == "admit"]
    assert len(admits) == 2
    for topic in TOPICS:
        (built,) = [i for i, e in enumerate(log) if e[:2] == ("build", topic)]
        (closed,) = [i for i, e in enumerate(log) if e[:2] == ("close", topic)]
        # Closed once, on the pass's own thread, before the next admission.
        assert built < closed and log[built][2] == log[closed][2]
        assert all(not built < a < closed for a in admits)
        later = [a for a in admits if a > built]
        assert not later or closed < later[0]
    # The topics that passed, the failed one too.
    assert obs_metrics.FLEET_BACKENDS_RELEASED.value == len(TOPICS)
    assert (f"fleet: {len(TOPICS)} topic backend(s) released at the end of their pass"
            in render_telemetry_stats(default_registry().snapshot()))


def test_a_close_that_raises_keeps_the_result_and_books_no_release(monkeypatch, caplog):
    rec = _Recorder(monkeypatch)
    recorded_close = TorchBackend.close

    def close(backend):
        recorded_close(backend)
        if backend.topic == TOPICS[1]:
            raise RuntimeError("the drain failed")

    monkeypatch.setattr(TorchBackend, "close", close)
    with _broker() as broker:
        svc = _service(broker, rec)
        fr = svc.run_batch()
    assert all(fr.statuses[t].status == "ok" for t in TOPICS)
    assert all(scan.backend is None for scan in svc.scans.values())
    assert obs_metrics.FLEET_BACKENDS_RELEASED.value == len(TOPICS) - 1
    assert f"closing the backend of topic {TOPICS[1]!r} failed" in caplog.text


def test_a_fleet_follow_keeps_its_backends_between_passes(monkeypatch):
    rec = _Recorder(monkeypatch)
    follow = FollowConfig(poll_interval_s=0.02, idle_backoff_max_s=0.05, idle_exit_s=0.2)
    with _broker() as broker:
        svc = _service(broker, rec, follow=follow)
        fr = svc.run_follow()
    # Each topic's scan pass and its shutdown pass ran on one backend.
    assert all(fr.statuses[t].status == "ok" and fr.statuses[t].passes >= 2 for t in TOPICS)
    assert sorted(b.topic for b in rec.backends) == TOPICS
    assert not [e for e in rec.log if e[0] == "close"]
    assert all(svc.scans[b.topic].backend is b and b.state is not None
               for b in rec.backends)
    assert obs_metrics.FLEET_BACKENDS_RELEASED.value == 0
    assert "fleet:" not in render_telemetry_stats(default_registry().snapshot())


def test_close_frees_the_state_at_once_and_once():
    gc.collect()
    before = resident_bytes_live()
    config = AnalyzerConfig(num_partitions=2, **dict(CFG, alive_bitmap_bits=20))
    backend = TorchBackend(config, init_now_s=10**10, device="cpu")
    source = SyntheticSource(SyntheticSpec(num_partitions=2, messages_per_partition=100,
                                           keys_per_partition=10, seed=3))
    batch = next(source.batches(64))
    backend.update(batch)
    assert resident_bytes_live() > before
    gc.disable()
    try:
        backend.close()
        # Off the live sum with no collection.
        assert resident_bytes_live() == before
        assert backend.state is None
        backend.close()
        assert resident_bytes_live() == before
    finally:
        gc.enable()
    for call in (lambda: backend.update(batch), backend.get_state, backend.finalize,
                 lambda: backend.prepare(batch)):
        with pytest.raises(RuntimeError, match="backend is closed"):
            call()
    # The collection books nothing twice.
    del backend
    gc.collect()
    assert resident_bytes_live() == before


class _FakeStream:
    def __init__(self, device):
        self.device = device


def test_the_stream_pool_hands_a_given_back_stream_to_the_next_lease(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    pool = StreamPool()
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    first = pool.lease(dev0)
    pool.give_back(first)
    # In turn: the same stream; at once: two; per device.
    assert pool.lease(dev0) is first
    second = pool.lease(dev0)
    assert second is not first and second.device == dev0
    pool.give_back(second)
    pool.give_back(first)
    assert pool.lease(dev1) not in (first, second)
    assert pool.lease(dev0) is first and pool.lease(dev0) is second


@pytest.mark.cuda
def test_pooled_backends_reuse_a_freed_stream_and_its_memory():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = AnalyzerConfig(num_partitions=1, **dict(CFG, alive_bitmap_bits=30))

    def backend():
        return TorchBackend(config, init_now_s=10**10, device="cuda", pooled_stream=True)

    a = backend()
    stream = a.stream
    a.close()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    # Two passes in turn: the same stream, and the state (an exact alive
    # set at 2^30 slots) lands in the blocks the first one freed.
    b = backend()
    assert b.stream is stream
    assert torch.cuda.memory_reserved() == reserved
    # Two at once: two streams.
    c = backend()
    assert c.stream is not b.stream
    b.close()
    c.close()
    again = gpu.STREAM_POOL.lease(torch.device("cuda", torch.cuda.current_device()))
    gpu.STREAM_POOL.give_back(again)
    assert again in (b.stream, c.stream)
