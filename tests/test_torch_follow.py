"""Follow mode in the port (``serve/follow.py``, ``serve/windows.py``, the
engine's pass hooks, ``--follow`` in the CLI) against the reference's.

The same seeded topic (``tests/fake_broker.FakeBroker``) is followed by
the reference's `FollowService` (its JAX backend on the CPU) and by the
port's (`TorchBackend` with ``device="cpu"``): phase 1 is served at
start, phase 2 is produced once phase 1's report is published, the
services stop once the whole topic is folded.  Tolerances: exact for
every count and report line (the metric documents, the ``follow`` block
but for its poll count, the ``windows`` block's records), byte-equal for
the rendered reports; no sketch is compared within a budget here — on
the CPU both backends give the same registers and sketch lines.

Also: the follow identity matrix over ingest workers × superbatch K in
both wire formats (the port's follow equals its own batch scan of the
whole topic, which equals the reference's), one backend re-entered
across passes with nothing re-allocated, SIGTERM → final checkpoint →
resume, a follow resuming a batch snapshot written by the other package,
the window-ring algebra against the reference's, the watermark refresh
through a broker outage, the rule for a watermark that moves backwards
(held once, then adopted; against the reference's), and the CLI's
refusals.  Every wait has a deadline.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from fake_broker import FakeBroker
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.config import FollowConfig as RefFollowConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefWireSource
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu.serve import state as ref_serve_state
from kafka_topic_analyzer_tpu.serve.follow import FollowService as RefFollowService
from kafka_topic_analyzer_tpu.serve.windows import WindowState as RefWindowState
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.checkpoint import snapshot_info
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    DispatchConfig,
    FollowConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.serve import state as serve_state
from kafka_topic_analyzer_tpu_torch.serve.follow import FollowService
from kafka_topic_analyzer_tpu_torch.serve.windows import (
    WindowObserver,
    WindowRing,
    WindowState,
)

TOPIC = "follow.topic"
FAST_RETRY = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}
FAST_FOLLOW = dict(poll_interval_s=0.02, idle_backoff_max_s=0.05,
                   window_secs=5.0, window_count=4)
N_PARTS = 3
PHASE1_N = 120
PHASE2_N = 60
TOTAL = N_PARTS * (PHASE1_N + PHASE2_N)


def _mk_records(partition: int, lo: int, n: int):
    return [
        (
            i,
            1_600_000_000_000 + i * 1000,
            f"k{partition}-{i % 23}".encode() if i % 5 else None,
            bytes(20 + (i % 13)) if i % 7 else None,
        )
        for i in range(lo, lo + n)
    ]


PHASE1 = {p: _mk_records(p, 0, PHASE1_N) for p in range(N_PARTS)}
PHASE2 = {p: _mk_records(p, PHASE1_N, PHASE2_N) for p in range(N_PARTS)}
FULL = {p: PHASE1[p] + PHASE2[p] for p in range(N_PARTS)}
CFG = dict(num_partitions=N_PARTS, batch_size=64, count_alive_keys=True,
           alive_bitmap_bits=16, enable_hll=True, hll_p=8,
           enable_quantiles=True, quantiles_per_partition=True)


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()
    serve_state.set_active(None)
    ref_serve_state.set_active(None)


def _port_backend(wire=5, workers_k=1, **kw):
    return TorchBackend(
        AnalyzerConfig(**CFG, wire_format=wire), init_now_s=10**10,
        device="cpu", dispatch=DispatchConfig(superbatch=workers_k), **kw,
    )


def _doc(result) -> dict:
    return result.metrics.to_dict(result.start_offsets, result.end_offsets)


def _wait_for(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _published(svc) -> int:
    doc = svc.state.snapshot()
    return doc["overall"]["count"] if doc else -1


def _follow(svc_factory, wire_source, mid_follow=None, stop_at=TOTAL):
    """Serve PHASE1, wait for its report, produce PHASE2, wait until
    ``stop_at`` records are published, stop; (result, service)."""
    with FakeBroker(TOPIC, PHASE1, max_records_per_fetch=48) as broker:
        src = wire_source(f"127.0.0.1:{broker.port}", TOPIC,
                          overrides=dict(FAST_RETRY))
        svc = svc_factory(src)
        errors = []

        def steer():
            try:
                _wait_for(lambda: _published(svc) >= N_PARTS * PHASE1_N,
                          what="phase-1 report")
                if mid_follow is not None:
                    mid_follow(broker, svc)
                for p in range(N_PARTS):
                    broker.produce(p, PHASE2[p])
                _wait_for(lambda: _published(svc) >= stop_at,
                          what="phase-2 report")
            except BaseException as e:  # surfaced after the join
                errors.append(e)
            finally:
                svc.request_stop("test")

        t = threading.Thread(target=steer)
        t.start()
        result = svc.run()
        t.join(timeout=60)
        src.close()
        if errors:
            raise errors[0]
    return result, svc


@pytest.fixture(scope="module")
def reference_follow():
    """The reference's follow of the topic (JAX backend on the CPU): the
    metric document, the follow block and the windows' record count."""
    ref_registry().reset()
    result, svc = _follow(
        lambda src: RefFollowService(
            TOPIC, src, TpuBackend(RefConfig(**CFG), init_now_s=10**10), 64,
            RefFollowConfig(**FAST_FOLLOW),
        ),
        RefWireSource,
    )
    final = svc.state.snapshot()
    ref_serve_state.set_active(None)
    return _doc(result), svc.follow_block(), final["windows"]["merged"]["records"]


@pytest.mark.parametrize("wire,workers,superbatch", [
    (5, 1, 1), (5, 4, 1), (5, 1, 4), (5, 4, 4), (4, 1, 1), (4, 4, 4),
])
def test_follow_identity_matrix(reference_follow, wire, workers, superbatch):
    """Followed to the end == the reference's follow == the port's batch
    scan of the whole topic, across ingest workers × superbatch K in
    both wire formats."""
    ref_doc, ref_block, ref_windowed = reference_follow
    backend = _port_backend(wire, superbatch)
    result, svc = _follow(
        lambda src: FollowService(TOPIC, src, backend, 64,
                                  FollowConfig(**FAST_FOLLOW),
                                  ingest_workers=workers),
        KafkaWireSource,
    )
    assert _doc(result) == ref_doc
    assert svc.passes >= 2
    block = svc.follow_block()
    assert {k: v for k, v in block.items() if k not in ("polls", "passes")} \
        == {k: v for k, v in ref_block.items() if k not in ("polls", "passes")}
    assert svc.state.snapshot()["windows"]["merged"]["records"] == ref_windowed
    assert ref_windowed == N_PARTS * PHASE2_N
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=dict(FAST_RETRY))
        batch = run_scan(TOPIC, src, _port_backend(wire, superbatch), 64,
                         ingest_workers=workers)
        src.close()
    assert _doc(batch) == ref_doc


def test_follow_reenters_one_backend_without_reallocating():
    """Every pass folds into the same state tensors through the same
    staging rings, dispatch queue and stager: nothing is built per pass."""
    backend = _port_backend(5, 2)
    # The big leaves fold in place (the bitmap above all: 512 MiB at 2^32
    # bits); the per-partition extremes are replaced by every fold, pass
    # or not, and are a few bytes.
    ptrs = {k: v.data_ptr() for k, v in _state_tensors(backend.state).items()
            if v.numel() > N_PARTS}
    assert "alive.words" in ptrs
    queue, stager = backend._queue, backend._stager
    result, svc = _follow(
        lambda src: FollowService(TOPIC, src, backend, 64,
                                  FollowConfig(**FAST_FOLLOW), ingest_workers=2),
        KafkaWireSource,
    )
    assert svc.passes >= 3  # initial, at least one tail, final
    assert backend.rings_allocated == 2  # one per ingest worker, ever
    assert backend._queue is queue and backend._stager is stager
    assert {k: v.data_ptr() for k, v in _state_tensors(backend.state).items()
            if k in ptrs} == ptrs
    assert result.metrics.overall_count == TOTAL


def _state_tensors(state) -> dict:
    import dataclasses

    import torch

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in _state_tensors(v).items()})
    return out


def test_sigterm_checkpoint_resume_roundtrip(tmp_path, reference_follow):
    """SIGTERM lands a final checkpoint and a clean stop; a restarted
    service resumes it against the grown topic with no loss and no
    double count."""
    ref_doc = reference_follow[0]
    snap = str(tmp_path / "snaps")
    follow = FollowConfig(**dict(FAST_FOLLOW, checkpoint_every_s=0.0))
    with FakeBroker(TOPIC, PHASE1, max_records_per_fetch=48) as broker:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=dict(FAST_RETRY))
        svc = FollowService(TOPIC, src, _port_backend(), 64, follow,
                            snapshot_dir=snap)
        restore = svc.install_signal_handlers()
        try:
            killer = threading.Thread(target=lambda: (
                _wait_for(lambda: _published(svc) >= N_PARTS * PHASE1_N,
                          what="phase-1 report"),
                os.kill(os.getpid(), signal.SIGTERM),
            ))
            killer.start()
            result1 = svc.run()
            killer.join(timeout=60)
        finally:
            restore()
        src.close()
    assert svc._stop_reason == "SIGTERM"
    assert result1.metrics.overall_count == N_PARTS * PHASE1_N
    info = snapshot_info(snap)
    assert info["records_seen"] == N_PARTS * PHASE1_N
    assert info["next_offsets"] == {str(p): PHASE1_N for p in range(N_PARTS)}
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=dict(FAST_RETRY))
        svc2 = FollowService(TOPIC, src, _port_backend(), 64,
                             FollowConfig(**dict(FAST_FOLLOW, idle_exit_s=0.2)),
                             snapshot_dir=snap, resume=True)
        result2 = svc2.run()
        src.close()
    assert svc2._stop_reason == "idle"
    assert _doc(result2) == ref_doc


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_follow_resumes_a_batch_snapshot_of_either_package(
        tmp_path, reference_follow, writer):
    """A snapshot a batch scan wrote (in this package or the reference)
    seeds a port follow service; the other direction: a port follow's
    checkpoint resumes in the reference's batch scan."""
    ref_doc = reference_follow[0]
    snap = str(tmp_path / "snaps")
    with FakeBroker(TOPIC, PHASE1, max_records_per_fetch=48) as broker:
        addr = f"127.0.0.1:{broker.port}"
        if writer == "ref":
            src = RefWireSource(addr, TOPIC, overrides=dict(FAST_RETRY))
            ref_run_scan(TOPIC, src, TpuBackend(RefConfig(**CFG), init_now_s=10**10),
                         64, snapshot_dir=snap, snapshot_every_s=0.0)
        else:
            src = KafkaWireSource(addr, TOPIC, overrides=dict(FAST_RETRY))
            run_scan(TOPIC, src, _port_backend(), 64, snapshot_dir=snap,
                     snapshot_every_s=0.0)
        src.close()
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=dict(FAST_RETRY))
        svc = FollowService(TOPIC, src, _port_backend(), 64,
                            FollowConfig(**dict(FAST_FOLLOW, idle_exit_s=0.2)),
                            snapshot_dir=snap, resume=True)
        result = svc.run()
        src.close()
        assert _doc(result) == ref_doc
        # The follow's final checkpoint (idle exit) is the whole topic:
        # the reference resumes it and folds nothing new.
        src = RefWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                            overrides=dict(FAST_RETRY))
        again = ref_run_scan(TOPIC, src,
                             TpuBackend(RefConfig(**CFG), init_now_s=10**10),
                             64, snapshot_dir=snap, resume=True)
        src.close()
    assert _doc(again) == ref_doc


def test_report_json_served_while_folding(reference_follow):
    """``/report.json`` answers from the published snapshot mid-follow;
    windows describe the live tail only."""
    from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter
    import urllib.request

    exporter = PrometheusExporter(0)
    url = f"http://127.0.0.1:{exporter.port}/report.json"
    scraped = []
    try:
        def mid(broker, svc):
            with urllib.request.urlopen(url, timeout=5) as resp:
                scraped.append(json.loads(resp.read()))

        result, svc = _follow(
            lambda src: FollowService(TOPIC, src, _port_backend(), 64,
                                      FollowConfig(**FAST_FOLLOW)),
            KafkaWireSource, mid_follow=mid,
        )
    finally:
        exporter.close()
    doc = scraped[0]
    assert doc["topic"] == TOPIC
    assert doc["overall"]["count"] >= N_PARTS * PHASE1_N
    assert {"follow", "windows", "flight", "wire"} <= set(doc)
    final = svc.state.snapshot()
    assert final["overall"]["count"] == TOTAL
    assert final["windows"]["merged"]["records"] == N_PARTS * PHASE2_N
    assert final["duration_secs"] == result.duration_secs
    assert _doc(result) == reference_follow[0]


def test_follow_lifecycle_events_do_not_flood():
    events = []
    sink = lambda etype, fields: events.append((etype, fields))  # noqa: E731
    obs_events.add_sink(sink)
    try:
        result, svc = _follow(
            lambda src: FollowService(
                TOPIC, src, CpuExactBackend(AnalyzerConfig(**CFG), init_now_s=10**10),
                64, FollowConfig(**dict(FAST_FOLLOW, poll_interval_s=0.005,
                                        idle_backoff_max_s=0.01)),
            ),
            KafkaWireSource,
        )
    finally:
        obs_events.remove_sink(sink)
    kinds = [e for e, _ in events]
    assert kinds.count("scan_start") == 1 and kinds.count("scan_end") == 1
    assert kinds.count("follow_stop") == 1
    polls = [f for e, f in events if e == "follow_poll"]
    assert 1 <= len(polls) <= svc.passes
    assert all(f["new_records"] > 0 for f in polls)
    assert kinds.count("heartbeat") <= 2
    assert obs_metrics.FOLLOW_LAG.value == 0
    assert result.metrics.overall_count == TOTAL


def test_follow_empty_topic_waits_for_first_record():
    empty = {p: [] for p in range(N_PARTS)}
    with FakeBroker(TOPIC, empty, max_records_per_fetch=48) as broker:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=dict(FAST_RETRY))
        assert src.is_empty()
        svc = FollowService(TOPIC, src, _port_backend(), 64,
                            FollowConfig(**FAST_FOLLOW))

        def steer():
            try:
                _wait_for(lambda: svc.state.snapshot() is not None,
                          what="empty initial report")
                broker.produce(0, PHASE2[0])
                _wait_for(lambda: _published(svc) >= PHASE2_N,
                          what="first records")
            finally:
                svc.request_stop("test")

        t = threading.Thread(target=steer)
        t.start()
        result = svc.run()
        t.join(timeout=60)
        src.close()
    assert result.metrics.overall_count == PHASE2_N
    assert result.next_offsets[0] == PHASE1_N + PHASE2_N


# ---------------------------------------------------------------------------
# the window ring against the reference's


def _batches(seed, n=64, parts=N_PARTS, count=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        key_null = rng.random(n) < 0.2
        out.append(dict(
            partition=rng.integers(0, parts, n).astype(np.int32),
            key_len=np.where(key_null, 0, rng.integers(1, 20, n)).astype(np.int32),
            value_len=rng.integers(0, 500, n).astype(np.int32),
            key_null=key_null,
            value_null=rng.random(n) < 0.1,
            ts_s=np.full(n, 1_600_000_000, dtype=np.int64),
            key_hash32=rng.integers(0, 2**32, n, dtype=np.uint32),
            key_hash64=rng.integers(0, 2**63, n, dtype=np.uint64),
            valid=rng.random(n) < 0.95,
        ))
    return out


def _state(cls, batch_cls, seed, p=6):
    st = cls(N_PARTS, hll_p=p)
    for cols in _batches(seed):
        b = batch_cls(**cols)
        st.observe(b.partition.astype(np.int64), b)
    return st


def _tuple(st):
    return (st.records.tolist(), st.bytes.tolist(), st.tombstones.tolist(),
            st.hll.tolist(), st.size_hist.tolist())


def test_window_state_merge_algebra_equals_the_reference():
    a, b, c = (_state(WindowState, RecordBatch, s) for s in (1, 2, 3))
    ra, rb, rc = (_state(RefWindowState, RefBatch, s) for s in (1, 2, 3))
    assert _tuple(a.merge(b).merge(c)) == _tuple(a.merge(b.merge(c)))
    assert _tuple(a.merge(b)) == _tuple(b.merge(a))
    assert _tuple(a.merge(WindowState(N_PARTS, hll_p=6))) == _tuple(a)
    assert _tuple(a.merge(b).merge(c)) == _tuple(ra.merge(rb).merge(rc))
    assert a.merge(c).cardinality() == ra.merge(rc).cardinality()
    assert a.as_dict([0, 1, 2], 7.0) == ra.as_dict([0, 1, 2], 7.0)


def test_window_ring_rotation_prunes_by_index():
    now = [0.0]
    ring = WindowRing([0, 1, 2], window_secs=10.0, window_count=3, hll_p=6,
                      clock=lambda: now[0])
    batches = [RecordBatch(**cols) for cols in _batches(9, count=8)]
    ring.observe_batch(batches[0])
    now[0] = 101.0  # a long quiet gap: the old window aged out
    ring.observe_batch(batches[1])
    rep = ring.report()
    assert [w["window"] for w in rep["windows"]] == [10]
    assert rep["merged"]["records"] == int(batches[1].valid.sum())
    assert ring.coverage_s() == pytest.approx(30.0)
    for wi in range(11, 16):
        now[0] = wi * 10.0 + 1
        ring.observe_batch(batches[wi - 9])
    assert [w["window"] for w in ring.report()["windows"]] == [13, 14, 15]


def test_window_observer_passes_batches_through_and_bypasses_fused():
    """The observer folds every batch it forwards, unchanged, and drops
    the fused ``sink=`` on purpose: the engine's gate sees it and books
    ``source-unfusable`` once per service run."""
    from kafka_topic_analyzer_tpu_torch.engine import fused_gate

    class _Src:
        supports_fused_sink = True

        def partitions(self):
            return [0, 1, 2]

        def batches(self, batch_size, partitions=None, start_at=None, sink=None):
            for cols in _batches(5, count=3):
                yield RecordBatch(**cols)

    ring = WindowRing([0, 1, 2], window_secs=60, window_count=2, hll_p=6)
    obs = WindowObserver(_Src(), ring)
    seen = list(obs.batches(64))
    for got, cols in zip(seen, _batches(5, count=3)):
        for name, value in cols.items():
            np.testing.assert_array_equal(getattr(got, name), value)
    assert ring.merged().records.sum() == sum(int(b.valid.sum()) for b in seen)
    backend = _port_backend()
    backend.use_native = True
    assert obs.supports_fused_sink and not fused_gate(obs, backend)


# ---------------------------------------------------------------------------
# the head: watermark refresh


def test_watermark_refresh_sees_the_head_and_survives_an_outage():
    overrides = dict(FAST_RETRY, **{"transport.retry.budget": "2"})
    broker = FakeBroker(TOPIC, PHASE1).start()
    try:
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", TOPIC,
                              overrides=overrides)
        start0, end0 = src.watermarks()
        broker.produce(0, PHASE2[0])
        assert src.watermarks()[1] == end0  # the cached snapshot stays
        start1, end1 = src.refresh_watermarks()
        assert end1[0] == PHASE1_N + PHASE2_N and src.watermarks()[1] == end1
        fails0 = obs_metrics.WATERMARK_REFRESH_FAILURES.value
        broker.kill()  # every re-poll attempt fails
        assert src.refresh_watermarks() == (start1, end1)
        assert obs_metrics.WATERMARK_REFRESH_FAILURES.value == fails0 + 1
        src.close()
    finally:
        broker.stop()


# ---------------------------------------------------------------------------
# the CLI


def _cli(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_follow_json_equals_the_reference(capsys):
    argv = ["-t", TOPIC, "--librdkafka", "retry.backoff.ms=5,reconnect.backoff.max.ms=40",
            "--follow", "--follow-idle-exit", "0.15", "--poll-interval", "0.02",
            "--window-secs", "5", "--json", "--quiet", "-c",
            "--alive-bitmap-bits", "16", "--batch-size", "64",
            "--metrics-port", "0", "--sse", "--stats"]
    out = {}
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                  ("ref", ref_cli.main, ["--backend", "tpu"])):
            default_registry().reset()
            ref_registry().reset()
            out[name] = _cli(main, argv + ["-b", f"127.0.0.1:{broker.port}"] + extra,
                             capsys)
    (prc, pout, perr), (rrc, rout, rerr) = out["port"], out["ref"]
    assert prc == rrc == 0
    port, ref = (json.loads(o.strip().splitlines()[-1]) for o in (pout, rout))
    assert port.keys() == ref.keys()
    for key in ref:
        if key in ("duration_secs", "flight", "telemetry", "health", "follow"):
            continue
        assert port[key] == ref[key], key
    drop = ("polls",)
    assert {k: v for k, v in port["follow"].items() if k not in drop} == \
        {k: v for k, v in ref["follow"].items() if k not in drop}
    assert port["overall"]["count"] == TOTAL
    assert port["windows"]["merged"]["records"] == 0  # all caught up at start
    assert port["health"]["healthy"] is ref["health"]["healthy"] is True
    assert "  follow: " in perr and "HEALTH: ok" in perr


def test_cli_follow_report_equals_the_reference(capsys):
    argv = ["-t", TOPIC, "--librdkafka", "retry.backoff.ms=5",
            "--follow", "--follow-idle-exit", "0.1", "--poll-interval", "0.02",
            "--quiet", "-c", "--alive-bitmap-bits", "16", "--batch-size", "64",
            "--distinct-keys", "--quantiles"]
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        b = ["-b", f"127.0.0.1:{broker.port}"]
        prc, pout, _ = _cli(cli.main, argv + b + ["--device", "cpu"], capsys)
        rrc, rout, _ = _cli(ref_cli.main, argv + b + ["--backend", "tpu"], capsys)
    strip = lambda t: [l for l in t.splitlines()  # noqa: E731
                       if "Scanning took" not in l and "Estimated Msg" not in l]
    assert prc == rrc == 0
    assert strip(pout) == strip(rout)


@pytest.mark.parametrize("argv,needle", [
    (["-t", "a", "--source", "segfile", "--segment-dir", "x", "--follow"],
     "--follow cannot tail --source segfile"),
    # A topic list under --follow runs through the fleet, which reads
    # cluster metadata: a synthetic source is refused there.
    (["-t", "a,b", "--source", "synthetic", "--follow"],
     "--fleet requires --source kafka"),
])
def test_cli_follow_refusals(argv, needle, capsys):
    rc, out, err = _cli(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 1 and out == ""
    assert err.startswith("error: ") and needle in err
    rrc, _, rerr = _cli(ref_cli.main, argv, capsys)
    assert (rrc, rerr) == (rc, err)  # the reference's message, verbatim


class _ScriptedHead:
    """A source whose watermark re-polls answer from a script (a stale
    replica, then a truncation adopted)."""

    def __init__(self, answers):
        self.answers = list(answers)

    def partitions(self):
        return [0, 1]

    def watermarks(self):
        return {0: 0, 1: 0}, {0: 100, 1: 100}

    def refresh_watermarks(self):
        return {0: 0, 1: 0}, dict(self.answers.pop(0))


def test_watermark_regression_is_held_once_then_adopted():
    """An end watermark that moves backwards is held for one poll (a
    stale answer heals by the next refresh) and adopted on the second
    (a truncation); both packages book and emit the same."""
    from kafka_topic_analyzer_tpu.obs import events as ref_events
    from kafka_topic_analyzer_tpu.obs import metrics as ref_metrics

    script = [{0: 100, 1: 100}, {0: 90, 1: 100}, {0: 100, 1: 100},
              {0: 90, 1: 100}, {0: 80, 1: 100}, {0: 120, 1: 130}]
    seen = {}
    for name, service, cfg, events, metrics in (
            ("port", FollowService, FollowConfig, obs_events, obs_metrics),
            ("ref", RefFollowService, RefFollowConfig, ref_events, ref_metrics)):
        log = []
        sink = lambda etype, fields: log.append((etype, fields))  # noqa: E731
        events.add_sink(sink)
        try:
            svc = service(TOPIC, _ScriptedHead(script), None, 64,
                          cfg(window_count=0), publish_reports=False)
            svc.cursor = {0: 60, 1: 60}
            lags = [svc._poll() for _ in script]
        finally:
            events.remove_sink(sink)
        seen[name] = (lags, dict(svc._last_end),
                      metrics.LOG_WATERMARK_REGRESSIONS.value,
                      [f for e, f in log if e == "watermark_regression"])
    assert seen["port"] == seen["ref"]
    lags, last_end, regressions, emitted = seen["port"]
    # held at 100 (lag 40+40), healed, held again, then 80 adopted.
    assert lags == [80, 80, 80, 80, 60, 130]
    assert last_end == {0: 120, 1: 130}
    assert regressions == 3
    assert [f["held"] for f in emitted] == [True, True, False]


@pytest.mark.parametrize("flags,encoding", [([], "gzip"), (["--no-serve-gzip"], None)],
                         ids=["gzip", "no-serve-gzip"])
def test_cli_follow_serves_report_json(capsys, flags, encoding):
    """The CLI's follow service serves ``/report.json`` on
    ``--metrics-port``: gzip to a gzip reader unless ``--no-serve-gzip``,
    and ``/healthz`` 200."""
    import socket
    import urllib.error
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {}

    def steer():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and "report" not in got:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/report.json",
                headers={"Accept-Encoding": "gzip"})
            try:
                with urllib.request.urlopen(req, timeout=5) as resp:
                    got["report"] = (resp.status, resp.headers.get("Content-Encoding"))
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                    got["healthz"] = resp.status
            except (urllib.error.URLError, OSError):
                time.sleep(0.01)

    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        t = threading.Thread(target=steer)
        t.start()
        rc = cli.main(["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}",
                       "--librdkafka", "retry.backoff.ms=5", "--follow",
                       "--follow-idle-exit", "1", "--poll-interval", "0.02",
                       "--metrics-port", str(port), "--quiet", "--device", "cpu",
                       *flags])
        t.join(timeout=60)
    capsys.readouterr()
    assert rc == 0
    assert got == {"report": (200, encoding), "healthz": 200}
