"""Partition-sharded parallel ingest (``--ingest-workers``): the port's
``parallel/ingest.py`` and engine fan-in against the reference's.

The merge order is a pure function of the inputs in both packages, so the
port's N-worker scan equals the reference's N-worker scan byte for byte —
alive keys included, on a spec whose keys share bitmap slots across
partitions (where the alive count depends on that order) — from a
synthetic topic, a segment-file dump and a fake Kafka broker.  Faults,
degradation and corruption confined to one worker give the reference's
result, snapshots stay fold-consistent across worker counts, a dying
worker aborts the scan without leaking threads, and the pinned staging
rings are never shared: N threads packing through one backend's
``prepare`` and fused sinks each get their own ring, and every row that
comes out is the row its worker packed.
"""

import contextlib
import os
import re
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fake_broker import (
    ChaosTrigger,
    CorruptionInjector,
    FakeBroker,
    FakeCluster,
    FaultInjector,
)
from kafka_topic_analyzer_tpu import checkpoint as ref_checkpoint
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.cpu import CpuExactBackend as RefOracle
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.config import CorruptionConfig as RefCorruptionConfig
from kafka_topic_analyzer_tpu.config import IngestConfig as RefIngestConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefKafkaSource
from kafka_topic_analyzer_tpu.io.segfile import SegmentFileSource as RefSegmentSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.parallel.ingest import shard_partitions as ref_shard
from kafka_topic_analyzer_tpu.report import render_report as ref_render_report
from kafka_topic_analyzer_tpu_torch import checkpoint, cli
from kafka_topic_analyzer_tpu_torch.backends import gpu
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, CorruptionConfig, IngestConfig
from kafka_topic_analyzer_tpu_torch.engine import PartitionIndex, run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.packing import (
    PackedRow,
    batch_alive_pairs,
    pack_batch,
    pack_pair_table,
)
from kafka_topic_analyzer_tpu_torch.parallel.ingest import ParallelIngest, shard_partitions
from kafka_topic_analyzer_tpu_torch.report import render_report
from kafka_topic_analyzer_tpu_torch.results import IngestStats
from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

pytestmark = pytest.mark.ingest

TOPIC = "pingest.t"
NOW = 10**10
FAST = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}
#: 2,000 partition-disjoint keys in a 2^10-slot bitmap: many slots are
#: written from several partitions, so the alive count follows the order.
SPEC = dict(num_partitions=5, messages_per_partition=1500, keys_per_partition=400,
            tombstone_permille=150, seed=3)
SHARED = dict(num_partitions=5, batch_size=256, count_alive_keys=True,
              alive_bitmap_bits=10, enable_hll=True, hll_p=10,
              quantiles_per_partition=True)


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def report(render, result) -> str:
    return drop_timing(render(TOPIC, result.metrics, result.start_offsets,
                              result.end_offsets, 0, show_alive_keys=True))


def kafka_rows(partition: int, n: int, shared: bool):
    """Keys per partition (``k<p>-<i>``) or shared by all (``k<i>``)."""
    prefix = "" if shared else f"{partition}-"
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{prefix}{i % 29}".encode() if i % 5 else None,
             bytes(20 + (i % 13)) if i % 7 else None) for i in range(n)]


# -- sharding and sizing -------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(parts=st.lists(st.integers(0, 10_000), unique=True, min_size=1, max_size=48),
       workers=st.integers(1, 12), data=st.data())
def test_shard_partitions_equals_the_reference(parts, workers, data):
    weights = data.draw(st.none() | st.fixed_dictionaries(
        {p: st.integers(0, 1_000_000) for p in parts}))
    got = shard_partitions(parts, workers, weights=weights)
    assert got == ref_shard(parts, workers, weights=weights)
    assert sorted(p for g in got for p in g) == sorted(parts)


@pytest.mark.parametrize("spec", ["1", "3", "8", "auto", " AUTO ", "0", "-2", "many", ""])
def test_ingest_config_equals_the_reference(spec):
    def outcome(cls):
        try:
            cfg = cls.parse(spec)
        except ValueError as e:
            return "error", str(e)
        return [cfg.resolve(n) for n in (1, 4, 64, 10**6)]

    assert outcome(IngestConfig) == outcome(RefIngestConfig)


# -- N workers: the reference's N-worker scan, byte for byte ---------------------

@pytest.fixture(scope="module")
def seg_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("segs"))
    make_segments(out, TOPIC, SyntheticSpec(**SPEC), batch_size=700)
    return out


@contextlib.contextmanager
def source_pair(kind: str, seg_dir: str):
    """(port source factory, reference source factory) for ``kind``."""
    if kind == "synthetic":
        yield (lambda: SyntheticSource(SyntheticSpec(**SPEC)),
               lambda: RefSource(RefSpec(**SPEC)))
    elif kind == "segfile":
        yield (lambda: SegmentFileSource(seg_dir, topic=TOPIC),
               lambda: RefSegmentSource(seg_dir, topic=TOPIC))
    else:
        records = {p: kafka_rows(p, 600, shared=True) for p in range(5)}
        with FakeBroker(TOPIC, records, max_records_per_fetch=90) as b:
            where = f"127.0.0.1:{b.port}"
            yield (lambda: KafkaWireSource(where, TOPIC, overrides=dict(FAST)),
                   lambda: RefKafkaSource(where, TOPIC, overrides=dict(FAST)))


def port_backend(features, **kw):
    return TorchBackend(AnalyzerConfig(**features), init_now_s=NOW, device="cpu",
                        use_native=native.native_available(), **kw)


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["synthetic", "segfile", "kafka"])
def test_n_workers_equal_the_reference_n_workers(kind, workers, seg_dir):
    with source_pair(kind, seg_dir) as (port_src, ref_src):
        port_be = port_backend(SHARED)
        port = run_scan(TOPIC, port_src(), port_be, 256, ingest_workers=workers)
        ref_be = TpuBackend(RefConfig(**SHARED), init_now_s=NOW)
        ref = ref_run_scan(TOPIC, ref_src(), ref_be, 256, ingest_workers=workers)
    assert port.ingest_workers == ref.ingest_workers == workers
    assert report(render_report, port) == report(ref_render_report, ref)
    assert port.next_offsets == ref.next_offsets == ref.end_offsets
    flat = ref_checkpoint._flatten(jax.tree.map(np.asarray, ref_be.get_state()))
    got = port_be.get_state()
    for key, want in flat.items():
        np.testing.assert_array_equal(got[key[len("state."):]], want, err_msg=key)
    assert port.fused == (kind != "synthetic" and native.native_available())


def test_alive_keys_follow_the_merge_order_in_both_packages(seg_dir):
    """The caveat the merge shares with the reference: slots written
    from several partitions make the alive count depend on the order (of
    rows, here: fused rows of 256 records, merged round-robin), and the
    two packages agree on it at every worker count."""
    alive = {}
    for workers in (1, 2, 3, 4):
        src = SegmentFileSource(seg_dir, topic=TOPIC)
        alive[workers] = run_scan(TOPIC, src, port_backend(SHARED), 256,
                                  ingest_workers=workers).metrics.alive_keys
        ref = ref_run_scan(TOPIC, RefSegmentSource(seg_dir, topic=TOPIC),
                           TpuBackend(RefConfig(**SHARED), init_now_s=NOW), 256,
                           ingest_workers=workers)
        assert ref.metrics.alive_keys == alive[workers]
    assert len(set(alive.values())) > 1, alive


def test_workers_beyond_partitions_clamp():
    result = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                      port_backend(SHARED), 256, ingest_workers=99)
    assert result.ingest_workers == SPEC["num_partitions"]
    auto = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                    port_backend(SHARED), 256, ingest_workers="auto")
    assert auto.ingest_workers == IngestConfig("auto").resolve(SPEC["num_partitions"])


# -- faults confined to one worker ---------------------------------------------

CLEAN = dict(num_partitions=4, batch_size=128, count_alive_keys=True, alive_bitmap_bits=16)
RECORDS = {p: kafka_rows(p, 300, shared=False) for p in range(4)}


def both_at(workers, make_port_src, make_ref_src):
    """The port (torch backend on the CPU) and the reference (numpy
    oracle) scans at ``workers``; each factory may start a broker."""
    out = []
    for make, scan, backend, render in (
        (make_port_src, run_scan, lambda: port_backend(CLEAN), render_report),
        (make_ref_src, ref_run_scan,
         lambda: RefOracle(RefConfig(**CLEAN), init_now_s=NOW), ref_render_report),
    ):
        with make() as src:
            result = scan(TOPIC, src, backend(), 128, ingest_workers=workers)
        out.append((result, report(render, result)))
    return out


def test_transport_fault_in_one_worker_absorbed():
    """A connection kill mid-scan lands on one worker's stream; recovery
    keeps the 3-worker scan equal to the reference's and to 1 worker's."""
    def maker(cls):
        @contextlib.contextmanager
        def make():
            with FakeBroker(TOPIC, RECORDS, max_records_per_fetch=60) as broker:
                src = cls(f"127.0.0.1:{broker.port}", TOPIC, overrides=dict(FAST))
                yield ChaosTrigger(src, 2, lambda: setattr(
                    broker, "faults", FaultInjector().drop_connection(100, times=2)))
                src.close()
        return make

    (port, port_text), (ref, ref_text) = both_at(3, maker(KafkaWireSource),
                                                 maker(RefKafkaSource))
    (seq, seq_text), _ = both_at(1, maker(KafkaWireSource), maker(RefKafkaSource))
    assert not port.degraded_partitions and not ref.degraded_partitions
    assert port_text == ref_text == seq_text


class ArmOnFirstFetch(FaultInjector):
    """Inert until armed by one atomic ``Event.set()`` (the reference
    test's injector: a plain hand-off loses a GIL-preemption race)."""

    def __init__(self):
        super().__init__()
        self.armed = threading.Event()
        self.drop_connection(0, times=10**6)
        self.refuse_connections(times=10**6)

    def take_drop(self):
        return super().take_drop() if self.armed.is_set() else None

    def take_refusal(self):
        return super().take_refusal() if self.armed.is_set() else False


def test_degraded_partition_in_one_worker_matches_the_reference():
    """Node 1 dies for good at its first fetch: its partitions degrade
    inside whichever worker owns them, the others finish exact, and the
    3-worker scan degrades the reference's partitions with its counts."""
    def maker(cls):
        @contextlib.contextmanager
        def make():
            inj = ArmOnFirstFetch()

            def arm(api_key: int, node_id: int) -> float:
                if api_key == ref_kc.API_FETCH and node_id == 1:
                    inj.armed.set()
                return 0.0

            with FakeCluster(TOPIC, RECORDS, n_nodes=2, max_records_per_fetch=60,
                             response_delay=arm) as cluster:
                cluster.nodes[1].faults = inj
                src = cls(cluster.bootstrap, TOPIC, overrides=dict(
                    FAST, **{"transport.retry.budget": "3", "socket.timeout.ms": "500"}))
                yield src
                src.close()
        return make

    (port, port_text), (ref, ref_text) = both_at(3, maker(KafkaWireSource),
                                                 maker(RefKafkaSource))
    assert port.degraded_partitions
    assert set(port.degraded_partitions) == set(ref.degraded_partitions)
    for reason in port.degraded_partitions.values():
        assert "transport failures" in reason
    assert port_text == ref_text


def test_corruption_in_one_worker_matches_the_reference(tmp_path):
    """Deterministic poison in partition 1 (one worker's group at N=3)
    under quarantine: the report, the corrupt map and the spooled files
    are the reference's."""
    def maker(cls, config_cls, qdir):
        @contextlib.contextmanager
        def make():
            inj = (CorruptionInjector().flip_byte(1, chunk=1, offset=-1)
                   .flip_byte(1, chunk=3, offset=-3))
            with FakeBroker(TOPIC, RECORDS, max_records_per_fetch=50, corruption=inj,
                            honor_partition_max_bytes=True) as broker:
                src = cls(f"127.0.0.1:{broker.port}", TOPIC,
                          overrides=dict(FAST, **{"check.crcs": "true"}),
                          corruption=config_cls(policy="quarantine", quarantine_dir=qdir))
                yield src
                src.close()
        return make

    (port, port_text), (ref, ref_text) = both_at(
        3, maker(KafkaWireSource, CorruptionConfig, str(tmp_path / "port")),
        maker(RefKafkaSource, RefCorruptionConfig, str(tmp_path / "ref")))
    assert set(port.corrupt_partitions) == {1}
    assert port.corrupt_partitions == ref.corrupt_partitions
    assert port_text == ref_text
    spooled = sorted(os.listdir(tmp_path / "port"))
    assert spooled == sorted(os.listdir(tmp_path / "ref"))
    assert len([f for f in spooled if f.endswith(".bin")]) == 2


# -- snapshots under N workers -------------------------------------------------

def test_snapshot_offsets_identical_across_worker_counts(tmp_path):
    """Checkpoints stay fold-consistent per partition: the final
    snapshot's offsets and records_seen are the same at 1 and 3 workers,
    and the reference's."""
    def meta(scan, backend, workers, d):
        with FakeBroker(TOPIC, RECORDS, max_records_per_fetch=60) as broker:
            cls = KafkaWireSource if scan is run_scan else RefKafkaSource
            src = cls(f"127.0.0.1:{broker.port}", TOPIC, overrides=dict(FAST))
            scan(TOPIC, src, backend, 128, snapshot_dir=str(d), snapshot_every_s=0.0,
                 ingest_workers=workers)
            src.close()
        info = checkpoint.snapshot_info(str(d))
        return info["next_offsets"], info["records_seen"]

    one = meta(run_scan, port_backend(CLEAN), 1, tmp_path / "p1")
    three = meta(run_scan, port_backend(CLEAN), 3, tmp_path / "p3")
    ref = meta(ref_run_scan, TpuBackend(RefConfig(**CLEAN), init_now_s=NOW), 3,
               tmp_path / "r3")
    assert one == three == ref


#: The segment dump's features with a bitmap wide enough that no slot is
#: written from two partitions: the count is order-free, so an
#: interrupted scan resumed at another worker count must still agree.
CLEAN_SEG = dict(SHARED, alive_bitmap_bits=24)


class Interrupt(Exception):
    pass


class InterruptingSegments(SegmentFileSource):
    """Each first (not resumed) stream raises after ``limit`` items."""

    limit = 3

    def batches(self, batch_size, partitions=None, start_at=None, sink=None):
        for i, b in enumerate(super().batches(batch_size, partitions, start_at, sink)):
            if start_at is None and i >= self.limit:
                raise Interrupt()
            yield b


@pytest.mark.parametrize("workers, resume_workers", [(4, 4), (3, 1), (1, 2)])
def test_n_worker_scan_interrupted_and_resumed(workers, resume_workers, seg_dir, tmp_path):
    """An N-worker scan dies mid-stream: its snapshot, resumed at any
    worker count, gives the uninterrupted report of the resumed order."""
    full = run_scan(TOPIC, SegmentFileSource(seg_dir, topic=TOPIC),
                    port_backend(CLEAN_SEG), 256, ingest_workers=resume_workers)
    with pytest.raises(Interrupt):
        run_scan(TOPIC, InterruptingSegments(seg_dir, topic=TOPIC),
                 port_backend(CLEAN_SEG), 256, ingest_workers=workers,
                 snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
    seen = checkpoint.snapshot_info(str(tmp_path))["records_seen"]
    assert 0 < seen < 7500
    resumed = run_scan(TOPIC, SegmentFileSource(seg_dir, topic=TOPIC),
                       port_backend(CLEAN_SEG), 256, ingest_workers=resume_workers,
                       snapshot_dir=str(tmp_path), resume=True)
    assert resumed.records == 7500 - seen
    assert report(render_report, resumed) == report(render_report, full)



# -- the worker pool -------------------------------------------------------------

class Boom(Exception):
    pass


class ExplodingSource(SyntheticSource):
    """The stream owning ``bad`` dies after 2 batches; the others run
    clean."""

    def __init__(self, spec, bad: int):
        super().__init__(spec)
        self.bad = bad

    def batches(self, batch_size, partitions=None, start_at=None):
        it = super().batches(batch_size, partitions, start_at)
        if partitions is None or self.bad not in partitions:
            yield from it
            return
        for i, b in enumerate(it):
            if i >= 2:
                raise Boom()
            yield b


def test_worker_error_aborts_scan_without_leaks():
    spec = SyntheticSpec(num_partitions=4, messages_per_partition=4000)
    before = threading.active_count()
    with pytest.raises(Boom):
        run_scan(TOPIC, ExplodingSource(spec, bad=1),
                 port_backend(dict(num_partitions=4, batch_size=128)), 128,
                 ingest_workers=3)
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_pool_close_cancels_and_closes_streams():
    """Abandoning the fan-in mid-stream closes every worker's generator
    (GeneratorExit), not just the threads; close is idempotent."""
    closed = []

    class Tracking(SyntheticSource):
        def batches(self, batch_size, partitions=None, start_at=None):
            try:
                yield from super().batches(batch_size, partitions, start_at)
            finally:
                closed.append(tuple(partitions or ()))

    pool = ParallelIngest(Tracking(SyntheticSpec(num_partitions=3,
                                                 messages_per_partition=5000)),
                          64, shard_partitions([0, 1, 2], 3), depth=2)
    next(iter(pool))
    pool.close()
    pool.close()
    assert sorted(closed) == [(0,), (1,), (2,)]
    assert not any(w.is_alive() for w in pool.workers)


def test_per_worker_telemetry_recorded():
    default_registry().reset()
    result = run_scan(TOPIC, SyntheticSource(SyntheticSpec(num_partitions=4,
                                                           messages_per_partition=1000)),
                      port_backend(dict(num_partitions=4, batch_size=256)), 256,
                      ingest_workers=2)
    stats = IngestStats.from_telemetry(result.telemetry)
    assert stats.workers == {"0": 2000, "1": 2000}
    active = {s["labels"]["worker"]: s["value"] for s in
              result.telemetry["kta_ingest_worker_active_seconds_total"]["samples"]}
    assert set(active) == {"0", "1"} and all(v > 0 for v in active.values())
    resolved = result.telemetry["kta_ingest_resolved_workers"]["samples"][0]["value"]
    assert resolved == 2


def test_cli_rejects_bad_worker_spec(capsys):
    argv = ["-t", "t", "--source", "synthetic", "--synthetic",
            "partitions=4,messages=100", "--ingest-workers", "lots", "--quiet"]
    assert cli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert ref_cli.main(argv + ["--backend", "tpu"]) == 1
    assert capsys.readouterr().err == err
    assert "--ingest-workers" in err


def test_cli_workers_report_and_stats(capsys):
    argv = ["-t", "t", "--source", "synthetic", "--synthetic",
            "partitions=4,messages=2000,keys=300", "-c", "--alive-bitmap-bits", "20",
            "--ingest-workers", "3", "--quiet"]
    default_registry().reset()
    assert cli.main(argv + ["--device", "cpu", "--stats"]) == 0
    port = capsys.readouterr()
    assert ref_cli.main(argv + ["--backend", "tpu"]) == 0
    assert drop_timing(capsys.readouterr().out) == drop_timing(port.out)
    assert re.search(r"ingest: 3 worker\(s\) — records w0 \d+", port.err), port.err


def test_cli_stats_orders_twelve_workers_like_the_reference(capsys):
    """Worker labels sort naturally (w2 before w10), as in the reference's
    ``--stats`` digest: the ``ingest:`` lines name the same workers in the
    same order."""
    argv = ["-t", "t", "--source", "synthetic", "--synthetic",
            "partitions=12,messages=2000", "--ingest-workers", "12", "--stats",
            "--quiet"]
    lines = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (ref_cli.main, ["--backend", "tpu"])):
        default_registry().reset()
        assert main(argv + extra) == 0
        err = capsys.readouterr().err
        line = next(l for l in err.splitlines() if re.search(r"ingest: \d+ worker", l))
        lines.append(re.findall(r"\bw(\d+) ", line))
    assert lines[0] == lines[1] == [str(w) for w in range(12)]


# -- the staging rings ---------------------------------------------------------

def test_staging_rings_are_never_shared(seg_dir, monkeypatch):
    """Eight workers (more than this host's cores may be) pack through one
    backend with the shortest ring (3 slots) under a tiny switch
    interval: each ring is claimed from one thread only, and every
    dequeued row is the row its worker packed — the chained rows against
    ``pack_batch`` of the batch that travels with them, the fused rows
    against each worker's stream replayed alone."""
    config = AnalyzerConfig(**dict(SHARED, alive_bitmap_bits=16))
    backend = TorchBackend(config, init_now_s=NOW, device="cpu",
                           use_native=native.native_available(), prefetch_depth=1)
    # ring id -> (the ring, kept alive so no other ring reuses its id;
    # the threads that claimed its slots)
    owners: "dict[int, tuple]" = {}
    lock = threading.Lock()
    claim = gpu.StagingRing.claim

    def recording_claim(ring):
        with lock:
            owners.setdefault(id(ring), (ring, set()))[1].add(threading.get_ident())
        return claim(ring)

    monkeypatch.setattr(gpu.StagingRing, "claim", recording_claim)
    pindex = PartitionIndex(list(range(5)))
    groups = shard_partitions(pindex.ids, 5)
    spec = SyntheticSpec(**dict(SPEC, messages_per_partition=3000))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rows = 0
        with contextlib.closing(ParallelIngest(
                SyntheticSource(spec), 97, groups,
                stage=lambda b: backend.prepare(pindex.dense_batch(b)), depth=1)) as pool:
            for batch, staged in pool:
                want = pack_batch(batch, config)
                assert np.array_equal(staged.row.numpy(), want)
                pairs, _, _ = pack_pair_table([batch_alive_pairs(batch, config)], config,
                                              backend._pair_cap)
                assert np.array_equal(staged.pairs.numpy(), pairs)
                rows += 1
        assert rows >= 5 * 3000 // 97
        if native.native_available():
            fused = run_fused(backend, config, seg_dir, pindex)
            assert fused >= 15
    finally:
        sys.setswitchinterval(interval)
    assert owners and all(len(threads) == 1 for _, threads in owners.values())


def run_fused(backend, config, seg_dir, pindex) -> int:
    """The fused segment rows of 8 workers (one partition each, the rest
    idle) through ``backend``'s sinks, each held against its worker's
    stream replayed alone through a sink of a fresh backend."""
    groups = shard_partitions(pindex.ids, 8)
    alone = TorchBackend(config, init_now_s=NOW, device="cpu", use_native=True)
    expected = []
    for g in groups:
        stream = SegmentFileSource(seg_dir, topic=TOPIC).batches(
            31, partitions=g, sink=alone.make_fused_sink(pindex.dense_of))
        expected.append([(row.staged.row.numpy().copy(), row.staged.pairs.numpy().copy())
                         for row in stream])
    order, idx = [], [0] * len(groups)
    while any(i < len(e) for i, e in zip(idx, expected)):
        for w, e in enumerate(expected):
            if idx[w] < len(e):
                order.append(e[idx[w]])
                idx[w] += 1
    n = 0
    with contextlib.closing(ParallelIngest(
            SegmentFileSource(seg_dir, topic=TOPIC), 31, groups, depth=1,
            sink_factory=lambda: backend.make_fused_sink(pindex.dense_of))) as pool:
        for (row, staged), (want_row, want_pairs) in zip(pool, order, strict=True):
            assert isinstance(row, PackedRow)
            assert np.array_equal(staged.row.numpy(), want_row)
            assert np.array_equal(staged.pairs.numpy(), want_pairs)
            n += 1
    return n


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_resumed_and_four_worker_scans_equal_one_worker(seg_dir, tmp_path, capsys):
    """On a card: a segment-file scan interrupted and resumed, and a
    4-worker scan, each print the uninterrupted 1-worker cuda report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the counter kernels have no CPU mode)")
    features = dict(CLEAN_SEG, batch_size=256)

    def cuda_backend():
        return TorchBackend(AnalyzerConfig(**features), init_now_s=NOW, device="cuda",
                            use_native=native.native_available())

    one = run_scan(TOPIC, SegmentFileSource(seg_dir, topic=TOPIC), cuda_backend(), 256)
    four = run_scan(TOPIC, SegmentFileSource(seg_dir, topic=TOPIC), cuda_backend(), 256,
                    ingest_workers=4)
    with pytest.raises(Interrupt):
        run_scan(TOPIC, InterruptingSegments(seg_dir, topic=TOPIC), cuda_backend(), 256,
                 snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
    resumed = run_scan(TOPIC, SegmentFileSource(seg_dir, topic=TOPIC), cuda_backend(),
                       256, snapshot_dir=str(tmp_path), resume=True)
    want = report(render_report, one)
    assert four.ingest_workers == 4 and report(render_report, four) == want
    assert 0 < resumed.records < 7500 and report(render_report, resumed) == want


def test_bench_e2e_runs_the_workers_it_is_given(capsys):
    """The loopback end-to-end runner: a 2-leader template topic scanned
    by 2 workers on the host prints its JSON line with the resolved
    count and the doctor's verdict."""
    import json

    from kafka_topic_analyzer_tpu_torch.tools import bench_e2e

    rc = bench_e2e.run(["--records", "40000", "--partitions", "4", "--brokers", "2",
                        "--records-per-batch", "1000", "--batch-size", "8192",
                        "--features", "counters,alive", "--alive-bits", "16",
                        "--ingest-workers", "2", "--device", "cpu", "--flight-record",
                        "--quiet"])
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0
    assert doc["records"] == 40000 and doc["ingest_workers"] == 2
    assert doc["device"] == "cpu" and doc["flight"]["verdict"]


def test_ab_scan_times_every_tree_in_turns(capsys):
    """The A/B timer: each checkout scans once untimed, then once per
    round (in turn order), and the reports of every run agree."""
    import json

    from kafka_topic_analyzer_tpu_torch.tools import ab_scan

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = ab_scan.main(["--tree", root, "--tree", root, "--rounds", "1", "--",
                       "-t", TOPIC, "--source", "synthetic",
                       "--synthetic", "partitions=3,messages=2000,keys=300", "-c",
                       "--alive-bitmap-bits", "16", "--batch-size", "1024",
                       "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    doc = json.loads(lines[-1])
    assert rc == 0 and doc["reports_equal"] is True
    assert [len(v) for v in doc["rates"].values()] == [2]
    assert all(rate > 0 for rate in doc["rates"][root])
    assert [line.split(":")[0] for line in lines[:-1]] == [f"round 0 {root}"] * 2
