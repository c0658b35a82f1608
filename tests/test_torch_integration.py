"""The grand integration and the jittered cluster, held against the port.

- Every layer at once (twin of ``tests/test_integration.py``): a 2-node
  ``FakeCluster`` serving the reference test's gzip-compressed, gappy
  topic over TCP, the port's ``KafkaWireSource``, ``engine.run_scan`` on
  a (2, 2) ``ShardedTorchBackend`` on the host with a snapshot after
  every step, an interrupt after the sixth batch, and a resume with a
  fresh source and backend.  The resumed result must equal the port's
  uninterrupted numpy oracle (exact lines exactly, sketches within the
  reference test's budgets) and, exactly, sketches included, the
  reference's own uninterrupted (2, 2) mesh scan of the same cluster.
  The reference side needs 4 virtual JAX devices and skips without them;
  the port side runs regardless.
- Non-dense partition ids {3, 4, 5} through staged snapshots: the
  snapshot keys its offsets by the true ids and a resume folds nothing
  twice.
- The jittered cluster (twin of ``tests/test_race_stress.py``): a 4-node
  ``FakeCluster`` whose per-node answer delay is drawn from a seed, so
  the port's fetch threads interleave differently each run; the scan's
  metrics must be byte-identical to the jitter-free single-broker scan,
  for seeds 1-3 and with native hashing off, through the port's oracle
  (as the reference's test) and its torch backend on the host.  The
  jitter-free oracle also equals the reference's.

Each scan that waits on sockets runs under a timeout of its own: a
deadlock fails the case instead of hanging the run.
"""

import random
import threading

import jax
import numpy as np
import pytest

import test_integration as ref_integration
import test_race_stress as ref_race
from fake_broker import FakeBroker, FakeCluster
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.checkpoint import load_snapshot
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource, records_to_batch
from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend

TOPIC = ref_integration.TOPIC
NOW = 10**10
#: Seconds a scan over loopback sockets may take before the case fails.
SCAN_TIMEOUT_S = 60.0


def within(fn, timeout_s: float = SCAN_TIMEOUT_S):
    """``fn()``'s result, or a failure once ``timeout_s`` passes first."""
    out: dict = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised in the caller's thread
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        pytest.fail(f"scan still running after {timeout_s} s (a deadlock?)")
    if "error" in out:
        raise out["error"]
    return out["value"]


def scan_topic(bootstrap: str, topic: str, backend, batch_size: int, **kw):
    """`run_scan` over a fresh wire source, closed afterwards."""
    native = kw.pop("use_native_hashing", True)

    def body():
        src = KafkaWireSource(bootstrap, topic, use_native_hashing=native)
        try:
            return run_scan(topic, src, backend, batch_size, **kw)
        finally:
            src.close()

    return within(body)


# -- the grand integration --------------------------------------------------------

FEATURES = dict(num_partitions=5, batch_size=512, count_alive_keys=True,
                alive_bitmap_bits=20, enable_hll=True, hll_p=12,
                enable_quantiles=True, quantiles_per_partition=True)


class Interrupt(Exception):
    pass


class Limited:
    """The wire source, raising `Interrupt` after ``limit`` batches of an
    unresumed scan."""

    def __init__(self, inner, limit):
        self.inner, self.limit, self.seen = inner, limit, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batches(self, batch_size, partitions=None, start_at=None):
        for b in self.inner.batches(batch_size, partitions, start_at):
            if start_at is None:
                self.seen += 1
                if self.seen > self.limit:
                    raise Interrupt()
            yield b


def reference_mesh_scan(bootstrap: str):
    """The reference's uninterrupted (2, 2) mesh scan of the cluster."""
    from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
    from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefSource
    from kafka_topic_analyzer_tpu.parallel.sharded import ShardedTpuBackend

    def body():
        src = RefSource(bootstrap, TOPIC)
        try:
            backend = ShardedTpuBackend(RefConfig(**FEATURES, mesh_shape=(2, 2)),
                                        init_now_s=NOW)
            return ref_run_scan(TOPIC, src, backend, 512)
        finally:
            src.close()

    return within(body)


def test_full_stack_interrupt_resume(tmp_path):
    records = ref_integration._records()
    mesh = AnalyzerConfig(**FEATURES, mesh_shape=(2, 2))
    with FakeCluster(TOPIC, records, n_nodes=2, compression=ref_kc.COMPRESSION_GZIP,
                     max_records_per_fetch=700) as cluster:
        referee = scan_topic(cluster.bootstrap, TOPIC,
                             CpuExactBackend(AnalyzerConfig(**FEATURES), init_now_s=NOW),
                             512).metrics

        def interrupted():
            src = Limited(KafkaWireSource(cluster.bootstrap, TOPIC), 6)
            try:
                with pytest.raises(Interrupt):
                    run_scan(TOPIC, src, ShardedTorchBackend(mesh, init_now_s=NOW,
                                                             device="cpu"),
                             512, snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
            finally:
                src.close()
            return src.seen

        # The mesh drives one stream per data row: each may have counted
        # one batch past the limit before the first raise.
        assert within(interrupted) > 6
        snap = load_snapshot(str(tmp_path), TOPIC, mesh)
        assert snap is not None and 0 < snap[2] < sum(map(len, records.values()))
        result = scan_topic(cluster.bootstrap, TOPIC,
                            ShardedTorchBackend(mesh, init_now_s=0, device="cpu"), 512,
                            snapshot_dir=str(tmp_path), resume=True)
        reference = (reference_mesh_scan(cluster.bootstrap)
                     if len(jax.devices()) >= 4 else None)

    m = result.metrics
    assert np.array_equal(m.per_partition, referee.per_partition)
    assert np.array_equal(m.per_partition_extremes, referee.per_partition_extremes)
    assert m.overall_count == referee.overall_count
    assert m.overall_size == referee.overall_size
    assert m.alive_keys == referee.alive_keys
    assert m.earliest_ts_s == referee.earliest_ts_s
    assert m.latest_ts_s == referee.latest_ts_s
    assert m.distinct_keys_hll == pytest.approx(referee.distinct_keys_exact, rel=0.1)
    for exact, sketch in zip(referee.quantiles_per_partition, m.quantiles_per_partition):
        for qe, qs in zip(exact.values, sketch.values):
            assert qs == pytest.approx(qe, rel=0.011)
    assert result.end_offsets == {p: rows[-1][0] + 1 for p, rows in records.items()}
    if reference is None:
        pytest.skip("the reference's (2, 2) mesh needs 4 virtual JAX devices; "
                    "the port's side passed")
    want = reference.metrics
    assert m.to_dict() == want.to_dict()
    assert (result.start_offsets, result.end_offsets) == \
        (reference.start_offsets, reference.end_offsets)


def test_non_dense_partitions_staged_scan_snapshots_true_ids(tmp_path):
    records = {
        p: [(off, 1_600_000_000_000 + off * 500,
             f"p{p}-k{off % 37}".encode() if off % 7 else None,
             None if off % 13 == 5 else bytes(10 + (off * 3 + p) % 60))
            for off in range(600)]
        for p in (3, 4, 5)
    }
    cfg = AnalyzerConfig(num_partitions=3, batch_size=256, count_alive_keys=True,
                         alive_bitmap_bits=16)
    with FakeBroker("gap.topic", records) as b:
        bootstrap = f"127.0.0.1:{b.port}"
        result = scan_topic(bootstrap, "gap.topic",
                            TorchBackend(cfg, init_now_s=0, device="cpu"), 256,
                            snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
        snap = load_snapshot(str(tmp_path), "gap.topic", cfg)
        assert snap is not None
        _, next_offsets, records_seen, _ = snap
        assert next_offsets == {3: 600, 4: 600, 5: 600}
        assert records_seen == 1800
        resumed = scan_topic(bootstrap, "gap.topic",
                             TorchBackend(cfg, init_now_s=0, device="cpu"), 256,
                             snapshot_dir=str(tmp_path), resume=True)

    m = result.metrics
    assert m.partitions == [3, 4, 5]
    assert m.overall_count == 1800
    oracle = CpuExactBackend(cfg, init_now_s=0)
    rows = [(p, ts, k, v) for p in (3, 4, 5) for (_off, ts, k, v) in records[p]]
    for lo in range(0, len(rows), 256):
        oracle.update(records_to_batch([(p - 3, ts, k, v) for p, ts, k, v in
                                        rows[lo:lo + 256]]))
    want = oracle.finalize()
    assert np.array_equal(m.per_partition, want.per_partition)
    assert m.overall_size == want.overall_size
    assert m.alive_keys == want.alive_keys
    rm = resumed.metrics
    assert rm.overall_count == m.overall_count
    assert np.array_equal(rm.per_partition, m.per_partition)
    assert rm.alive_keys == m.alive_keys


# -- the jittered cluster ---------------------------------------------------------

RACE_TOPIC = ref_race.TOPIC
RACE_CONFIG = dict(num_partitions=ref_race.P, batch_size=2048, count_alive_keys=True,
                   alive_bitmap_bits=20, enable_hll=True, enable_quantiles=True)
BACKENDS = {
    "oracle": lambda: CpuExactBackend(AnalyzerConfig(**RACE_CONFIG)),
    "torch-cpu": lambda: TorchBackend(AnalyzerConfig(**RACE_CONFIG), init_now_s=NOW,
                                      device="cpu"),
}


def race_scan(bootstrap: str, backend: str, use_native_hashing: bool = True) -> tuple:
    """`test_race_stress._scan`'s tuple, through the port."""
    m = scan_topic(bootstrap, RACE_TOPIC, BACKENDS[backend](), 2048,
                   use_native_hashing=use_native_hashing).metrics
    return (
        m.overall_count, m.overall_size,
        tuple(m.partitions), m.per_partition.tobytes(),
        m.earliest_ts_s, m.latest_ts_s,
        m.smallest_message, m.largest_message,
        m.alive_keys, round(float(m.distinct_keys_hll or 0), 6),
    )


@pytest.fixture(scope="module")
def oracles():
    """The jitter-free single-broker scans, by backend; the port's oracle
    must equal the reference's."""
    with FakeBroker(RACE_TOPIC, ref_race.RECORDS, max_records_per_fetch=200) as broker:
        bootstrap = f"127.0.0.1:{broker.port}"
        out = {name: race_scan(bootstrap, name) for name in BACKENDS}
        assert out["oracle"] == within(lambda: ref_race._scan(bootstrap))
    return out


def jittered_cluster(delay) -> FakeCluster:
    return FakeCluster(RACE_TOPIC, ref_race.RECORDS, n_nodes=4, max_records_per_fetch=90,
                       response_delay=delay)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jittered_cluster_matches_oracle(oracles, seed, backend):
    rng = random.Random(seed)
    base = {node: rng.uniform(0, 0.004) for node in range(4)}

    def delay(api_key, node_id):
        return base[node_id] + rng.uniform(0, 0.004)

    with jittered_cluster(delay) as cluster:
        assert race_scan(cluster.bootstrap, backend) == oracles[backend]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_jittered_cluster_matches_oracle_native_off(oracles, backend):
    """The same interleave stress through the pure-Python decode path."""
    rng = random.Random(99)

    def delay(api_key, node_id):
        return rng.uniform(0, 0.003)

    with jittered_cluster(delay) as cluster:
        assert race_scan(cluster.bootstrap, backend,
                         use_native_hashing=False) == oracles[backend]
