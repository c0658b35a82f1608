"""Snapshots and ``--resume``: the port's ``checkpoint.py`` and engine
hooks against the reference's.

The snapshot file is the seam between the two packages: the same config
stamps the same fingerprint in both, an incompatible snapshot is refused
with the same message, and a scan interrupted in one package resumes in
the other — on a synthetic topic, a segment-file dump and a fake Kafka
broker with compaction gaps — to the uninterrupted scan's report, offsets
and state leaves.  Through the two CLIs: ``--on-data-loss fail`` exits 5
after writing its checkpoint, and a scan that degraded (exit 3, "Rerun
with --resume (snapshot written)") leaves a snapshot that ``--resume``
completes once the cluster recovers, with the reference's report.  The
port runs its torch backend on the CPU (``device="cpu"``), the reference
its ``TpuBackend`` on JAX's CPU platform.
"""

import contextlib
import dataclasses
import itertools
import logging
import re

import jax
import numpy as np
import pytest

from fake_broker import FakeBroker, FakeCluster, FaultInjector
from kafka_topic_analyzer_tpu import checkpoint as ref_checkpoint
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefKafkaSource
from kafka_topic_analyzer_tpu.io.segfile import SegmentFileSource as RefSegmentSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.report import render_report as ref_render_report
from kafka_topic_analyzer_tpu_torch import checkpoint, cli
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.models.state import AnalyzerState, state_to_numpy
from kafka_topic_analyzer_tpu_torch.report import render_report
from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

from chip_smoke import Interrupt, Interrupting  # a source that dies mid-scan

TOPIC = "snap.t"
NOW = 10**10
SPEC = dict(num_partitions=3, messages_per_partition=4_000, keys_per_partition=200,
            tombstone_permille=150, seed=31)
FEATURES = dict(count_alive_keys=True, alive_bitmap_bits=20, enable_hll=True, hll_p=10,
                quantiles_per_partition=True)
BATCH = 512


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


# -- the fingerprint ---------------------------------------------------------

SKETCHES = {
    "none": {},
    "hll": dict(enable_hll=True, hll_p=10),
    "quantiles": dict(enable_quantiles=True),
    "both": dict(enable_hll=True, enable_quantiles=True),
    "per-partition": dict(distinct_keys_per_partition=True, quantiles_per_partition=True),
}
MATRIX = [
    dict(count_alive_keys=alive, alive_bitmap_bits=bits, wire_format=wire,
         use_pallas_counters=pallas, alive_compaction=compaction, **SKETCHES[sketch])
    for alive, bits, sketch, wire, pallas, compaction in itertools.product(
        (False, True), (24,), SKETCHES, (4, 5), (False, True), ("auto",))
] + [dict(count_alive_keys=True, alive_bitmap_bits=bits, alive_compaction="off")
     for bits in (16, 32)]


@pytest.mark.parametrize("features", MATRIX, ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()))
def test_fingerprint_equals_the_reference(features):
    kw = dict(num_partitions=5, batch_size=2048, **features)
    port, ref = AnalyzerConfig(**kw), RefConfig(**kw)
    assert checkpoint.config_fingerprint(port, TOPIC) == \
        ref_checkpoint.config_fingerprint(ref, TOPIC)
    assert checkpoint.acceptable_fingerprints(port, TOPIC) == \
        ref_checkpoint.acceptable_fingerprints(ref, TOPIC)
    assert checkpoint.mesh_free_snapshots(port) == ref_checkpoint.mesh_free_snapshots(ref)


@pytest.mark.parametrize("features", [FEATURES, dict(enable_hll=True),
                                      dict(count_alive_keys=True, alive_bitmap_bits=16)])
def test_state_template_is_the_state(features):
    config = AnalyzerConfig(num_partitions=3, batch_size=256, **features)
    leaves = state_to_numpy(AnalyzerState.init(config, "cpu"))
    want = {k: (v.shape, v.dtype) for k, v in leaves.items()}
    assert {k: (tuple(s), d) for k, (s, d) in checkpoint.state_template(config).items()} \
        == want


@pytest.mark.parametrize("alive", [True, False])
def test_incompatible_snapshot_rejected_with_the_reference_message(alive, tmp_path):
    """A snapshot of one config loaded under another: both packages raise
    the same ValueError (the alive-key text names the mesh pinning)."""
    kw = dict(num_partitions=3, batch_size=256, count_alive_keys=alive,
              alive_bitmap_bits=16, enable_hll=not alive)
    config = AnalyzerConfig(**kw)
    checkpoint.save_snapshot(
        str(tmp_path), TOPIC, config, state_to_numpy(AnalyzerState.init(config, "cpu")),
        {0: 0, 1: 0, 2: 0}, 0, NOW,
    )
    other = dict(kw, num_partitions=4)
    with pytest.raises(ValueError) as port_err:
        checkpoint.load_snapshot(str(tmp_path), TOPIC, AnalyzerConfig(**other))
    with pytest.raises(ValueError) as ref_err:
        ref_checkpoint.load_snapshot(str(tmp_path), TOPIC, RefConfig(**other))
    assert str(port_err.value) == str(ref_err.value)
    assert "fingerprint mismatch" in str(port_err.value)


def test_stale_lease_epoch_is_fenced_in_both(tmp_path):
    config = AnalyzerConfig(num_partitions=1, batch_size=64)
    leaves = state_to_numpy(AnalyzerState.init(config, "cpu"))
    checkpoint.save_snapshot(str(tmp_path), TOPIC, config, leaves, {0: 5}, 5, NOW,
                             lease_epoch=3)
    with pytest.raises(checkpoint.StaleLeaseEpochError):
        checkpoint.save_snapshot(str(tmp_path), TOPIC, config, leaves, {0: 6}, 6, NOW,
                                 lease_epoch=2)
    with pytest.raises(checkpoint.StaleLeaseEpochError):
        checkpoint.load_snapshot(str(tmp_path), TOPIC, config, lease_epoch=2)
    with pytest.raises(ref_checkpoint.StaleLeaseEpochError):
        ref_checkpoint.load_snapshot(
            str(tmp_path), TOPIC, RefConfig(num_partitions=1, batch_size=64),
            lease_epoch=2)
    assert checkpoint.snapshot_info(str(tmp_path))["lease_epoch"] == 3


# -- resume across the packages ---------------------------------------------

def gappy_rows():
    """One compacted partition: offsets 0, 3, 6, ... (compaction gaps)."""
    return {0: [(off, 1_600_000_000_000 + off, f"k{off % 37}".encode(),
                 None if off % 11 == 7 else bytes(20 + off % 64))
                for off in range(0, 900, 3)]}


class Package:
    """One package's side of a cross-package run."""

    def __init__(self, name: str):
        self.name = name
        self.port = name == "port"

    def backend(self, features, now):
        if self.port:
            # Fused rows where the shim builds, as the reference's backend.
            return TorchBackend(AnalyzerConfig(**features), init_now_s=now, device="cpu",
                                use_native=native.native_available())
        return TpuBackend(RefConfig(**features), init_now_s=now)

    def source(self, kind: str, where):
        if kind == "synthetic":
            return (SyntheticSource(SyntheticSpec(**SPEC)) if self.port
                    else RefSource(RefSpec(**SPEC)))
        if kind == "segfile":
            return (SegmentFileSource(where, topic=TOPIC) if self.port
                    else RefSegmentSource(where, topic=TOPIC))
        return (KafkaWireSource(where, TOPIC) if self.port
                else RefKafkaSource(where, TOPIC))

    def scan(self, *args, **kw):
        return (run_scan if self.port else ref_run_scan)(*args, **kw)

    def report(self, result) -> str:
        render = render_report if self.port else ref_render_report
        return drop_timing(render(TOPIC, result.metrics, result.start_offsets,
                                  result.end_offsets, 0, show_alive_keys=True))

    def leaves(self, backend) -> dict:
        if self.port:
            return backend.get_state()
        flat = ref_checkpoint._flatten(jax.tree.map(np.asarray, backend.get_state()))
        return {k[len("state."):]: v for k, v in flat.items()}


@pytest.fixture(scope="module")
def seg_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("segs"))
    make_segments(out, TOPIC, SyntheticSpec(**SPEC), batch_size=1000)
    return out


KINDS = {
    # kind: (features, batch size, items before the interrupt, total records)
    "synthetic": (dict(num_partitions=3, batch_size=BATCH, **FEATURES), BATCH, 7, 12_000),
    "segfile": (dict(num_partitions=3, batch_size=BATCH, **FEATURES), BATCH, 9, 12_000),
    "kafka": (dict(num_partitions=1, batch_size=128, count_alive_keys=True,
                   alive_bitmap_bits=16), 128, 2, 300),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port")])
def test_resume_across_packages(writer, reader, kind, seg_dir, tmp_path):
    """A scan interrupted in ``writer`` leaves a snapshot mid-topic that
    ``reader`` resumes: report, next offsets and every state leaf equal
    ``reader``'s uninterrupted scan, and the init time is restored."""
    features, batch, limit, total = KINDS[kind]
    w, r = Package(writer), Package(reader)
    snap = str(tmp_path / "snap")
    kafka = kind == "kafka"
    with FakeBroker(TOPIC, gappy_rows()) if kafka else contextlib.nullcontext() as b:
        where = f"127.0.0.1:{b.port}" if kafka else seg_dir
        full_backend = r.backend(features, NOW)
        full = r.scan(TOPIC, r.source(kind, where), full_backend, batch)
        with pytest.raises(Interrupt):
            w.scan(TOPIC, Interrupting(w.source(kind, where), limit),
                   w.backend(features, NOW), batch,
                   snapshot_dir=snap, snapshot_every_s=0.0)
        info = checkpoint.snapshot_info(snap)
        assert 0 < info["records_seen"] < total
        resumed_backend = r.backend(features, 0)
        resumed = r.scan(TOPIC, r.source(kind, where), resumed_backend, batch,
                         snapshot_dir=snap, snapshot_every_s=3600.0, resume=True)
    assert resumed_backend.init_now_s == NOW
    assert r.report(resumed) == r.report(full)
    assert resumed.next_offsets == full.next_offsets == full.end_offsets
    got, want = r.leaves(resumed_backend), r.leaves(full_backend)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if kind == "kafka":
        # Offsets have gaps: the saved cursor is one past the last
        # folded record's true offset, not a count.
        assert info["next_offsets"]["0"] == 3 * (info["records_seen"] - 1) + 1


@pytest.mark.parametrize("wire_format, compaction", [(4, "auto"), (5, "off")])
def test_port_resume_in_other_wire_formats(wire_format, compaction, tmp_path):
    """A v4 scan and an uncompacted v5 scan resume to the uninterrupted
    report (snapshots are wire-format free: a v5 scan resumes a v4
    snapshot)."""
    features = dict(num_partitions=3, batch_size=BATCH, wire_format=wire_format,
                    alive_compaction=compaction, **FEATURES)
    p = Package("port")
    full = p.scan(TOPIC, p.source("synthetic", None), p.backend(features, NOW), BATCH)
    with pytest.raises(Interrupt):
        p.scan(TOPIC, Interrupting(p.source("synthetic", None), 5),
               p.backend(features, NOW), BATCH, snapshot_dir=str(tmp_path),
               snapshot_every_s=0.0)
    resumed = p.scan(TOPIC, p.source("synthetic", None),
                     p.backend(dict(features, wire_format=5, alive_compaction="auto"), 0),
                     BATCH, snapshot_dir=str(tmp_path), resume=True)
    assert resumed.records == 12_000 - checkpoint.snapshot_info(str(tmp_path))["records_seen"]
    assert p.report(resumed) == p.report(full)


def test_periodic_snapshots_book_the_snapshot_stage(tmp_path):
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

    default_registry().reset()
    features = dict(num_partitions=3, batch_size=BATCH, **FEATURES)
    result = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                      TorchBackend(AnalyzerConfig(**features), init_now_s=NOW,
                                   device="cpu"),
                      BATCH, snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
    saved = result.telemetry["kta_snapshots_saved_total"]["samples"][0]["value"]
    assert saved == 24  # one per fold at interval 0
    stages = {s["labels"]["stage"]: s["value"]
              for s in result.telemetry["kta_stage_seconds_total"]["samples"]}
    assert stages["snapshot"] > 0
    assert checkpoint.snapshot_info(str(tmp_path))["records_seen"] == 12_000


def test_oracle_scans_on_without_snapshots(tmp_path, caplog):
    """The numpy oracle has no state to save: as in the reference, the
    scan continues without snapshots and says so."""
    features = dict(num_partitions=3, batch_size=BATCH, **FEATURES)
    with caplog.at_level(logging.WARNING):
        result = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                          CpuExactBackend(AnalyzerConfig(**features), init_now_s=NOW),
                          BATCH, snapshot_dir=str(tmp_path), snapshot_every_s=0.0)
    assert result.records == 12_000
    assert "CpuExactBackend does not support snapshots; continuing without" in caplog.text
    assert checkpoint.snapshot_info(str(tmp_path)) is None


# -- through the CLIs ----------------------------------------------------------

FAST = "retry.backoff.ms=5,reconnect.backoff.max.ms=40"
FLAGS = ["-c", "--alive-bitmap-bits", "24", "--distinct-keys-per-partition",
         "--quantiles-per-partition", "--quiet"]


def rows(partition: int, n: int):
    """Keys distinct across partitions (no cross-partition alive slot)."""
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{partition}-{i % 37}".encode() if i % 5 else None,
             bytes(20 + (i % 13)) if i % 7 else None) for i in range(n)]


def both_clis(argv_of, capsys, snap_root):
    """(rc, stdout, stderr) of the port CLI and of the reference CLI, each
    with its own snapshot directory under ``snap_root``; ``argv_of(name)``
    builds the arguments (it may start a broker)."""
    out = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--backend", "tpu"])):
        rc = main(argv_of(name) + ["--snapshot-dir", str(snap_root / name)] + extra)
        cap = capsys.readouterr()
        out.append((rc, drop_timing(cap.out), cap.err))
    return out


class FetchHook:
    """A broker ``response_delay`` that runs ``action`` once, right after
    the broker encodes its ``fire_at``-th fetch response."""

    def __init__(self, fire_at: int, action):
        self.fire_at, self.action, self.fetches = fire_at, action, 0

    def __call__(self, api_key: int, node_id: int) -> float:
        if api_key == ref_kc.API_FETCH:
            self.fetches += 1
            if self.fetches == self.fire_at:
                self.action()
        return 0.0


def test_data_loss_fail_checkpoints_then_resumes_like_the_reference(tmp_path, capsys):
    """Retention passes the cursor after the third fetch: exit 5 with a
    checkpoint of the 150 folded records in both CLIs; ``--resume``
    against the log that remains continues at its start (the seeded span
    is not booked again) and prints the reference's report."""
    flags = [*FLAGS, "--batch-size", "50", "--librdkafka", FAST, "--on-data-loss", "fail"]
    runs = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--backend", "tpu"])):
        snap = ["--snapshot-dir", str(tmp_path / name)]
        with FakeBroker(TOPIC, {0: rows(0, 400)}, max_records_per_fetch=50) as broker:
            broker.response_delay = FetchHook(3, lambda: broker.expire_to(0, 200))
            argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *flags, *snap, *extra]
            rc = main(argv)
            aborted = (rc, drop_timing(capsys.readouterr().out))
            info = checkpoint.snapshot_info(str(tmp_path / name))
            rc = main(argv + ["--resume"])
            cap = capsys.readouterr()
        runs.append((aborted, info, (rc, drop_timing(cap.out), cap.err)))
    assert runs[0][0] == runs[1][0]
    assert runs[0][0][0] == cli.EXIT_DATA_LOSS == 5
    for _, info, _ in runs:
        assert info["records_seen"] == 150 and info["next_offsets"] == {"0": 150}
        assert [s["start"] for s in info["lost_spans"]] == [150]
    assert runs[0][2] == runs[1][2]
    rc, out, _ = runs[0][2]
    assert rc == 0 and "DATA-LOSS" in out
    assert re.search(r"^\| 0 \| 200 +\| 400 +\| 350 +\|", out, flags=re.M), out


def test_degraded_scan_leaves_a_snapshot_that_resume_completes(tmp_path, capsys):
    """Exit 3 prints "Rerun with --resume (snapshot written)": the
    snapshot exists in both CLIs' directories, and ``--resume`` against
    the recovered cluster completes the scan with the uninterrupted
    scan's report, the reference's."""
    records = {p: rows(p, 300) for p in range(3)}
    argv = [*FLAGS, "--batch-size", "1024", "--librdkafka",
            FAST + ",transport.retry.budget=3,socket.timeout.ms=500"]
    degraded = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--backend", "tpu"])):
        armed = []

        def kill_node_1_on_first_fetch(api_key: int, node_id: int) -> float:
            if api_key == ref_kc.API_FETCH and node_id == 1 and not armed:
                armed.append(True)
                cluster.nodes[1].faults = (FaultInjector()
                                           .drop_connection(0, times=10**6)
                                           .refuse_connections(times=10**6))
            return 0.0

        with FakeCluster(TOPIC, records, n_nodes=2, max_records_per_fetch=100,
                         response_delay=kill_node_1_on_first_fetch) as cluster:
            rc = main(["-t", TOPIC, "-b", cluster.bootstrap, *argv,
                       "--snapshot-dir", str(tmp_path / name)] + extra)
        out = capsys.readouterr().out
        degraded.append(rc)
        assert rc == cli.EXIT_DEGRADED == 3
        assert "Rerun with --resume (snapshot written) once the cluster recovers." in out
        info = checkpoint.snapshot_info(str(tmp_path / name))
        assert info is not None and set(info["degraded"]) == {"1"}
        assert info["next_offsets"]["1"] < 300
    with FakeCluster(TOPIC, records, n_nodes=2, max_records_per_fetch=100) as cluster:
        base = ["-t", TOPIC, "-b", cluster.bootstrap, *argv]
        resumed = both_clis(lambda _name: base + ["--resume"], capsys, tmp_path)
        rc = cli.main(base + ["--device", "cpu"])
        uninterrupted = drop_timing(capsys.readouterr().out)
    assert rc == 0
    assert resumed[0][:2] == resumed[1][:2] == (0, uninterrupted)


@pytest.mark.parametrize("extra, refusal", [
    (["--dump-segments", "DUMP"], "--dump-segments cannot be combined with --resume"),
    (["--from-timestamp", "0"], "--from-timestamp cannot be combined with --resume"),
])
def test_resume_refusals_match_the_reference(extra, refusal, tmp_path, capsys):
    with FakeBroker(TOPIC, {0: rows(0, 10)}) as broker:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", "--resume",
                "--snapshot-dir", str(tmp_path / "s"), "--quiet",
                *[str(tmp_path / a) if a == "DUMP" else a for a in extra]]
        rc = cli.main(argv + ["--device", "cpu"])
        port = (rc, capsys.readouterr())
        rc = ref_cli.main(argv + ["--backend", "tpu"])
        ref = (rc, capsys.readouterr())
    assert port[0] == ref[0] == 1
    assert port[1].err == ref[1].err and refusal in port[1].err


def test_snapshot_keys_are_the_reference_leaves(tmp_path):
    """The file itself: ``__meta__`` plus one ``state.<leaf>`` array per
    leaf, alive words as uint32 — what the reference writes."""
    config = AnalyzerConfig(num_partitions=3, batch_size=256, **FEATURES)
    ref_config = RefConfig(num_partitions=3, batch_size=256, **FEATURES)
    port_path = checkpoint.save_snapshot(
        str(tmp_path / "port"), TOPIC, config,
        state_to_numpy(AnalyzerState.init(config, "cpu")), {0: 1}, 1, NOW)
    ref_path = ref_checkpoint.save_snapshot(
        str(tmp_path / "ref"), TOPIC, ref_config,
        ref_checkpoint.AnalyzerState.init(ref_config), {0: 1}, 1, NOW)
    with np.load(port_path) as got, np.load(ref_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["state.alive.words"].dtype == np.uint32
    assert dataclasses.asdict(config) == dataclasses.asdict(ref_config)


# -- snapshots across meshes ---------------------------------------------------

MESH_FREE = dict(num_partitions=3, batch_size=BATCH, enable_hll=True, hll_p=10,
                 quantiles_per_partition=True)
MESH_ALIVE = dict(num_partitions=3, batch_size=BATCH, **FEATURES)


def mesh_backend(name: str, features: dict, mesh, now):
    """``name``'s backend for ``mesh``: the sharded one, or the
    single-device one at (1, 1)."""
    from kafka_topic_analyzer_tpu.parallel.sharded import ShardedTpuBackend
    from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend

    kw = dict(features, mesh_shape=mesh)
    if name == "port":
        if mesh == (1, 1):
            return TorchBackend(AnalyzerConfig(**kw), init_now_s=now, device="cpu")
        return ShardedTorchBackend(AnalyzerConfig(**kw), init_now_s=now, device="cpu")
    if mesh == (1, 1):
        return TpuBackend(RefConfig(**kw), init_now_s=now)
    return ShardedTpuBackend(RefConfig(**kw), init_now_s=now)


def interrupted_then_resumed(writer, w_mesh, reader, r_mesh, features, tmp_path):
    """(the reader's uninterrupted scan and backend, its resumed scan and
    backend) after ``writer`` on ``w_mesh`` died mid-topic with a
    snapshot."""
    w, r = Package(writer), Package(reader)
    snap = str(tmp_path / "snap")
    full_backend = mesh_backend(reader, features, r_mesh, NOW)
    full = r.scan(TOPIC, r.source("synthetic", None), full_backend, BATCH)
    with pytest.raises(Interrupt):
        w.scan(TOPIC, Interrupting(w.source("synthetic", None), 7),
               mesh_backend(writer, features, w_mesh, NOW), BATCH,
               snapshot_dir=snap, snapshot_every_s=0.0)
    assert 0 < checkpoint.snapshot_info(snap)["records_seen"] < 12_000
    resumed_backend = mesh_backend(reader, features, r_mesh, 0)
    resumed = r.scan(TOPIC, r.source("synthetic", None), resumed_backend, BATCH,
                     snapshot_dir=snap, snapshot_every_s=3600.0, resume=True)
    return r, (full, full_backend), (resumed, resumed_backend)


@pytest.mark.parametrize("writer, w_mesh, reader, r_mesh", [
    ("ref", (2, 1), "port", (4, 1)),
    ("port", (2, 1), "ref", (4, 1)),
    ("port", (2, 2), "port", (1, 1)),
    ("ref", (1, 1), "port", (2, 2)),
], ids=["ref2x1-port4x1", "port2x1-ref4x1", "port2x2-port1x1", "ref1x1-port2x2"])
def test_mesh_free_snapshots_resume_across_meshes_and_packages(
        writer, w_mesh, reader, r_mesh, tmp_path):
    """Without the alive bitmap a snapshot is stored canonical (the mesh
    rows folded by each leaf's merge law) and spread over any mesh on
    load: the resumed scan's report and folded leaves equal the reader's
    uninterrupted scan's."""
    r, (full, full_backend), (resumed, resumed_backend) = interrupted_then_resumed(
        writer, w_mesh, reader, r_mesh, MESH_FREE, tmp_path)
    assert resumed_backend.init_now_s == NOW
    assert r.report(resumed) == r.report(full)
    got, want = r.leaves(resumed_backend), r.leaves(full_backend)
    if r_mesh != (1, 1):
        from kafka_topic_analyzer_tpu_torch.models.state import merge_rows

        got, want = merge_rows(got), merge_rows(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port")])
def test_alive_snapshot_resumes_across_packages_on_its_mesh(writer, reader, tmp_path):
    """An alive-key snapshot keeps the stacked layout: on the writer's
    mesh it resumes in the other package.  Each data row's bitmap equals
    the uninterrupted scan's word for word; the other leaves once their
    rows fold (the resumed rounds cut each row's batches elsewhere, so
    records land in other space shards)."""
    from kafka_topic_analyzer_tpu_torch.models.state import merge_rows

    r, (full, full_backend), (resumed, resumed_backend) = interrupted_then_resumed(
        writer, (2, 2), reader, (2, 2), MESH_ALIVE, tmp_path)
    assert r.report(resumed) == r.report(full)
    got, want = r.leaves(resumed_backend), r.leaves(full_backend)
    assert got["alive.words"].shape == (2, 1 << 15)
    np.testing.assert_array_equal(got.pop("alive.words"), want.pop("alive.words"))
    got, want = merge_rows(got), merge_rows(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("reader_mesh", [(4, 1), (2, 2), (1, 1)])
def test_alive_snapshot_on_another_mesh_is_refused_like_the_reference(
        reader_mesh, tmp_path):
    """An alive-key snapshot written on a 2x1 mesh does not load on
    another mesh, in either package, with the reference's message, which
    names ``--mesh 2,1``."""
    config = AnalyzerConfig(**dict(MESH_ALIVE, mesh_shape=(2, 1)))
    backend = mesh_backend("port", MESH_ALIVE, (2, 1), NOW)
    checkpoint.save_snapshot(str(tmp_path), TOPIC, config, backend.get_state(),
                             {0: 0, 1: 0, 2: 0}, 0, NOW)
    kw = dict(MESH_ALIVE, mesh_shape=reader_mesh)
    with pytest.raises(ValueError) as port_err:
        checkpoint.load_snapshot(str(tmp_path), TOPIC, AnalyzerConfig(**kw))
    with pytest.raises(ValueError) as ref_err:
        ref_checkpoint.load_snapshot(str(tmp_path), TOPIC, RefConfig(**kw))
    assert str(port_err.value) == str(ref_err.value)
    assert "--mesh 2,1" in str(port_err.value)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (1, 4)])
def test_mesh_state_template_is_the_sharded_state(mesh):
    from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend

    config = AnalyzerConfig(**dict(MESH_ALIVE, mesh_shape=mesh))
    leaves = ShardedTorchBackend(config, device="cpu").get_state()
    assert {k: (tuple(s), d) for k, (s, d) in checkpoint.state_template(config).items()} \
        == {k: (v.shape, v.dtype) for k, v in leaves.items()}
