"""Superbatch dispatch (``--superbatch K``): the port's
``config.DispatchConfig``, ``TorchBackend.update_superbatch``,
``step.superbatch_fold`` and the engine's accumulate-K loop against the
reference's.

For any K and dispatch depth the port's report equals the reference's
K = 1 report of the same topic, byte for byte — wire v5 and v4,
compaction on and off, a partial tail, N ingest workers, corruption
landing mid-superbatch.  Snapshots land only at superbatch boundaries, a
snapshot taken at K = 4 resumes at K = 1 in the port and in the
reference, a pending superbatch's rows never alias a staging-ring slot,
and ``kta_wire_bytes_total`` books the rows that crossed (the reference
also books the empty rows it pads a partial tail with).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import Interrupt, Interrupting  # a source that dies mid-scan
from fake_broker import CorruptionInjector, FakeBroker
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.config import CorruptionConfig as RefCorruptionConfig
from kafka_topic_analyzer_tpu.config import DispatchConfig as RefDispatchConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefKafkaSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.report import render_report as ref_render_report
from kafka_topic_analyzer_tpu_torch import checkpoint, cli
from kafka_topic_analyzer_tpu_torch.backends.base import DispatchQueue
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    CorruptionConfig,
    DispatchConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.packing import pack_batch, packed_nbytes, pair_table_capacity
from kafka_topic_analyzer_tpu_torch.report import render_report

pytestmark = pytest.mark.superbatch

TOPIC = "sb.t"
NOW = 10**10
BATCH = 512
#: partitions=3, messages=4000: 24 rows of at most 512 records per scan
#: (8 per partition).
SPEC = dict(num_partitions=3, messages_per_partition=4_000, keys_per_partition=300,
            tombstone_permille=120, seed=5)
FEATURES = dict(count_alive_keys=True, alive_bitmap_bits=20, enable_hll=True, hll_p=10,
                quantiles_per_partition=True)
FORMATS = {
    "v5": {},
    "v5-compaction-off": {"alive_compaction": "off"},
    "v4": {"wire_format": 4},
}
FAST = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40"}


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def report(render, result) -> str:
    return drop_timing(render(TOPIC, result.metrics, result.start_offsets,
                              result.end_offsets, 0, show_alive_keys=True))


def port_backend(fmt="v5", k=1, d=2, **kw):
    cfg = AnalyzerConfig(num_partitions=3, batch_size=BATCH, **FEATURES, **FORMATS[fmt])
    return TorchBackend(cfg, init_now_s=NOW, device="cpu",
                        dispatch=DispatchConfig(superbatch=k, depth=d), **kw)


def ref_backend(fmt="v5", k=1, d=2):
    cfg = RefConfig(num_partitions=3, batch_size=BATCH, **FEATURES, **FORMATS[fmt])
    return TpuBackend(cfg, init_now_s=NOW, device=jax.devices("cpu")[0],
                      dispatch=RefDispatchConfig(superbatch=k, depth=d))


_REF_K1: dict = {}


def superbatch_dispatches(result) -> int:
    """Superbatches the scan dispatched: one stager slot each."""
    metric = result.telemetry.get("kta_stager_slots_total") or {"samples": []}
    return int(sum(s["value"] for s in metric["samples"]))


def ref_k1_report(fmt: str, workers: int = 1) -> str:
    """The reference's K = 1 report of the spec (cached per format)."""
    key = (fmt, workers)
    if key not in _REF_K1:
        _REF_K1[key] = report(ref_render_report, ref_run_scan(
            TOPIC, RefSource(RefSpec(**SPEC)), ref_backend(fmt), BATCH,
            ingest_workers=workers,
        ))
    return _REF_K1[key]


# -- sizing ---------------------------------------------------------------------

@pytest.mark.parametrize("text", ["1", "2", "4", "16", "auto", " AUTO ", "0", "-1", "many", ""])
@pytest.mark.parametrize("depth", [1, 2, 3, 0])
def test_dispatch_config_equals_the_reference(text, depth):
    """`parse` gives the reference's config or its refusal, and `resolve`
    the reference's K at every batch size (``auto`` at 2^18 is K = 1)."""
    try:
        want = RefDispatchConfig.parse(text, depth)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            DispatchConfig.parse(text, depth)
        assert str(got.value) == str(e)
        return
    cfg = DispatchConfig.parse(text, depth)
    assert (cfg.superbatch, cfg.depth, cfg.auto_fold_cap_records) == (
        want.superbatch, want.depth, want.auto_fold_cap_records)
    for bits in range(6, 24):
        assert cfg.resolve(1 << bits) == want.resolve(1 << bits), bits
    assert DispatchConfig.parse("auto").resolve(1 << 18) == 1


def test_pair_table_capacity_spans_the_superbatch():
    cfg = AnalyzerConfig(num_partitions=3, batch_size=BATCH, count_alive_keys=True,
                         alive_bitmap_bits=12)
    assert pair_table_capacity(cfg, BATCH) == BATCH
    assert pair_table_capacity(cfg, BATCH, 4) == 2048
    assert pair_table_capacity(cfg, BATCH, 16) == 4096  # the slot space


class _Tok:
    """A completion token that completes when something waits on it."""

    def __init__(self):
        self.ready = False

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True


def test_dispatch_queue_bounds_superbatches_in_flight():
    q = DispatchQueue(2)
    t1, t2, t3 = _Tok(), _Tok(), _Tok()
    q.throttle(); q.launched(t1, 4)
    q.throttle(); q.launched(t2, 4)
    assert len(q) == 2
    q.throttle()
    assert t1.ready and len(q) == 1
    q.launched(t3, 2)
    q.drain()
    assert t2.ready and t3.ready and len(q) == 0
    assert obs_metrics.DISPATCH_INFLIGHT.value == 0


def test_backend_rejects_oversized_and_empty_superbatches():
    be = port_backend(k=2)
    batches = list(SyntheticSource(SyntheticSpec(**SPEC)).batches(BATCH))
    with pytest.raises(ValueError):
        be.update_superbatch(batches[:3])
    with pytest.raises(ValueError):
        be.update_superbatch([])


# -- every K equals the reference's K = 1 ---------------------------------------

@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_k_grid_equals_the_reference_k1(fmt, k):
    """24 rows per scan (8 per partition), which K = 2, 3 and 8 divide;
    even K run a depth-1 queue, odd K depth 2.  Every report is the
    reference's K = 1 report."""
    backend = port_backend(fmt, k=k, d=1 + k % 2)
    default_registry().reset()
    r = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), backend, BATCH)
    assert (r.superbatch_k, r.dispatch_depth) == (k, 1 + k % 2)
    assert backend.dispatches == 24
    assert superbatch_dispatches(r) == (0 if k == 1 else -(-24 // k))
    assert report(render_report, r) == ref_k1_report(fmt)


@pytest.mark.parametrize("fmt", ["v5", "v4"])
def test_partial_tail_equals_the_reference_k1(fmt):
    """K = 5 leaves a tail of 4 rows, K = 64 makes the whole scan one
    partial superbatch; only the rows given are folded."""
    for k in (5, 64):
        default_registry().reset()
        r = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                     port_backend(fmt, k=k), BATCH)
        assert superbatch_dispatches(r) == -(-24 // k)
        assert report(render_report, r) == ref_k1_report(fmt)


@pytest.mark.parametrize("fmt", ["v5", "v4"])
def test_superbatch_composes_with_three_ingest_workers(fmt):
    """Rows from 3 workers fold in the fan-in order at any K: the report
    (alive keys included) is the reference's 3-worker K = 1 report."""
    for k in (1, 4):
        r = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                     port_backend(fmt, k=k), BATCH, ingest_workers=3)
        assert (r.ingest_workers, r.superbatch_k) == (3, k)
        assert report(render_report, r) == ref_k1_report(fmt, workers=3)


def test_fused_rows_at_k4_equal_the_reference_k1():
    """Fused sinks (rows packed straight into ring slots, raw pairs kept
    per row) at K = 4, one and three workers."""
    if not native.native_available():
        pytest.skip("the native shim does not build here (fused rows need it)")
    from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments
    import tempfile

    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource

    with tempfile.TemporaryDirectory() as d:
        make_segments(d, TOPIC, SyntheticSpec(**SPEC), use_native=True)
        for workers in (1, 3):
            r = run_scan(TOPIC, SegmentFileSource(d, TOPIC),
                         port_backend("v5", k=4, use_native=True), BATCH,
                         ingest_workers=workers)
            assert r.fused
            k1 = run_scan(TOPIC, SegmentFileSource(d, TOPIC),
                          port_backend("v5", k=1, use_native=True), BATCH,
                          ingest_workers=workers)
            assert report(render_report, r) == report(render_report, k1)


def kafka_rows(partition: int, n: int):
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{partition}-{i % 29}".encode() if i % 5 else None,
             bytes(20 + (i % 13)) if i % 7 else None) for i in range(n)]


def test_corruption_mid_superbatch_equals_the_reference(tmp_path):
    """Poisoned frames under ``--on-corruption quarantine`` while K = 4
    superbatches accumulate: the same report, corrupt map and quarantine
    files as the reference's K = 1 scan."""
    records = {p: kafka_rows(p, 300) for p in range(4)}
    kw = dict(num_partitions=4, batch_size=128, count_alive_keys=True,
              alive_bitmap_bits=16)

    def poisoned():
        inj = (CorruptionInjector().flip_byte(1, chunk=1, offset=-1)
               .flip_byte(1, chunk=3, offset=-3))
        return FakeBroker(TOPIC, records, max_records_per_fetch=50,
                          corruption=inj, honor_partition_max_bytes=True)

    with poisoned() as broker:
        src = RefKafkaSource(
            f"127.0.0.1:{broker.port}", TOPIC,
            overrides=dict(FAST, **{"check.crcs": "true"}),
            corruption=RefCorruptionConfig(policy="quarantine",
                                           quarantine_dir=str(tmp_path / "qr")))
        ref = ref_run_scan(TOPIC, src, TpuBackend(RefConfig(**kw), init_now_s=NOW), 128)
        src.close()
    with poisoned() as broker:
        src = KafkaWireSource(
            f"127.0.0.1:{broker.port}", TOPIC,
            overrides=dict(FAST, **{"check.crcs": "true"}),
            corruption=CorruptionConfig(policy="quarantine",
                                        quarantine_dir=str(tmp_path / "qp")))
        got = run_scan(TOPIC, src, TorchBackend(
            AnalyzerConfig(**kw), init_now_s=NOW, device="cpu",
            dispatch=DispatchConfig(superbatch=4, depth=2)), 128)
        src.close()
    assert set(got.corrupt_partitions) == {1}
    assert got.corrupt_partitions == ref.corrupt_partitions
    assert report(render_report, got) == report(ref_render_report, ref)
    assert sorted(os.listdir(tmp_path / "qp")) == sorted(os.listdir(tmp_path / "qr"))


# -- snapshots ------------------------------------------------------------------

def _snapshot_seqs(monkeypatch):
    seen = []
    real = checkpoint.save_snapshot

    def spy(*args, **kwargs):
        seen.append(args[5] if len(args) > 5 else kwargs["records_seen"])
        return real(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "save_snapshot", spy)
    return seen


def test_snapshots_land_only_at_superbatch_boundaries(tmp_path, monkeypatch):
    """At a zero interval K = 1 snapshots after every row; K = 4 only
    after every 4th row's cumulative count, plus the flushed tail (24
    rows: none)."""
    seqs = _snapshot_seqs(monkeypatch)
    run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), port_backend(), BATCH,
             snapshot_dir=str(tmp_path / "k1"), snapshot_every_s=0.0)
    per_row = list(seqs)
    assert len(per_row) == 24
    seqs.clear()
    run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), port_backend(k=5), BATCH,
             snapshot_dir=str(tmp_path / "k5"), snapshot_every_s=0.0)
    assert seqs == per_row[4::5] + [per_row[-1]]


@pytest.mark.parametrize("fmt", ["v5", "v4"])
def test_k4_snapshot_resumes_at_k1_in_both_packages(fmt, tmp_path):
    """A K = 4 scan dies after 7 rows (3 pending): the failure path folds
    the pending tail first, so the snapshot covers all 7 rows.  The port
    at K = 1 and the reference each resume it into the full report."""
    snap = str(tmp_path / "snap")
    with pytest.raises(Interrupt):
        run_scan(TOPIC, Interrupting(SyntheticSource(SyntheticSpec(**SPEC)), 7),
                 port_backend(fmt, k=4), BATCH,
                 snapshot_dir=snap, snapshot_every_s=3600.0)
    with np.load(os.path.join(snap, "scan_snapshot.npz"), allow_pickle=False) as z:
        assert json.loads(str(z["__meta__"]))["records_seen"] == 7 * BATCH
    port = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), port_backend(fmt, k=1),
                    BATCH, snapshot_dir=snap, resume=True)
    ref = ref_run_scan(TOPIC, RefSource(RefSpec(**SPEC)), ref_backend(fmt), BATCH,
                       snapshot_dir=snap, resume=True)
    assert port.records == 3 * 4_000 - 7 * BATCH
    assert report(render_report, port) == ref_k1_report(fmt)
    assert report(ref_render_report, ref) == ref_k1_report(fmt)


# -- staging --------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["v5", "v4"])
def test_pending_rows_never_alias_a_ring_slot(fmt):
    """K = 8 over a 4-slot ring (prefetch depth 2): every pending row is
    a tensor of its own, sharing no storage with any ring slot, and still
    holds the bytes its batch packed to after the ring wrapped twice; the
    raw pairs are arrays of their own too.  Folding the 8 pending rows
    equals 8 K = 1 updates."""
    batches = list(SyntheticSource(SyntheticSpec(**SPEC)).batches(BATCH))[:8]
    be = port_backend(fmt, k=8, prefetch_depth=2)
    staged = [be.prepare(b) for b in batches]
    ring = be._thread_ring()
    assert len(ring.hosts) == 4
    slots = [(h.untyped_storage().data_ptr(), h.untyped_storage().nbytes())
             for h in ring.hosts]
    for item, batch in zip(staged, batches):
        ptr = item.row.untyped_storage().data_ptr()
        assert all(not (lo <= ptr < lo + n) for lo, n in slots)
        assert (item.row.numpy() == pack_batch(batch, be.config)).all()
        if be.config.compact_alive:
            for arr in item.raw_pairs:
                assert arr.base is None or not any(
                    np.shares_memory(arr, v) for v in ring.views)
        else:
            assert item.raw_pairs is None
    be.update_superbatch(staged)
    k1 = port_backend(fmt, k=1)
    for b in batches:
        k1.update(b)
    got, want = be.get_state(), k1.get_state()
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(got[name], want[name]), name


# -- wire accounting ------------------------------------------------------------

def test_wire_bytes_book_no_padding_unlike_the_reference():
    """Pinned divergence: at K = 5 over 24 rows the reference pads its
    last superbatch with one empty row and books it on
    ``kta_wire_bytes_total``; the port folds and books only the 24 rows
    (plus the same five merged pair tables)."""
    port = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)),
                    port_backend(k=5), BATCH)
    ref = ref_run_scan(TOPIC, RefSource(RefSpec(**SPEC)), ref_backend(k=5), BATCH)
    row = packed_nbytes(port_backend().config, BATCH)
    assert ref.wire.bytes_total - port.wire.bytes_total == 1 * row
    assert port.wire.as_dict().keys() == ref.wire.as_dict().keys()
    assert port.wire.pairs_raw == ref.wire.pairs_raw
    assert port.wire.pairs_emitted == ref.wire.pairs_emitted


def test_dispatch_telemetry_books_each_superbatch():
    def count(snapshot, name):
        return sum(s.get("count", 0) for s in (snapshot.get(name) or {"samples": []})["samples"])

    default_registry().reset()
    r = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), port_backend(k=4), BATCH)
    assert count(r.telemetry, "kta_superbatch_size") == 6
    assert count(r.telemetry, "kta_dispatch_seconds") == 6
    slots = r.telemetry["kta_stager_slots_total"]["samples"]
    assert sum(s["value"] for s in slots) == 6


# -- CLI ------------------------------------------------------------------------

ARGS = ["-t", TOPIC, "--source", "synthetic",
        "--synthetic", "partitions=3,messages=4000", "-c",
        "--alive-bitmap-bits", "20", "--batch-size", "512", "--quiet"]


def test_cli_superbatch_stats_and_report(capsys):
    assert cli.main(ARGS + ["--device", "cpu", "--superbatch", "4",
                            "--dispatch-depth", "2", "--stats"]) == 0
    out = capsys.readouterr()
    assert "superbatch dispatches (K=4, depth=2)" in out.err
    assert ref_cli.main(ARGS + ["--backend", "tpu"]) == 0
    assert drop_timing(out.out) == drop_timing(capsys.readouterr().out)


def test_cli_rejects_superbatch_on_the_oracle_like_the_reference(capsys):
    argv = ARGS + ["--backend", "cpu", "--superbatch", "4"]
    assert cli.main(argv) == 1
    got = capsys.readouterr().err
    assert ref_cli.main(argv) == 1
    assert got == capsys.readouterr().err
    assert "--backend tpu" in got


def test_cli_superbatch_auto_is_a_no_op(capsys):
    """``auto`` on the oracle, and on the torch backend at the default
    batch of 2^18, resolves to K = 1."""
    assert cli.main(ARGS[:-3] + ["--quiet", "--backend", "cpu", "--superbatch",
                                 "auto", "--json"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["superbatch_k"] == 1
    assert cli.main(ARGS[:-3] + ["--quiet", "--device", "cpu", "--superbatch",
                                 "auto", "--json"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["superbatch_k"] == 1


def test_cli_rejects_a_bad_superbatch_spec(capsys):
    assert cli.main(ARGS + ["--device", "cpu", "--superbatch", "many"]) == 1
    assert "--superbatch" in capsys.readouterr().err


@pytest.mark.cuda
def test_cuda_superbatch_launches_one_kernel_per_row():
    """On the card a K = 4 scan goes through the CUDA wrappers: one
    counter-kernel launch per row, and the K = 1 report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the counter kernels have no CPU mode)")
    from kafka_topic_analyzer_tpu_torch.ops.counters_merge import counters_merge
    from kafka_topic_analyzer_tpu_torch.ops.counters_update import counters_update

    for fmt, kernel in (("v5", counters_merge), ("v4", counters_update)):
        cfg = AnalyzerConfig(num_partitions=3, batch_size=BATCH, **FEATURES, **FORMATS[fmt])
        kernel.launches = 0
        backend = TorchBackend(cfg, init_now_s=NOW, device="cuda",
                               dispatch=DispatchConfig(superbatch=4, depth=2))
        r = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**SPEC)), backend, BATCH)
        assert kernel.launches == backend.dispatches == 24
        assert report(render_report, r) == ref_k1_report(fmt)
