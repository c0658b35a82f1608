"""The port's single-controller mesh (``--mesh D[,S]``:
``parallel/sharded.py``, ``parallel/mesh.py``, the chunked packing and
the engine's per-row streams) against the reference's mesh on 8 virtual
CPU devices (tests/conftest.py).

Every comparison is exact: the stacked state leaf by leaf (HLL registers
and DDSketch buckets included), the reports byte for byte but for the
timing lines, the alive count, the packed chunk bytes.  The inputs are
the reference's ``tests/test_sharded.py`` 7-partition spec (not divisible
by the data shards), made from a seed.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu import packing as ref_packing
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.config import DispatchConfig as RefDispatch
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu.parallel.sharded import ShardedTpuBackend
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, DispatchConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
    batch_alive_pairs,
    pack_chunks,
    pack_pair_table,
    pair_table_capacity,
)
from kafka_topic_analyzer_tpu_torch.parallel import mesh as port_mesh
from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.report import render_report
from test_torch_json import assert_same_doc

NOW = 10**10
SPEC = dict(num_partitions=7, messages_per_partition=3_000, keys_per_partition=300,
            key_null_permille=60, tombstone_permille=180, value_len_min=20,
            value_len_max=220, seed=99)
BATCH = 1024
FEATURES = dict(num_partitions=7, batch_size=BATCH, count_alive_keys=True,
                alive_bitmap_bits=12, distinct_keys_per_partition=True, hll_p=8,
                quantiles_per_partition=True)
#: (wire format, alive compaction, superbatch K)
VARIANTS = [(5, "auto", 1), (5, "auto", 3), (5, "off", 1), (4, "auto", 3)]
MESHES = [(8, 1), (4, 2), (2, 4), (2, 2)]


@pytest.fixture(autouse=True)
def _reset_registries():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def ref_state(backend) -> "dict[str, np.ndarray]":
    """The reference backend's stacked state by the port's leaf paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(backend.get_state()))[0]:
        out[".".join(p.name for p in path)] = np.asarray(leaf)
    return out


def report(result) -> str:
    m = result.metrics
    return render_report("t", m, result.start_offsets, result.end_offsets, 0,
                         show_alive_keys=True)


def scan_both(mesh, wire, compaction, k, workers=1):
    kw = dict(FEATURES, wire_format=wire, alive_compaction=compaction, mesh_shape=mesh)
    ref = ShardedTpuBackend(RefConfig(**kw), init_now_s=NOW,
                            dispatch=RefDispatch(superbatch=k))
    ref_result = ref_run_scan("t", RefSource(RefSpec(**SPEC)), ref, BATCH,
                              ingest_workers=workers)
    port = ShardedTorchBackend(AnalyzerConfig(**kw), init_now_s=NOW, device="cpu",
                               dispatch=DispatchConfig(superbatch=k))
    port_result = run_scan("t", SyntheticSource(SyntheticSpec(**SPEC)), port, BATCH,
                           ingest_workers=workers)
    return ref, ref_result, port, port_result


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "v%d-%s-K%d" % v)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "%dx%d" % m)
def test_sharded_state_equals_the_reference(mesh, variant):
    """The stacked state after a whole scan is the reference's, leaf for
    leaf and bit for bit, and so is the report (alive keys included)."""
    ref, ref_result, port, port_result = scan_both(mesh, *variant)
    want = ref_state(ref)
    got = port.get_state()
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), path
    assert got["alive.words"].shape == (mesh[0], 1 << 7)
    assert port_result.metrics.alive_keys == ref_result.metrics.alive_keys
    assert report(port_result) == report(ref_result)
    assert port.dispatches * mesh[0] * mesh[1] > 0


def test_mesh_report_equals_the_single_device_report_but_for_alive_keys():
    """Every exact line of a mesh scan equals the (1, 1) scan's; the alive
    keys may not (shards OR their rows: keys of two data rows that share a
    slot both count), and here they differ, which the 2^12-slot bitmap
    makes likely."""
    _, _, _, mesh_result = scan_both((4, 2), 5, "auto", 1)
    single = TorchBackend(AnalyzerConfig(**FEATURES), init_now_s=NOW, device="cpu")
    one = run_scan("t", SyntheticSource(SyntheticSpec(**SPEC)), single, BATCH)
    strip = lambda text: [l for l in text.splitlines() if not l.startswith("Alive keys")]
    assert strip(report(mesh_result)) == strip(report(one))
    assert mesh_result.metrics.alive_keys != one.metrics.alive_keys


def test_workers_per_row_compose_with_the_mesh():
    """Three ingest workers split over the data rows give the reference's
    state and worker count."""
    ref, ref_result, port, port_result = scan_both((2, 2), 5, "auto", 1, workers=3)
    want = ref_state(ref)
    got = port.get_state()
    for path, arr in want.items():
        assert np.array_equal(got[path], arr), path
    assert port_result.ingest_workers == ref_result.ingest_workers == 3


def _batch_of(cls, rows):
    b = cls.empty(len(rows))
    for i, (h32, value_len) in enumerate(rows):
        b.partition[i] = 0
        b.key_len[i] = 4
        b.value_null[i] = value_len is None
        b.value_len[i] = 0 if value_len is None else value_len
        b.ts_s[i] = 100 + i
        b.key_hash32[i] = h32
        b.key_hash64[i] = h32
        b.valid[i] = True
    return b


#: Key A alive in chunk 0, tombstoned in chunk 1 (dead); B the other way
#: round (alive); C alive twice in chunk 0; D only in chunk 1, alive.
STRADDLE = [(0xA, 10), (0xB, None), (0xC, 5), (0xC, 6),
            (0xA, None), (0xB, 7), (0xD, 8), (0xD, 9)]


@pytest.mark.parametrize("fmt", [dict(wire_format=5), dict(wire_format=4),
                                 dict(wire_format=5, alive_compaction="off")],
                         ids=["v5", "v4", "compaction-off"])
def test_cross_chunk_last_writer_wins(fmt):
    """A key whose records straddle the space-chunk boundary resolves by
    record order, not by the space shard that saw it: the S-chunk ordered
    apply (and, under compaction, the row's merged table)."""
    cfg = AnalyzerConfig(num_partitions=1, batch_size=8, mesh_shape=(1, 2),
                         count_alive_keys=True, alive_bitmap_bits=8, **fmt)
    backend = ShardedTorchBackend(cfg, init_now_s=NOW, device="cpu")
    backend.update_shards([_batch_of(RecordBatch, STRADDLE)])
    assert backend.finalize().alive_keys == 3
    ref = ShardedTpuBackend(RefConfig(**dataclasses.asdict(cfg)), init_now_s=NOW)
    ref.update_shards([_batch_of(RefBatch, STRADDLE)])
    assert np.array_equal(backend.get_state()["alive.words"], ref_state(ref)["alive.words"])


def test_update_splits_a_mixed_batch_by_partition():
    cfg = AnalyzerConfig(**dict(FEATURES, mesh_shape=(2, 2)))
    whole = ShardedTorchBackend(cfg, init_now_s=NOW, device="cpu")
    batch = next(SyntheticSource(SyntheticSpec(**SPEC)).batches(BATCH))
    whole.update(batch)
    rows = ShardedTorchBackend(cfg, init_now_s=NOW, device="cpu")
    rows.update_shards([batch.take(np.nonzero(batch.partition % 2 == r)[0])
                        for r in range(2)])
    a, b = whole.get_state(), rows.get_state()
    assert all(np.array_equal(a[k], b[k]) for k in a)


# -- packing -------------------------------------------------------------------

CHUNK_CONFIGS = {
    "v5": dict(FEATURES),
    "v4": dict(FEATURES, wire_format=4),
    "compaction-off": dict(FEATURES, alive_compaction="off"),
    "hll-table": dict(FEATURES, hll_p=4),
}


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("name", sorted(CHUNK_CONFIGS))
def test_pack_chunks_equals_the_reference(name, space):
    """Each chunk is packed with the chunk config (batch_size / S), whose
    batch size decides the HLL wire mode: the bytes are the
    reference's, for a full and a short row."""
    kw = dict(CHUNK_CONFIGS[name], batch_size=BATCH // space, mesh_shape=(1, space))
    cfg, ref_cfg = AnalyzerConfig(**kw), RefConfig(**kw)
    src = SyntheticSource(SyntheticSpec(**SPEC)).batches(BATCH)
    ref_src = RefSource(RefSpec(**SPEC)).batches(BATCH)
    for batch, ref_batch in zip(src, ref_src):
        for n in (len(batch), len(batch) // 3):
            got = pack_chunks(batch.take(np.arange(n)), cfg, space)
            want = ref_packing.pack_chunks(ref_batch.take(np.arange(n)), ref_cfg, space,
                                           use_native=False)
            assert got.shape == want.shape and np.array_equal(got, want)
        break


@pytest.mark.parametrize("name", ["v5", "v4", "compaction-off"])
def test_fused_chunk_rows_equal_pack_chunks(name):
    """The sharded sink's ``[S, chunk_nbytes]`` rows are `pack_chunks` of
    the same records cut at S·C records: full rows and the flushed short
    one, whose unreached chunks are packed empty batches; under
    compaction the row's harvested pairs merge into the table of the
    row's records."""
    space = 4
    cfg = AnalyzerConfig(**dict(CHUNK_CONFIGS[name], batch_size=BATCH // space,
                                mesh_shape=(1, space)))
    sink = FusedPackSink(cfg, cfg.batch_size, lambda p: p,
                         stage=lambda row, pairs=None: pairs, space_shards=space)
    batch = next(SyntheticSource(SyntheticSpec(**SPEC)).batches(3000))
    part = batch.take(np.nonzero(batch.partition == 0)[0])  # one partition's run
    n = len(part)
    sink.append_batch(part, reason="frame-fallback")
    sink.flush()
    rows = sink.take_completed()
    assert [r.n_valid for r in rows] == [BATCH] * (n // BATCH) + [n % BATCH]
    for i, row in enumerate(rows):
        records = part.take(np.arange(i * BATCH, min(n, (i + 1) * BATCH)))
        assert np.array_equal(row.buf, pack_chunks(records, cfg, space, use_native=True))
        if cfg.compact_alive:
            cap = pair_table_capacity(cfg, BATCH)
            got, _, _ = pack_pair_table([row.staged], cfg, cap)
            want, _, _ = pack_pair_table([batch_alive_pairs(records, cfg)], cfg, cap)
            assert np.array_equal(got, want)


# -- the mesh ------------------------------------------------------------------

def test_make_mesh_places_shards_round_robin(monkeypatch):
    """Shard (d, s) goes to device (d·S + s) mod the device count: one
    device holds every shard (a host with one card), more devices
    take turns — where the reference refuses a mesh larger than its
    devices (a standing divergence)."""
    cpu = torch.device("cpu")
    mesh = port_mesh.make_mesh(4, 2, devices=["cpu"])
    assert mesh.shape == (4, 2) and mesh.axis_names == ("data", "space")
    assert all(mesh.device_of(d, s) == cpu for d in range(4) for s in range(2))
    assert port_mesh.local_data_rows(mesh) == [0, 1, 2, 3]
    monkeypatch.setattr(port_mesh, "resolve_device", lambda name: name)
    three = port_mesh.make_mesh(4, 2, devices=["a", "b", "c"])
    assert three.devices == (("a", "b"), ("c", "a"), ("b", "c"), ("a", "b"))
    with pytest.raises(ValueError, match="positive"):
        port_mesh.make_mesh(0, 1, devices=["cpu"])


def test_make_mesh_needs_cuda_by_default():
    """No device named: every visible CUDA device, and none is an error,
    never a move to the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_mesh(2, 1)


@pytest.mark.parametrize("variant", [(5, "auto", 1), (4, "auto", 3)],
                         ids=["v5", "v4-K3"])
def test_shards_spread_over_two_devices_fold_like_one(variant):
    """Shards placed round-robin on two devices (two device keys of the
    host here: ``cpu`` and ``cpu:0``) keep one stacked tensor per device:
    the state, its snapshot round trip and the finalize (the bitmap rows
    ORed across devices) equal the one-device mesh's."""
    wire, compaction, k = variant
    cfg = AnalyzerConfig(**dict(FEATURES, wire_format=wire, alive_compaction=compaction,
                                mesh_shape=(2, 2)))
    results, states = [], []
    for devices in (["cpu"], ["cpu", torch.device("cpu", 0)]):
        backend = ShardedTorchBackend(
            cfg, mesh=port_mesh.make_mesh(2, 2, devices=devices), init_now_s=NOW,
            dispatch=DispatchConfig(superbatch=k))
        results.append(report(run_scan("t", SyntheticSource(SyntheticSpec(**SPEC)),
                                       backend, BATCH)))
        states.append(backend.get_state())
        assert len(backend.devices) == len(devices)
    assert results[0] == results[1]
    for path, arr in states[0].items():
        assert np.array_equal(states[1][path], arr), path
    spread = ShardedTorchBackend(cfg, mesh=port_mesh.make_mesh(
        2, 2, devices=["cpu", torch.device("cpu", 0)]), init_now_s=NOW)
    spread.set_state(states[0])
    for path, arr in spread.get_state().items():
        assert np.array_equal(states[0][path], arr), path


def test_mesh_shape_must_match_the_config():
    cfg = AnalyzerConfig(**dict(FEATURES, mesh_shape=(2, 2)))
    with pytest.raises(ValueError, match="mesh shape"):
        ShardedTorchBackend(cfg, mesh=port_mesh.make_mesh(4, 1, devices=["cpu"]))


# -- the CLI -------------------------------------------------------------------

CLI = ["--source", "synthetic", "--synthetic",
       "partitions=7,messages=3000,keys=300,tombstones=180", "-c",
       "--alive-bitmap-bits", "14", "--batch-size", "2048",
       "--distinct-keys-per-partition", "--quantiles-per-partition", "--pallas",
       "--quiet"]


def drop_timing(text: str) -> str:
    return "".join(l for l in text.splitlines(keepends=True)
                   if not l.startswith(("Scanning took:", "Estimated Msg/s:")))


def both(argv, capsys, topic="t"):
    out = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (ref_cli.main, ["--backend", "tpu", "--native", "off"])):
        default_registry().reset()
        ref_registry().reset()
        rc = main(["-t", topic, *argv, *extra])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


CLI_FORMATS = {"v5": [], "v4": ["--wire-format", "v4"],
               "compaction-off": ["--alive-compaction", "off"]}
CLI_CASES = {
    f"{mesh.replace(',', 'x')}-{fmt}": ["--mesh", mesh, *flags]
    for mesh in ("2,2", "4,2", "8,1") for fmt, flags in CLI_FORMATS.items()
}
CLI_CASES["2x2-workers"] = ["--mesh", "2,2", "--ingest-workers", "3"]
CLI_CASES["4x2-K3-workers"] = ["--mesh", "4,2", "--superbatch", "3",
                               "--ingest-workers", "5"]


@pytest.mark.parametrize("extra", CLI_CASES.values(), ids=CLI_CASES)
def test_cli_mesh_report_equals_the_reference(extra, capsys):
    (prc, pout, perr), (rrc, rout, _) = both(CLI + extra, capsys)
    assert prc == rrc == 0, perr
    assert drop_timing(pout) == drop_timing(rout)
    assert "Alive keys:" in pout


def test_cli_mesh_json_equals_the_reference(capsys):
    """The document, the wire block's chunk-sized batch included."""
    (prc, pout, _), (rrc, rout, _) = both(CLI + ["--mesh", "2,2", "--json",
                                                "--ingest-workers", "2"], capsys)
    assert prc == rrc == 0
    port, ref = json.loads(pout), json.loads(rout)
    assert_same_doc(port, ref)
    assert port["wire"]["batch_size"] == 1024


def test_cli_multi_topic_mesh_equals_the_reference(capsys):
    (prc, pout, _), (rrc, rout, _) = both(
        ["--source", "synthetic", "--synthetic", "partitions=3,messages=2000,keys=200",
         "-c", "--alive-bitmap-bits", "16", "--batch-size", "512", "--mesh", "2",
         "--quiet"], capsys, topic="a,b,c")
    assert prc == rrc == 0
    assert drop_timing(pout) == drop_timing(rout)


def test_cli_follow_mesh_equals_the_reference(capsys):
    """A short ``--follow --mesh 2`` service over a loopback broker: each
    pass folds on the mesh backend, and the final report is the
    reference's."""
    from fake_broker import FakeBroker
    from test_torch_follow import FULL, TOPIC

    argv = ["-t", TOPIC, "--librdkafka", "retry.backoff.ms=5", "--follow",
            "--follow-idle-exit", "0.1", "--poll-interval", "0.02", "--quiet", "-c",
            "--alive-bitmap-bits", "16", "--batch-size", "64", "--distinct-keys",
            "--quantiles", "--mesh", "2"]
    with FakeBroker(TOPIC, FULL, max_records_per_fetch=48) as broker:
        b = ["-b", f"127.0.0.1:{broker.port}"]
        out = []
        for main, extra in ((cli.main, ["--device", "cpu"]),
                            (ref_cli.main, ["--backend", "tpu"])):
            rc = main(argv + b + extra)
            out.append((rc, capsys.readouterr().out))
    (prc, pout), (rrc, rout) = out
    assert prc == rrc == 0
    assert drop_timing(pout) == drop_timing(rout)
    assert "Alive keys:" in pout


@pytest.mark.parametrize("mesh", ["2,2", "4,1"])
def test_cli_segfile_mesh_equals_the_reference(mesh, tmp_path, capsys):
    """A segment-file scan on a mesh, fused where the shim loads and
    chained, with 3 workers over the rows: the reference's report."""
    from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

    make_segments(str(tmp_path), "t", SyntheticSpec(**SPEC), use_native=False)
    argv = ["--source", "segfile", "--segment-dir", str(tmp_path), "-c",
            "--alive-bitmap-bits", "14", "--batch-size", "2048", "--mesh", mesh,
            "--ingest-workers", "3", "--distinct-keys", "--quiet"]
    reports = []
    for native_flag in ("auto", "off"):
        (prc, pout, perr), (rrc, rout, _) = both(argv + ["--native", native_flag],
                                                 capsys)
        assert prc == rrc == 0, perr
        reports.append(drop_timing(pout))
        assert reports[-1] == drop_timing(rout)
    assert reports[0] == reports[1]


def test_cli_mesh_refusals(capsys):
    """A batch that does not split into S chunks, and a v4 ``--pallas``
    chunk that is no multiple of 1024, end the port's CLI with the
    reference's messages (the reference raises them at backend
    construction); the oracle ignores the mesh, as the reference's does."""
    assert cli.main(["-t", "t", *CLI, "--mesh", "2,2", "--batch-size", "1001",
                     "--device", "cpu"]) == 1
    assert "batch_size must divide evenly into space_shards chunks" in \
        capsys.readouterr().err
    assert cli.main(["-t", "t", *CLI, "--mesh", "2,4", "--wire-format", "v4",
                     "--device", "cpu"]) == 1
    assert "per-space-shard chunk (batch_size / space_shards) that is a multiple " \
        "of 1024" in capsys.readouterr().err
    assert cli.main(["-t", "t", *CLI, "--mesh", "2,2", "--batch-size", "1001",
                     "--backend", "cpu"]) == 0


def test_stats_lists_every_rows_workers(capsys):
    """Each data row's fan-in numbers its workers on from the last row's,
    so the ``--stats`` ingest line names w0..w4 once each."""
    assert cli.main(["-t", "t", *CLI, "--mesh", "2,2", "--ingest-workers", "5",
                     "--device", "cpu", "--stats"]) == 0
    err = capsys.readouterr().err
    line = next(l for l in err.splitlines() if re.search(r"ingest: \d+ worker", l))
    assert re.findall(r"\bw(\d+) ", line) == ["0", "1", "2", "3", "4"], line


# -- the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_per_shard_launches_on_stacked_views():
    """On the card every shard's counter kernel writes through a view of
    the stacked state (its storage offset in ``data_ptr()``): one launch
    per round and shard, and the state of the same scan on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the counter kernels have no CPU mode)")
    from kafka_topic_analyzer_tpu_torch.ops.counters_merge import counters_merge
    from kafka_topic_analyzer_tpu_torch.ops.counters_update import counters_update

    for wire, kernel in ((5, counters_merge), (4, counters_update)):
        cfg = AnalyzerConfig(**dict(FEATURES, wire_format=wire, mesh_shape=(2, 2)))
        states = {}
        for device in ("cuda", "cpu"):
            kernel.launches = 0
            backend = ShardedTorchBackend(cfg, init_now_s=NOW, device=device)
            run_scan("t", SyntheticSource(SyntheticSpec(**SPEC)), backend, BATCH)
            states[device] = backend.get_state()
            if device == "cuda":
                assert kernel.launches == backend.dispatches * 4 > 0
        for path, arr in states["cpu"].items():
            assert np.array_equal(states["cuda"][path], arr), path


@pytest.mark.cuda
def test_cuda_shards_spread_over_cards_fold_like_one_card():
    """On a host with several cards the default mesh places the shards
    round-robin on all of them (each launch in its card's context, the
    bitmap rows ORed across cards at finalize): the reports, the stacked
    states and the launches equal those of the same mesh on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one card holds every shard)")
    from kafka_topic_analyzer_tpu_torch.ops.counters_merge import counters_merge
    from kafka_topic_analyzer_tpu_torch.ops.counters_update import counters_update

    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    for wire, compaction, k in VARIANTS:
        cfg = AnalyzerConfig(**dict(FEATURES, wire_format=wire,
                                    alive_compaction=compaction, mesh_shape=(2, 2)))
        runs = []
        for devices in (cards, cards[:1]):
            counters_merge.launches = counters_update.launches = 0
            backend = ShardedTorchBackend(
                cfg, mesh=port_mesh.make_mesh(2, 2, devices=devices), init_now_s=NOW,
                dispatch=DispatchConfig(superbatch=k))
            result = run_scan("t", SyntheticSource(SyntheticSpec(**SPEC)), backend, BATCH)
            launches = counters_merge.launches + counters_update.launches
            assert launches == 4 * backend.dispatches > 0
            runs.append((report(result), backend.get_state(), launches))
        (spread, spread_state, n), (one, one_state, m) = runs
        assert spread == one and n == m
        for path, arr in one_state.items():
            assert np.array_equal(spread_state[path], arr), path
