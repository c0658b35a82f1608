"""The port's multi-controller mesh (``--distributed COORD:PORT,PID,NPROCS``)
on the CPU: two processes over a gloo group on loopback, each feeding its
own block of the mesh's data rows.

The reference's own two-process tests (``tests/test_multihost.py``) need
JAX's multi-process CPU collectives; here the port's two-process scans
are held to the reference's single-process mesh on 8 virtual devices
(tests/conftest.py) and to the port's single-process mesh: metrics, the
report, ``--json``, per-controller ingest workers, per-process snapshots
(loaded by both packages) and the exit codes and "on another process"
blocks of a scan issue met on one side.  The inputs are
``tests/test_multihost.py``'s spec.

Children are either the port's CLI or this module run as a script
(``python tests/test_torch_distributed.py MODE PID PORT OUT [SNAPSHOTS]``,
see `child_main`); every child is waited on with a timeout.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from kafka_topic_analyzer_tpu_torch import checkpoint
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.parallel.mesh import initialize_distributed
from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOPIC = "mh-topic"
NOW = 10**10
BATCH = 2048
#: Seconds any child may take; a hang fails the test instead of blocking.
CHILD_TIMEOUT_S = 240


def spec(partitions: int) -> dict:
    return dict(num_partitions=partitions, messages_per_partition=5000,
                keys_per_partition=500, key_null_permille=50,
                tombstone_permille=100, seed=42)


def config_kw(partitions: int) -> dict:
    return dict(num_partitions=partitions, batch_size=BATCH, count_alive_keys=True,
                alive_bitmap_bits=16, enable_hll=True, enable_quantiles=True,
                mesh_shape=(8, 1))


# -- the children ----------------------------------------------------------------

class Interrupt(RuntimeError):
    pass


class StepBomb:
    """Calls ``action`` in place of the ``limit + 1``-th round: every
    process folds the same rounds, so a bomb armed alike on both fires at
    the same round."""

    def __init__(self, inner, limit: int, action):
        self._inner, self._limit, self._action, self._n = inner, limit, action, 0

    def update_shards(self, batches):
        self._n += 1
        if self._n > self._limit:
            self._action()
        return self._inner.update_shards(batches)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class CaptureStart:
    """Records the ``start_at`` of every stream the engine opens."""

    def __init__(self, inner, captured: list):
        self._inner, self._captured = inner, captured

    def batches(self, batch_size, partitions=None, start_at=None):
        self._captured.append(start_at)
        return self._inner.batches(batch_size, partitions, start_at)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def raise_interrupt():
    raise Interrupt()


def child_main(argv) -> int:
    """One process of a two-process scan: ``MODE PID PORT OUT
    [SNAPSHOTS]``.  Writes ``OUT/p<PID>.json`` with what the parent
    checks.  MODE: ``plain`` (6 partitions), ``workers`` (16 partitions, 8
    ingest workers per controller), ``resume`` and ``resume-missing``
    (interrupted after one round with a snapshot per round, then resumed
    on a fresh backend; under ``resume-missing`` process 1 deletes its
    file first), ``dead`` and ``hung`` (process 1 exits, or sleeps, in
    place of its third round)."""
    mode, pid, port, out = argv[0], int(argv[1]), argv[2], pathlib.Path(argv[3])
    initialize_distributed(f"127.0.0.1:{port},{pid},2")
    n = 16 if mode == "workers" else 6
    config = AnalyzerConfig(**config_kw(n))

    def backend():
        return ShardedTorchBackend(config, device="cpu", init_now_s=NOW)

    def source():
        return SyntheticSource(SyntheticSpec(**spec(n)))

    doc: dict = {}
    if mode in ("dead", "hung"):
        def stop():
            if pid == 1:
                if mode == "dead":
                    os._exit(3)
                time.sleep(3600)

        run_scan(TOPIC, source(), StepBomb(backend(), 2, stop), BATCH)
        return 0
    if mode.startswith("resume"):
        snaps = argv[4]
        try:
            run_scan(TOPIC, source(), StepBomb(backend(), 1, raise_interrupt), BATCH,
                     snapshot_dir=snaps, snapshot_every_s=0.0)
            raise AssertionError("the interrupt did not fire")
        except Interrupt:
            pass
        path = pathlib.Path(snaps) / f"scan_snapshot.p{pid}of2.npz"
        doc["file"] = path.exists()
        doc["interrupted_seen"] = checkpoint.snapshot_info(
            snaps, (pid, 2, [4 * pid + r for r in range(4)]))["records_seen"]
        if mode == "resume-missing" and pid == 1:
            path.unlink()
        captured: list = []
        result = run_scan(TOPIC, CaptureStart(source(), captured), backend(), BATCH,
                          snapshot_dir=snaps, resume=True)
        doc["resumed_from"] = [s for s in captured if s]
    else:
        result = run_scan(TOPIC, source(), backend(), BATCH,
                          ingest_workers=8 if mode == "workers" else 1)
    telemetry = result.telemetry
    doc.update(
        metrics=json.loads(json.dumps(
            result.metrics.to_dict(result.start_offsets, result.end_offsets))),
        records=result.records,
        ingest_workers=result.ingest_workers,
        ingest_workers_per_controller=result.ingest_workers_per_controller,
        worker_labels=sorted(
            s["labels"]["worker"]
            for s in telemetry.get("kta_ingest_worker_records_total", {}).get("samples", [])
        ),
        lag={s["labels"]["partition"]: s["value"]
             for s in telemetry["kta_partition_lag"]["samples"]},
        scan_records_total=telemetry["kta_scan_records_total"]["samples"][0]["value"],
    )
    (out / f"p{pid}.json").write_text(json.dumps(doc))
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(timeout_s: float = 120.0) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env["KTA_DISTRIBUTED_TIMEOUT_S"] = str(timeout_s)
    # Two children beside the other test workers: one intra-op thread
    # each keeps them from crowding the host's cores.
    env["OMP_NUM_THREADS"] = "1"
    return env


def finish(procs) -> list:
    """(rc, stdout, stderr) of each child, waiting on each with a timeout;
    on a timeout every child is killed and the test fails."""
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a child timed out; finished: {outs}")
    return outs


def script_pair(mode: str, out, *extra, timeout_s: float = 120.0):
    port = free_port()
    return [
        subprocess.Popen(
            [sys.executable, __file__, mode, str(pid), str(port), str(out), *extra],
            cwd=ROOT, env=child_env(timeout_s), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]


def cli_pair(argv, nprocs: int = 2) -> list:
    """The port's CLI in ``nprocs`` processes on the host."""
    port = free_port()
    return finish([
        subprocess.Popen(
            [sys.executable, "-m", "kafka_topic_analyzer_tpu_torch", *argv,
             "--device", "cpu", "--distributed", f"127.0.0.1:{port},{pid},{nprocs}"],
            cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in range(nprocs)
    ])


def ok_docs(out) -> "list[dict]":
    return [json.loads((out / f"p{pid}.json").read_text()) for pid in range(2)]


# -- the single-process references ---------------------------------------------

_REFERENCE: dict = {}


def reference_metrics(partitions: int) -> dict:
    """The reference's single-process ``--mesh 8,1`` scan of the spec (8
    virtual devices), through JSON as the children's."""
    if partitions not in _REFERENCE:
        from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
        from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
        from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
        from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
        from kafka_topic_analyzer_tpu.parallel.sharded import ShardedTpuBackend

        result = ref_run_scan(
            TOPIC, RefSource(RefSpec(**spec(partitions))),
            ShardedTpuBackend(RefConfig(**config_kw(partitions)), init_now_s=NOW), BATCH)
        _REFERENCE[partitions] = json.loads(json.dumps(
            result.metrics.to_dict(result.start_offsets, result.end_offsets)))
    return _REFERENCE[partitions]


def port_single_metrics(partitions: int) -> dict:
    """The port's single-process ``--mesh 8,1`` scan of the spec."""
    backend = ShardedTorchBackend(AnalyzerConfig(**config_kw(partitions)),
                                  device="cpu", init_now_s=NOW)
    result = run_scan(TOPIC, SyntheticSource(SyntheticSpec(**spec(partitions))),
                      backend, BATCH)
    return json.loads(json.dumps(
        result.metrics.to_dict(result.start_offsets, result.end_offsets)))


def check_merged(docs, partitions: int) -> None:
    """Both processes hold the same merged metrics, equal to the
    reference's single-process mesh and the port's; the gathered
    telemetry holds every partition's lag once (drained to 0)."""
    want = reference_metrics(partitions)
    assert docs[0]["metrics"] == docs[1]["metrics"] == want
    assert port_single_metrics(partitions) == want
    for doc in docs:
        assert doc["lag"] == {str(p): 0 for p in range(partitions)}


def test_the_slices_modules_import_without_jax_or_the_reference():
    """The multi-controller backend and the producer load in a process
    where ``jax`` and the reference package cannot be imported (the AST
    scan of ``tests/test_torch_imports.py`` reads every port file)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kafka_topic_analyzer_tpu'] = None\n"
        "import kafka_topic_analyzer_tpu_torch.parallel.sharded\n"
        "import kafka_topic_analyzer_tpu_torch.io.kafka_produce\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kafka_topic_analyzer_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=child_env(),
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr


# -- ownership -------------------------------------------------------------------

@pytest.mark.parametrize("data,nprocs", [(8, 2), (4, 4), (6, 3), (2, 2)])
def test_each_process_owns_a_contiguous_block_of_rows(data, nprocs, monkeypatch):
    """Process p of N owns rows [p·D/N, (p+1)·D/N) and places only their
    shards, round-robin on its own devices; the blocks cover the axis."""
    from kafka_topic_analyzer_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(port_mesh, "process_count", lambda: nprocs)
    owned = []
    for pid in range(nprocs):
        monkeypatch.setattr(port_mesh, "process_index", lambda pid=pid: pid)
        m = port_mesh.make_mesh(data, 2, devices=["cpu"])
        rows = port_mesh.local_data_rows(m)
        per = data // nprocs
        assert rows == list(range(pid * per, (pid + 1) * per))
        assert all((m.device_of(d, s) is not None) == (d in rows)
                   for d in range(data) for s in range(2))
        owned += rows
    assert owned == list(range(data))


@pytest.mark.parametrize("data,nprocs,row,owners", [(3, 2, 1, [0, 1]), (5, 3, 1, [0, 1]),
                                                    (1, 2, 0, [0, 1])])
def test_rows_indivisible_by_the_process_count_raise_everywhere(data, nprocs, row,
                                                                owners, monkeypatch):
    """The reference's message, naming the first row that would straddle
    two processes, on every process (none may go on to a collective the
    others never reach)."""
    from kafka_topic_analyzer_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(port_mesh, "process_count", lambda: nprocs)
    for pid in range(nprocs):
        monkeypatch.setattr(port_mesh, "process_index", lambda pid=pid: pid)
        with pytest.raises(ValueError, match=re.escape(
                f"mesh data row {row} spans processes {owners}; choose data_shards "
                "divisible by the process count")):
            port_mesh.make_mesh(data, 1, devices=["cpu"])


# -- the engine ------------------------------------------------------------------

def test_two_process_scan_equals_the_single_process_mesh(tmp_path):
    outs = finish(script_pair("plain", tmp_path))
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    docs = ok_docs(tmp_path)
    check_merged(docs, 6)
    # Rows 0-3 hold partitions 0-3, rows 4-5 partitions 4-5 (6-7 none).
    assert [d["records"] for d in docs] == [4 * 5000, 2 * 5000]
    for doc in docs:
        assert doc["scan_records_total"] == 6 * 5000
        assert doc["ingest_workers_per_controller"] == [4, 2]


def test_per_controller_fanin(tmp_path):
    """16 partitions (2 a row), ``--ingest-workers 8`` per controller: each
    process resolves 8 workers over its own 8 partitions, 2 per row, and
    the gathered worker labels are the two controllers' disjoint union."""
    outs = finish(script_pair("workers", tmp_path))
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    docs = ok_docs(tmp_path)
    check_merged(docs, 16)
    for doc in docs:
        assert doc["ingest_workers"] == 8
        assert doc["ingest_workers_per_controller"] == [8, 8]
        assert doc["worker_labels"] == sorted(f"c{c}.{w}" for c in range(2)
                                              for w in range(8))
        assert doc["scan_records_total"] == 16 * 5000


@pytest.mark.parametrize("mode", ["resume", "resume-missing"])
def test_interrupted_and_resumed(mode, tmp_path):
    """Per-process snapshots of a scan interrupted after one round; the
    resumed pair equals the uninterrupted scan, also when process 1 lost
    its file and rescans its rows from zero.  Process 1's file loads in
    the reference's ``load_snapshot(scope=...)`` as in the port's, and a
    scope of another layout raises the reference's message in both."""
    from kafka_topic_analyzer_tpu import checkpoint as ref_checkpoint
    from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
    from kafka_topic_analyzer_tpu.models.state import AnalyzerState as RefState

    snaps = tmp_path / "snaps"
    snaps.mkdir()
    outs = finish(script_pair(mode, tmp_path, str(snaps)))
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    docs = ok_docs(tmp_path)
    check_merged(docs, 6)
    assert all(d["file"] for d in docs)
    # One round of 2048 records a row: rows 0-3 of process 0, 4-5 of 1.
    assert [d["interrupted_seen"] for d in docs] == [4 * BATCH, 2 * BATCH]
    # Each process's streams start at its own partitions' saved offsets.
    assert docs[0]["resumed_from"] and all(
        s[str(p)] == BATCH for s in docs[0]["resumed_from"] for p in range(4))
    if mode == "resume":
        assert docs[1]["resumed_from"] and all(
            s[str(p)] == BATCH for s in docs[1]["resumed_from"] for p in (4, 5))
    else:
        assert docs[1]["resumed_from"] == []
    if mode != "resume":
        assert sorted(os.listdir(snaps)) == ["scan_snapshot.p0of2.npz"]
        return
    assert sorted(os.listdir(snaps)) == ["scan_snapshot.p0of2.npz",
                                         "scan_snapshot.p1of2.npz"]
    import jax

    scope = (1, 2, [4, 5, 6, 7])
    config = AnalyzerConfig(**config_kw(6))
    ref_config = RefConfig(**config_kw(6))
    got = checkpoint.load_snapshot(str(snaps), TOPIC, config, scope=scope)
    # The reference's process-local template: 4 rows of every leaf.
    template = jax.tree.map(lambda x: np.stack([np.asarray(x)] * 4),
                            RefState.init(ref_config))
    want = ref_checkpoint.load_snapshot(str(snaps), TOPIC, ref_config,
                                        template=template, scope=scope)
    assert got[1:] == want[1:]
    want_leaves = {".".join(p.name for p in path): np.asarray(leaf) for path, leaf
                   in jax.tree_util.tree_flatten_with_path(want[0])[0]}
    assert got[0].keys() == want_leaves.keys()
    for name, arr in want_leaves.items():
        assert got[0][name].dtype == arr.dtype and np.array_equal(got[0][name], arr), name
    assert got[0]["alive.words"].shape == (4, 1 << 11)
    message = re.escape(
        "belongs to a different process layout (process/data-row mismatch)")
    with pytest.raises(ValueError, match=message):
        ref_checkpoint.load_snapshot(str(snaps), TOPIC, ref_config, template=template,
                                     scope=(1, 2, [0, 1, 2, 3]))
    with pytest.raises(ValueError, match=message):
        checkpoint.load_snapshot(str(snaps), TOPIC, config, scope=(1, 2, [0, 1, 2, 3]))


@pytest.mark.parametrize("mode", ["dead", "hung"])
def test_a_dead_peer_fails_the_survivor(mode, tmp_path):
    """Process 1 exits (or stops) in place of its third round: process 0
    fails at its next agreement, with a non-zero exit, within the group's
    timeout (5 s here) rather than hanging."""
    procs = script_pair(mode, tmp_path, timeout_s=5.0)
    t0 = time.monotonic()
    try:
        _, err = procs[0].communicate(timeout=60)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert procs[0].returncode != 0, err
    assert waited < 60
    if mode == "dead":
        assert procs[1].returncode == 3


# -- the CLI ---------------------------------------------------------------------

SYN = ["--source", "synthetic", "--synthetic",
       "partitions=6,messages=5000,keys=500,tombstones=100", "-c",
       "--alive-bitmap-bits", "16", "--distinct-keys", "--quantiles",
       "--batch-size", "2048", "--mesh", "8,1", "--quiet"]


def drop_timing(text: str) -> str:
    return "".join(l for l in text.splitlines(keepends=True)
                   if not l.startswith(("Scanning took:", "Estimated Msg/s:")))


def reference_cli(argv, capsys) -> "tuple[int, str, str]":
    from kafka_topic_analyzer_tpu import cli as ref_cli
    from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry

    capsys.readouterr()
    ref_registry().reset()
    rc = ref_cli.main([*argv, "--backend", "tpu", "--native", "off"])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("case", ["plain", "json", "multi-topic"])
def test_cli_process_0_reports_like_the_reference(case, capsys):
    """Process 0's stdout is the reference's single-process report (or
    document), timing lines aside; process 1 prints nothing on stdout;
    both exit 0."""
    if case == "multi-topic":
        argv = ["-t", "a,b,c", "--source", "synthetic", "--synthetic",
                "partitions=3,messages=2000,keys=200", "-c", "--alive-bitmap-bits",
                "16", "--batch-size", "512", "--mesh", "4", "--quiet"]
    else:
        argv = ["-t", TOPIC, *SYN] + (["--json"] if case == "json" else [])
    (rc0, out0, err0), (rc1, out1, err1) = cli_pair(argv)
    rrc, rout, _ = reference_cli(argv, capsys)
    assert (rc0, rc1) == (rrc, rrc) == (0, 0), (err0, err1)
    assert out1 == ""
    assert "Subscribing to" in err1
    if case != "json":
        assert drop_timing(out0) == drop_timing(rout)
        return
    port, ref = json.loads(out0), json.loads(rout)
    assert port.keys() == ref.keys()
    # The telemetry merges both processes' registries, and the wire block
    # and the worker count are this process's (as in the reference's
    # multi-controller documents); every other key is the single-process
    # document's.
    for key in ref:
        if key not in ("duration_secs", "flight", "telemetry", "wire",
                       "ingest_workers", "ingest_workers_per_controller"):
            assert port[key] == ref[key], key
    assert port["ingest_workers"] == 4
    assert port["ingest_workers_per_controller"] == [4, 2]
    for key in ("format", "batch_size", "per_record_bytes", "table_bytes",
                "alive_compaction"):
        assert port["wire"][key] == ref["wire"][key], key
    assert port["flight"]["controllers"] == 2
    for name in ("kta_scan_records_total", "kta_partition_lag"):
        assert port["telemetry"][name] == ref["telemetry"][name], name


def test_cli_stats_names_both_controllers():
    """16 partitions, 2 a row, ``--ingest-workers 8`` per controller: the
    ``--stats`` ingest line of each process gives the fleet's 16 workers,
    each controller's 8, and the 16 labelled workers in natural order."""
    (rc0, _, err0), (rc1, _, err1) = cli_pair(
        ["-t", TOPIC, *SYN, "--synthetic", "partitions=16,messages=3000,keys=300",
         "--ingest-workers", "8", "--stats"])
    assert (rc0, rc1) == (0, 0), err0
    for err in (err0, err1):
        line = next(l for l in err.splitlines() if "ingest: " in l and "worker(s)" in l)
        assert line.startswith("  ingest: 16 worker(s) across 2 controller(s) (8+8)"), line
        assert re.findall(r"\b(c\d\.\d+) ", line) == [
            f"c{c}.{w}" for c in range(2) for w in range(8)], line


def kafka_rows(p: int, n: int):
    return [(i, 1_600_000_000_000 + i * 1000, b"k%d-%d" % (p, i % 37), bytes(20 + i % 13))
            for i in range(n)]


def test_cli_corrupt_partition_on_the_other_process(capsys):
    """Partition 1 (process 1's row) carries a poisoned frame: both
    processes exit 4 (the reference's code), process 0 renders the
    reference's CORRUPT block for "another process", process 1 nothing."""
    from fake_broker import CorruptionInjector, FakeBroker

    from kafka_topic_analyzer_tpu.report import render_corrupt_block

    inj = CorruptionInjector().flip_byte(1, chunk=2)
    with FakeBroker(TOPIC, {p: kafka_rows(p, 300) for p in range(2)},
                    max_records_per_fetch=50, corruption=inj,
                    honor_partition_max_bytes=True) as b:
        (rc0, out0, err0), (rc1, out1, err1) = cli_pair(
            ["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", "-c", "--check-crcs",
             "--on-corruption", "skip", "--mesh", "2", "--quiet",
             "--librdkafka", "retry.backoff.ms=5"])
    assert (rc0, rc1) == (4, 4), (err0, err1)
    assert out1 == ""
    block = render_corrupt_block({-1: {
        "frames": 0, "records": 0, "bytes": 0, "quarantined": 0, "kinds": {},
        "spans": [], "note": "corrupt frame(s) on another process (see its log)"}})
    assert out0.endswith(block)
    assert "  another process: 0 frame(s)" in block


def test_cli_degraded_partition_on_the_other_process():
    """Partition 1's broker (node 1, which only process 1 fetches from)
    dies at the first fetch: both processes exit 3, and process 0 renders
    the reference's DEGRADED block for "another process"."""
    from fake_broker import FakeCluster, FaultInjector

    from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
    from kafka_topic_analyzer_tpu.report import render_degraded_block

    armed = []

    def kill_node_1_on_first_fetch(api_key: int, node_id: int) -> float:
        if api_key == ref_kc.API_FETCH and node_id == 1 and not armed:
            armed.append(True)
            cluster.nodes[1].faults = (FaultInjector()
                                       .drop_connection(0, times=10**6)
                                       .refuse_connections(times=10**6))
        return 0.0

    with FakeCluster(TOPIC, {p: kafka_rows(p, 300) for p in range(3)}, n_nodes=2,
                     max_records_per_fetch=100,
                     response_delay=kill_node_1_on_first_fetch) as cluster:
        (rc0, out0, err0), (rc1, out1, err1) = cli_pair(
            ["-t", TOPIC, "-b", cluster.bootstrap, "-c", "--mesh", "2", "--quiet",
             "--librdkafka", "retry.backoff.ms=5,reconnect.backoff.max.ms=40,"
             "transport.retry.budget=3,socket.timeout.ms=500"])
    assert (rc0, rc1) == (3, 3), (err0, err1)
    assert out1 == ""
    block = render_degraded_block(
        {-1: "partition(s) degraded on another process (see its log)"})
    assert out0.endswith(block)


# -- refusals --------------------------------------------------------------------

def test_cli_refuses_a_bad_spec(capsys):
    from kafka_topic_analyzer_tpu_torch import cli

    assert cli.main(["-t", TOPIC, *SYN, "--device", "cpu",
                     "--distributed", "127.0.0.1:1234,0"]) == 1
    assert ("error: bad --distributed '127.0.0.1:1234,0': expected "
            "coordinator:port,pid,nprocs") in capsys.readouterr().err


@pytest.mark.parametrize("case", ["indivisible", "fleet", "follow"])
def test_cli_refusals_by_the_references_words(case):
    """Every process refuses, with exit 1 and the reference's message: a
    data axis that does not divide by the process count, ``--fleet`` and
    ``--follow``."""
    argv, message = {
        "indivisible": (["-t", TOPIC, *SYN, "--mesh", "3"],
                        "error: mesh data row 1 spans processes [0, 1]; choose "
                        "data_shards divisible by the process count so every "
                        "data shard has one feeding host"),
        "fleet": (["-t", "*", "--fleet", "-b", "127.0.0.1:9"],
                  "error: --fleet does not support --distributed (per-poll "
                  "admission would need fleet-wide lockstep agreement); run the "
                  "fleet single-controller"),
        "follow": (["-t", TOPIC, "-b", "127.0.0.1:9", "--mesh", "2", "--follow"],
                   "error: --follow does not support multi-controller meshes yet "
                   "(pass entry would need per-poll lockstep agreement); run the "
                   "service single-controller"),
    }[case]
    if case == "follow":
        from fake_broker import FakeBroker

        with FakeBroker(TOPIC, {p: kafka_rows(p, 20) for p in range(2)}) as b:
            argv[argv.index("127.0.0.1:9")] = f"127.0.0.1:{b.port}"
            outs = cli_pair(argv)
    else:
        outs = cli_pair(argv)
    for rc, _, err in outs:
        assert rc == 1 and message in err, err
    # A follow service refuses after the banners, as the reference's does.
    assert outs[1][1] == "" and (outs[0][1] == "") == (case != "follow")


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:]))
