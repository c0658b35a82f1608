"""The port's host-side benchmark tools against the reference's:
``bench_ingest`` (same key set, same record counts), ``bench_e2e`` (every
flag of the reference's runner, the same count fields on a compressed
v4 superbatch run, the oracle backend and the service-observability
stack), and the staged ``bench_hw`` and ``tunnel_probe``, which skip the
stages that need a card when run with ``--device cpu``."""

import argparse
import json
import re

import numpy as np
import pytest

from kafka_topic_analyzer_tpu import engine as ref_engine
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu.tools import bench_e2e as ref_bench_e2e
from kafka_topic_analyzer_tpu.tools import bench_ingest as ref_bench_ingest
from kafka_topic_analyzer_tpu_torch import engine
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.tools import (
    bench_e2e,
    bench_hw,
    bench_ingest,
    tunnel_probe,
)


@pytest.fixture(autouse=True)
def _reset_registries():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def run_json(main, argv, capsys) -> "tuple[dict, str]":
    assert main(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def stderr_count(err: str, what: str) -> int:
    m = re.search(rf"bench_ingest: {what} (\d+) records", err)
    assert m, err
    return int(m.group(1))


INGEST = ["--records", "120000", "--records-per-batch", "512", "--partitions", "4",
          "--batch-size", "4096", "--repeat", "1"]


@pytest.mark.parametrize("extra", [
    ["--skip-drain", "--workers", "2"],
    ["--streams", "2", "--pipeline-threads", "2"],
], ids=["workers", "streams"])
def test_bench_ingest_counts_what_the_references_counts(extra, capsys):
    got, got_err = run_json(bench_ingest.main, INGEST + extra, capsys)
    want, want_err = run_json(ref_bench_ingest.main, INGEST + extra, capsys)
    assert set(got) == set(want)
    # 120000 // 512 windows of 512 records each in the socket-free pipeline.
    assert stderr_count(got_err, "pipeline") == stderr_count(want_err, "pipeline") \
        == 234 * 512
    for key in ("nproc", "workers", "streams", "pipeline_threads",
                "scan_worker_records"):
        assert got.get(key) == want.get(key), key
    if "--workers" in extra:
        # 120000 // (4 partitions * 512) = 58 windows a partition, two
        # partitions a worker.
        assert got["scan_worker_records"] == {"0": 2 * 58 * 512, "1": 2 * 58 * 512}
        assert got["workers"] == 2
    else:
        # Each of 2 streams: 120000 // (2 * 4 * 512) = 29 windows a partition.
        assert stderr_count(got_err, "drain") == stderr_count(want_err, "drain") \
            == 2 * 29 * 4 * 512
        assert got["streams"] == 2 and len(got["stream_msgs_per_sec"]) == 2
    rates = [v for k, v in got.items()
             if k.endswith("msgs_per_sec") and isinstance(v, (int, float))]
    assert rates and all(v > 0 for v in rates)


class _Parsed(Exception):
    pass


def flags_of(run, monkeypatch) -> "set[str]":
    """The long options of the parser ``run`` builds (it is stopped at its
    ``parse_args``)."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            run([])
    return {s for s in e.value.args[0]._option_string_actions if s.startswith("--")}


def test_bench_e2e_takes_every_flag_of_the_references(monkeypatch):
    ours, theirs = flags_of(bench_e2e.run, monkeypatch), flags_of(ref_bench_e2e.run, monkeypatch)
    assert ours - {"--device"} == theirs
    assert {"--compression", "--templates", "--tombstone-every", "--vmin", "--vmax",
            "--wire-format", "--alive-compaction", "--superbatch", "--dispatch-depth",
            "--service-obs", "--backend"} <= ours


COUNT_FIELDS = ("superbatch_k", "dispatch_depth", "ingest_workers",
                "ingest_workers_per_controller", "mesh", "batch_size")
E2E = ["--records", "200000", "--compression", "lz4", "--tombstone-every", "7",
       "--wire-format", "v4", "--superbatch", "2", "--quiet"]


#: The exact metrics of a scan (`results.TopicMetrics`).
SCAN_FIELDS = ("overall_count", "overall_size", "smallest_message", "largest_message",
               "earliest_ts_s", "latest_ts_s")


def scans_of(monkeypatch, module) -> list:
    """The metrics of every ``module.run_scan`` call made from now on."""
    seen, real = [], module.run_scan

    def spy(*args, **kwargs):
        result = real(*args, **kwargs)
        seen.append(result.metrics)
        return result

    monkeypatch.setattr(module, "run_scan", spy)
    return seen


def test_bench_e2e_counts_what_the_references_counts(monkeypatch, capsys):
    ours, theirs = scans_of(monkeypatch, engine), scans_of(monkeypatch, ref_engine)
    got, _ = run_json(bench_e2e.run, E2E + ["--device", "cpu"], capsys)
    monkeypatch.setenv("KTA_ACCEL_OK", "cpu")
    want, _ = run_json(ref_bench_e2e.run, E2E + ["--backend", "tpu"], capsys)
    assert {k: got[k] for k in COUNT_FIELDS} == {k: want[k] for k in COUNT_FIELDS}
    assert got["superbatch_k"] == 2
    # 200000 // (16 partitions * 4096) = 3 windows a partition.
    assert got["records"] == 3 * 16 * 4096
    assert got["value"] > 0 and got["device"] == "cpu"
    # The lz4, tombstone and v4 scan itself: the reference's exact metrics.
    assert len(ours) == len(theirs) == 1
    ours, theirs = ours[0], theirs[0]
    np.testing.assert_array_equal(np.asarray(ours.per_partition),
                                  np.asarray(theirs.per_partition))
    assert {f: int(getattr(ours, f)) for f in SCAN_FIELDS} == \
        {f: int(getattr(theirs, f)) for f in SCAN_FIELDS}
    assert ours.overall_count == got["records"]
    assert np.asarray(ours.per_partition)[:, 1].sum() > 0  # tombstones were counted


def test_bench_e2e_oracle_and_service_obs(tmp_path, capsys):
    history = tmp_path / "history"
    got, err = run_json(bench_e2e.run, [
        "--records", "100000", "--partitions", "4", "--templates", "3",
        "--vmin", "10", "--vmax", "20", "--backend", "cpu",
        "--features", "counters,alive,hll", "--service-obs", str(history),
    ], capsys)
    assert got["records"] == 6 * 4 * 4096 and got["device"] == "cpu"
    assert got["superbatch_k"] == 1 and got["flight"]["verdict"]
    assert any(history.iterdir())  # the telemetry history was persisted
    assert "# e2e:" in err and "backend=cpu" in err


def test_bench_e2e_refuses_a_superbatch_on_the_oracle(capsys):
    with pytest.raises(SystemExit):
        bench_e2e.run(["--backend", "cpu", "--superbatch", "4"])
    assert "--superbatch requires --backend tpu" in capsys.readouterr().err


def test_bench_hw_on_the_host_skips_the_card_stages(tmp_path, capsys):
    path = tmp_path / "hw.json"
    got, err = run_json(bench_hw.main, [
        "--device", "cpu", "--batch-pow", "12", "--steps", "4", "--big-pow", "0",
        "--json", str(path),
    ], capsys)
    assert got == json.loads(path.read_text())
    assert got["platform"] == "cpu" and got["device"] == "cpu"
    for stage in ("build", "transfer", "transfer-conc"):
        assert f"bench_hw: [{stage}] skipped" in err
    for stage in ("init", "pack", "stream", "resident", "counters", "pallas"):
        assert f"bench_hw: [{stage}] ok" in err
    for name in ("stream", "resident", "counters", "pallas"):
        assert got[f"{name}_msgs_per_sec"] > 0
    assert got["v4_vs_v5"] == round(got["pallas_msgs_per_sec"]
                                    / got["counters_msgs_per_sec"], 3)
    assert "transfer_gbps" not in got and "big_msgs_per_sec" not in got


def test_bench_hw_stops_after_the_stage_it_is_given(capsys):
    got, err = run_json(bench_hw.main, ["--device", "cpu", "--batch-pow", "12",
                                        "--stop-after", "pack"], capsys)
    assert got["host_pack_msgs_per_sec"] > 0 and "stream_msgs_per_sec" not in got
    assert "[stream]" not in err


def test_tunnel_probe_on_the_host(capsys):
    got, err = run_json(tunnel_probe.main, ["--device", "cpu", "--batch-size", "4096"],
                        capsys)
    assert got["platform"] == "cpu"
    assert got["stages"]["jit1"] == got["stages"]["put20m"] == "skipped"
    for stage in ("init", "put1", "step-compile", "steps"):
        assert got["stages"][stage] >= 0
        assert f"probe: [{stage}] ok" in err
    assert got["steps_msgs_per_sec"] > 0
