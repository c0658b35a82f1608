"""The port's multi-topic fan-in (``io/multi.py``, ``results.slice_rows``,
``cli.run_multi_topic``: ``-t a,b,c``) against the reference's.

Tolerances: exact for every count and byte-equal for the rendered
reports (per-topic blocks and the union block, timing lines aside) and
the ``--json`` ``topics`` document (timing and telemetry values aside),
on synthetic topics in both wire formats, on the numpy oracle, and on a
Kafka fan-in whose two topics hold the same keys.  The alive-key line of
the union is the sum of the per-topic counts: the per-topic salt of the
32-bit slot hash keeps the same key in two topics apart, which needs the
decoded batch, so the fan-in never takes the fused path.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from fake_broker import FakeBroker
from port_instruments import PORT_ONLY
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import fused_gate, run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.multi import MultiTopicSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.results import slice_rows

SYN = ["--source", "synthetic",
       "--synthetic", "partitions=2,messages=1500,keys=120,tombstones=150",
       "-c", "--alive-bitmap-bits", "20", "--batch-size", "512",
       "--distinct-keys-per-partition", "--quantiles-per-partition",
       "--extremes-table", "--quiet"]
TIMED = ("Scanning took", "Estimated Msg")
#: Telemetry instruments that time things, or that only the port books.
TIMED_TELEMETRY = ("seconds", "_per_sec", "eta", "kta_superbatch_size",
                   "kta_dispatch_inflight", "kta_build_info")


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def _run(main, argv, capsys):
    default_registry().reset()
    ref_registry().reset()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _lines(text):
    return [l for l in text.splitlines() if not any(t in l for t in TIMED)]


def _assert_same_multi_doc(port: dict, ref: dict) -> None:
    assert port.keys() == ref.keys()
    for key in ref:
        if key in ("duration_secs", "flight", "telemetry"):
            continue
        assert port[key] == ref[key], key
    # The reference's instruments, plus exactly the port's own.
    assert sorted(port["telemetry"]) == sorted(set(ref["telemetry"]) | set(PORT_ONLY))
    for name, metric in ref["telemetry"].items():
        if any(t in name for t in TIMED_TELEMETRY) or metric["type"] == "histogram":
            continue
        assert port["telemetry"][name] == metric, name


@pytest.mark.parametrize("port_extra,ref_extra", [
    (["--device", "cpu"], ["--backend", "tpu"]),
    (["--device", "cpu", "--wire-format", "v4", "--native", "off"],
     ["--backend", "tpu", "--wire-format", "v4", "--native", "off"]),
    (["--device", "cpu", "--ingest-workers", "3", "--superbatch", "2"],
     ["--backend", "tpu", "--ingest-workers", "3", "--superbatch", "2"]),
    (["--backend", "cpu"], ["--backend", "cpu"]),
], ids=["v5", "v4", "workers-superbatch", "oracle"])
def test_fan_in_reports_and_json_equal_the_reference(port_extra, ref_extra, capsys):
    argv = ["-t", "north,south,east", *SYN, "--distinct-keys", "--quantiles"]
    prc, pout, _ = _run(cli.main, argv + port_extra, capsys)
    rrc, rout, _ = _run(ref_cli.main, argv + ref_extra, capsys)
    assert prc == rrc == 0
    assert _lines(pout) == _lines(rout)
    assert pout.count("Calculating statistics...") == 3
    assert "FAN-IN UNION of 3 topics: north, south, east" in pout
    prc, pout, perr = _run(cli.main, argv + port_extra + ["--json"], capsys)
    rrc, rout, _ = _run(ref_cli.main, argv + ref_extra + ["--json"], capsys)
    assert prc == rrc == 0
    assert "3-topic fan-in" in perr  # banners leave stdout to the document
    port, ref = json.loads(pout), json.loads(rout)
    _assert_same_multi_doc(port, ref)
    assert list(port["topics"]) == ["north", "south", "east"]
    assert port["union"]["count"] == 3 * 2 * 1500
    # The merged bitmap cannot be un-merged: the union carries the sum,
    # the per-topic slices carry none.
    assert "alive_keys_sum_over_topics" in port["union"]
    assert "alive_keys" not in port["topics"]["north"]


def _spec(seed, partitions=2, messages=1500):
    return SyntheticSpec(num_partitions=partitions,
                         messages_per_partition=messages,
                         keys_per_partition=100, tombstone_permille=150,
                         seed=seed)


@pytest.mark.parametrize("wire", [5, 4])
def test_slices_equal_standalone_scans_and_alive_sums(wire):
    """Each topic's slice of the union state equals that topic scanned
    alone (the oracle), and the union's alive keys are the sum of the
    topics' — with the same keys in two topics counted twice."""
    specs = {"alpha": _spec(1, 2, 1500), "beta": _spec(2, 3, 2200),
             "twin": _spec(1, 2, 1500)}
    multi = MultiTopicSource([(t, SyntheticSource(s)) for t, s in specs.items()])
    assert not multi.supports_fused_sink
    cfg = AnalyzerConfig(num_partitions=7, batch_size=512, count_alive_keys=True,
                         alive_bitmap_bits=20, wire_format=wire)
    backend = TorchBackend(cfg, init_now_s=10**10, device="cpu", use_native=True)
    assert not fused_gate(multi, backend)
    union = run_scan("m", multi, backend, 512).metrics
    alive = 0
    for topic, spec in specs.items():
        solo = run_scan(
            topic, SyntheticSource(spec),
            CpuExactBackend(AnalyzerConfig(
                num_partitions=spec.num_partitions, batch_size=512,
                count_alive_keys=True, alive_bitmap_bits=20,
            ), init_now_s=10**10), 512,
        ).metrics
        rows = multi.rows_for(topic)
        sliced = slice_rows(union, rows, [multi.true_partition(r) for r in rows])
        assert np.array_equal(sliced.per_partition, solo.per_partition)
        assert (sliced.earliest_ts_s, sliced.latest_ts_s, sliced.smallest_message,
                sliced.largest_message, sliced.overall_count, sliced.overall_size) \
            == (solo.earliest_ts_s, solo.latest_ts_s, solo.smallest_message,
                solo.largest_message, solo.overall_count, solo.overall_size)
        alive += solo.alive_keys
    assert union.alive_keys == alive
    assert union.overall_count == 2 * 1500 + 3 * 2200 + 2 * 1500


def _records(p, n):
    return [(i, 1_600_000_000_000 + i * 1000,
             f"key-{p}-{i % 41}".encode() if i % 9 else None,
             bytes(10 + i % 17) if i % 6 else None) for i in range(n)]


def test_kafka_fan_in_same_keys_in_two_topics(capsys):
    """Two Kafka topics holding the same keys: the fused path is off for
    the fan-in (the salt needs decoded batches), and the union's alive
    keys are twice one topic's, in both CLIs."""
    recs = {p: _records(p, 300) for p in range(2)}
    with FakeBroker("left", recs, extra_topics={"right": recs},
                    max_records_per_fetch=64) as broker:
        argv = ["-t", "left,right", "-b", f"127.0.0.1:{broker.port}",
                "--librdkafka", "retry.backoff.ms=5", "-c",
                "--alive-bitmap-bits", "20", "--batch-size", "256", "--quiet",
                "--stats"]
        prc, pout, perr = _run(cli.main, argv + ["--device", "cpu"], capsys)
        rrc, rout, _ = _run(ref_cli.main, argv + ["--backend", "tpu"], capsys)
        src = KafkaWireSource(f"127.0.0.1:{broker.port}", "left",
                              overrides={"retry.backoff.ms": "5"})
        solo = run_scan("left", src, TorchBackend(AnalyzerConfig(
            num_partitions=2, batch_size=256, count_alive_keys=True,
            alive_bitmap_bits=20), device="cpu"), 256).metrics
        src.close()
    assert prc == rrc == 0
    assert _lines(pout) == _lines(rout)
    assert f"Alive keys (sum over topics): {2 * solo.alive_keys}" in pout
    if native.native_available():
        assert "fused:" not in perr  # the fan-in took the chained path


def test_cli_fan_in_errors_equal_the_reference(capsys):
    empty = ["-t", "a,b", "--source", "synthetic", "--synthetic",
             "partitions=1,messages=0", "--quiet"]
    prc, _, perr = _run(cli.main, empty + ["--device", "cpu"], capsys)
    assert prc == cli.EXIT_EMPTY_TOPIC
    assert "Given topic has no content" in perr
    dup = ["-t", "a,a", "--source", "synthetic", "--synthetic",
           "partitions=1,messages=10", "--quiet"]
    prc, pout, perr = _run(cli.main, dup + ["--device", "cpu"], capsys)
    rrc, rout, rerr = _run(ref_cli.main, dup, capsys)
    assert (prc, pout, perr) == (rrc, rout, rerr) == (
        1, "", "error: duplicate topic names in fan-in: ['a', 'a']\n")
