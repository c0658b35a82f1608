"""The port's ``--json`` document (``report.build_json_doc``,
``TopicMetrics.to_dict`` and the digests' ``as_dict``) against the
reference's, through both CLIs.

For the same scan the two documents have the same keys and the same
values, timing values aside (``duration_secs``, the ``flight`` block's
shares and seconds, and the telemetry instruments that time things):
synthetic scans in each wire format, ``--superbatch``, ``--ingest-workers``,
a segment-file scan (the ``segments`` block), and the scans that book
issues — a degraded partition (exit 3), corrupt frames (exit 4) and lost
records (``data_loss``; exit 5 under ``--on-data-loss fail``, with no
document).  Banners go to stderr.  Under ``--metrics-port`` both add
the ``health`` block of their alert engines, equal but for its clock
readings.
"""

import json

import pytest

from fake_broker import CorruptionInjector, FakeBroker
from port_instruments import PORT_ONLY
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSpec
from test_torch_objstore import PortFakeObjectStore

TOPIC = "json.t"
SYN = ["--source", "synthetic", "--synthetic", "partitions=3,messages=4000,keys=300",
       "-c", "--alive-bitmap-bits", "20", "--batch-size", "512",
       "--distinct-keys-per-partition", "--quantiles-per-partition",
       "--extremes-table", "--quiet"]
FAST = "retry.backoff.ms=5,reconnect.backoff.max.ms=40"
#: Instruments whose values are wall-clock times or rates, or that only
#: the port books (its K = 1 dispatch queue books ``kta_superbatch_size``).
TIMED = ("seconds", "_per_sec", "eta", "kta_superbatch_size", "kta_dispatch_inflight",
         "kta_build_info")


@pytest.fixture(autouse=True)
def _reset_registries():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def both(argv, capsys, port_extra=("--device", "cpu"), ref_extra=("--backend", "tpu")):
    """(rc, stdout, stderr) of the port CLI, then of the reference CLI."""
    out = []
    for main, extra in ((cli.main, port_extra), (ref_cli.main, ref_extra)):
        default_registry().reset()
        ref_registry().reset()
        rc = main(["-t", TOPIC, *argv, *extra])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def assert_same_doc(port: dict, ref: dict) -> None:
    assert port.keys() == ref.keys()
    for key in ref:
        if key in ("duration_secs", "flight", "telemetry"):
            continue
        assert port[key] == ref[key], key
    assert port["flight"].keys() == ref["flight"].keys()
    # The reference's instruments, plus exactly the port's own.
    assert sorted(port["telemetry"]) == sorted(set(ref["telemetry"]) | set(PORT_ONLY))
    for name, metric in ref["telemetry"].items():
        if any(t in name for t in TIMED) or metric.get("type") == "histogram":
            continue
        assert port["telemetry"][name] == metric, name


def docs(argv, capsys, **kw):
    (prc, pout, perr), (rrc, rout, rerr) = both(argv + ["--json"], capsys, **kw)
    assert prc == rrc
    assert "Subscribing to" in perr and "Subscribing to" not in pout
    return prc, json.loads(pout), json.loads(rout)


@pytest.mark.parametrize("extra", [[], ["--wire-format", "v4"], ["--alive-compaction", "off"]],
                         ids=["v5", "v4", "compaction-off"])
def test_synthetic_document_equals_the_reference(extra, capsys):
    rc, port, ref = docs(SYN + extra, capsys)
    assert rc == 0
    assert_same_doc(port, ref)
    assert port["superbatch_k"] == 1 and port["ingest_workers_per_controller"] == [1]


@pytest.mark.parametrize("flags", [["--superbatch", "4", "--dispatch-depth", "3"],
                                   ["--ingest-workers", "3"],
                                   ["--superbatch", "3", "--ingest-workers", "2"]],
                         ids=["superbatch", "workers", "both"])
def test_dispatch_and_worker_documents_equal_the_reference(flags, capsys):
    """24 rows per scan: K = 4 and 3 leave no padded tail, so even the
    wire bytes agree."""
    rc, port, ref = docs(SYN + flags, capsys)
    assert rc == 0
    assert_same_doc(port, ref)


def test_segment_document_carries_the_segments_block(tmp_path, capsys):
    make_segments(str(tmp_path), TOPIC, SyntheticSpec.from_kv(
        {"partitions": "3", "messages": "4000", "keys": "300"}))
    argv = ["--source", "segfile", "--segment-dir", str(tmp_path), "-c",
            "--alive-bitmap-bits", "20", "--batch-size", "512", "--quiet"]
    rc, port, ref = docs(argv, capsys)
    assert rc == 0 and port["segments"]["files"] == 3
    assert_same_doc(port, ref)


def test_remote_document_carries_the_store_counters(tmp_path, capsys):
    make_segments(str(tmp_path), TOPIC, SyntheticSpec.from_kv(
        {"partitions": "3", "messages": "4000", "keys": "300"}), chunk_records=1000)
    with PortFakeObjectStore(str(tmp_path)) as store:
        argv = ["--source", "segfile", "--segment-dir", store.url, "-c",
                "--alive-bitmap-bits", "20", "--batch-size", "512", "--quiet",
                "--segment-readahead", "0"]
        rc, port, ref = docs(argv, capsys)
    assert rc == 0 and port["segments"]["store_gets"] == 25  # list + 12 probes + 12 bodies
    assert_same_doc(port, ref)


def test_degraded_document_exits_3_like_the_reference(tmp_path, capsys):
    make_segments(str(tmp_path), TOPIC, SyntheticSpec.from_kv(
        {"partitions": "3", "messages": "2000"}))
    with PortFakeObjectStore(str(tmp_path)) as store:
        argv = ["--source", "segfile", "--segment-dir", store.url,
                "--batch-size", "512", "--quiet", "--segment-readahead", "0",
                "--librdkafka", "retry.backoff.ms=1,reconnect.backoff.max.ms=4,"
                "transport.retry.budget=3", "--json"]
        runs = []
        for main, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, ["--backend", "tpu"])):
            store.script(f"{TOPIC}-1.ktaseg", *[("status", 503)] * 32)
            rc = main(["-t", TOPIC, *argv, *extra])
            runs.append((rc, json.loads(capsys.readouterr().out)))
            store._scripts.clear()
    (prc, port), (rrc, ref) = runs
    assert prc == rrc == cli.EXIT_DEGRADED == 3
    assert list(port["degraded_partitions"]) == ["1"]
    assert_same_doc(port, ref)


def rows(partition: int, n: int):
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{partition}-{i % 37}".encode() if i % 5 else None,
             bytes(20 + (i % 13)) if i % 7 else None) for i in range(n)]


def test_corrupt_document_exits_4_like_the_reference(tmp_path, capsys):
    records = {p: rows(p, 300) for p in range(3)}
    runs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, ["--backend", "tpu"])):
        inj = CorruptionInjector().flip_byte(1, chunk=2).garbage_compression(0, chunk=4)
        with FakeBroker(TOPIC, records, max_records_per_fetch=50, corruption=inj,
                        honor_partition_max_bytes=True) as broker:
            rc = main(["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", "-c",
                       "--alive-bitmap-bits", "20", "--batch-size", "256", "--quiet",
                       "--check-crcs", "--on-corruption", "skip", "--librdkafka", FAST,
                       "--json", *extra])
        runs.append((rc, json.loads(capsys.readouterr().out)))
    (prc, port), (rrc, ref) = runs
    assert prc == rrc == cli.EXIT_CORRUPT == 4
    assert sorted(port["corrupt_partitions"]) == ["0", "1"]
    assert_same_doc(port, ref)


class FetchHook:
    """Runs ``action`` once, right after the broker's ``fire_at``-th fetch."""

    def __init__(self, fire_at: int, action):
        self.fire_at, self.action, self.fetches = fire_at, action, 0

    def __call__(self, api_key: int, node_id: int) -> float:
        if api_key == ref_kc.API_FETCH:
            self.fetches += 1
            if self.fetches == self.fire_at:
                self.action()
        return 0.0


@pytest.mark.parametrize("policy, code", [("report", 0), ("fail", 5)])
def test_lost_records_document_like_the_reference(policy, code, capsys):
    """Retention passes the cursor mid-scan: under ``report`` both
    documents carry the same ``data_loss`` map (exit 0); under ``fail``
    both CLIs exit 5 and print no document."""
    runs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (ref_cli.main, ["--backend", "tpu"])):
        with FakeBroker(TOPIC, {0: rows(0, 400)}, max_records_per_fetch=50) as broker:
            broker.response_delay = FetchHook(3, lambda: broker.expire_to(0, 200))
            rc = main(["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", "--batch-size", "50",
                       "--quiet", "--librdkafka", FAST, "--on-data-loss", policy,
                       "--json", *extra])
        cap = capsys.readouterr()
        runs.append((rc, cap.out))
    (prc, pout), (rrc, rout) = runs
    assert prc == rrc == code
    if code:
        assert pout == rout == ""
        return
    port, ref = json.loads(pout), json.loads(rout)
    assert list(port["data_loss"]) == ["0"]
    assert_same_doc(port, ref)


def test_health_block_is_the_one_gap_under_metrics_port(capsys):
    """Under ``--metrics-port`` both documents carry ``health`` (the
    alert engine's document): the same rules, states, verdict and
    evaluation count; only the clock readings (``evaluated_at`` and the
    per-rule ``since_s``/``firing_s``) differ between two runs."""
    rc, port, ref = docs(SYN + ["--metrics-port", "0"], capsys)
    assert rc == 0
    assert "health" in ref and "health" in port
    assert_same_doc(
        {k: v for k, v in port.items() if k != "health"},
        {k: v for k, v in ref.items() if k != "health"},
    )
    assert clockless_health(port["health"]) == clockless_health(ref["health"])
    assert port["health"]["healthy"] is True
    assert [r["rule"] for r in port["health"]["rules"]] == [
        "lag-growth", "degraded-partitions", "corruption-storm",
        "watermark-refresh-outage", "throughput-regression",
        "fleet-topic-failure", "lease_lost", "failover", "lost-range",
        "truncation",
    ]


def clockless_health(doc: dict) -> dict:
    """A health document without its clock readings."""
    rows = [
        {k: v for k, v in r.items() if k not in ("since_s", "firing_s")}
        for r in doc["rules"]
    ]
    return dict(
        {k: v for k, v in doc.items() if k != "evaluated_at"},
        rules=rows,
        firing=[r for r in rows if r["state"] in ("firing", "resolving")],
    )
