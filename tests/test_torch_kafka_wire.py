"""The port's Kafka wire source, fused record-set rows and Kafka CLI scans
against the reference's, over the loopback `fake_broker` brokers.

The port's `KafkaWireSource` and the reference's give the same partitions,
watermarks and per-partition columns on a plain broker, a flexible
(``modern``) broker, a three-node cluster, byte-limited responses
(partition and request budgets), compressed and legacy topics and topics
with transaction markers, with native decoding on and off.  Rows the fused
sink packs straight from fetched record sets equal the chained
``pack_batch`` rows of the same records in wire v5 and v4, and the
records the sink could not decode→pack in one pass are counted by reason.
The port CLI (``--backend cpu``) prints the reference CLI's report bytes
(timing lines aside) in v5, v4 and compaction off, native on and off, and
from a timestamp.  All comparisons are exact.

Keys are distinct across partitions and their alive-bitmap slots do not
collide, so ``-c`` does not depend on the order in which the fetches of
different partitions arrive.
"""

import numpy as np
import pytest
import torch

from fake_broker import FakeBroker, FakeCluster
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.io.kafka_wire import KafkaWireSource as RefSource
from kafka_topic_analyzer_tpu_torch import cli, packing
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
from kafka_topic_analyzer_tpu_torch.ops.fnv import fnv1a32_ref_batch
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

TOPIC = "wire.t"
BITS = 24
FAST = {"retry.backoff.ms": "5", "reconnect.backoff.max.ms": "40",
        "socket.timeout.ms": "5000"}


def topic_records(seed: int, parts: int = 3, n: int = 400, keys: int = 60,
                  ts0: int = 1_700_000_000_000):
    """(offset, ts_ms, key, value) per partition: keys distinct across
    partitions, null keys, tombstones, values 0-300 B, rising times."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in range(parts):
        rows = []
        for o in range(n):
            key = None if rng.random() < 0.05 else b"p%d-key-%d" % (p, rng.integers(keys))
            value = None if rng.random() < 0.12 else rng.bytes(int(rng.integers(0, 300)))
            rows.append((o, ts0 + o * 997 + p, key, value))
        out[p] = rows
    return out


def assert_slots_do_not_collide(recs, bits: int = BITS) -> None:
    """No alive-bitmap slot is shared by keys of two partitions."""
    owner: "dict[int, int]" = {}
    for p, rows in recs.items():
        keys = sorted({k for _, _, k, _ in rows if k is not None})
        lengths = np.array([len(k) for k in keys])
        padded = np.zeros((len(keys), lengths.max()), dtype=np.uint8)
        for i, k in enumerate(keys):
            padded[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
        for slot in (fnv1a32_ref_batch(padded, lengths) & ((1 << bits) - 1)).tolist():
            assert owner.setdefault(slot, p) == p, "pick another seed"


def columns(source, batch_size: int = 128) -> "dict[int, dict[str, np.ndarray]]":
    """Every partition's records from ``source.batches``, in offset order."""
    batches = list(source.batches(batch_size))
    full = {k: np.concatenate([b.as_dict()[k] for b in batches])
            for k in batches[0].as_dict()}
    full["offsets"] = np.concatenate([b.offsets for b in batches])
    out = {}
    for p in np.unique(full["partition"]).tolist():
        sel = full["partition"] == p
        order = np.argsort(full["offsets"][sel], kind="stable")
        out[p] = {k: v[sel][order] for k, v in full.items()}
    return out


RECS = topic_records(5)
assert_slots_do_not_collide(RECS)
BROKERS = {
    "plain": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=97),
    "modern": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=97, modern=True),
    "cluster3": lambda: FakeCluster(TOPIC, RECS, n_nodes=3, max_records_per_fetch=60),
    "partition-max-bytes": lambda: FakeBroker(
        TOPIC, RECS, max_records_per_fetch=40, honor_partition_max_bytes=True),
    "max-bytes": lambda: FakeBroker(
        TOPIC, RECS, max_records_per_fetch=40, honor_partition_max_bytes=True,
        honor_max_bytes=True),
    "gzip": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=80,
                               compression=ref_kc.COMPRESSION_GZIP),
    "snappy": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=80,
                                 compression=ref_kc.COMPRESSION_SNAPPY),
    "lz4": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=80,
                              compression=ref_kc.COMPRESSION_LZ4, modern=True),
    "zstd": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=80,
                               compression=ref_kc.COMPRESSION_ZSTD),
    "legacy-magic0": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=50,
                                        message_magic=0),
    "legacy-magic1-gzip": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=50,
                                             message_magic=1,
                                             compression=ref_kc.COMPRESSION_GZIP),
    "control": lambda: FakeBroker(TOPIC, RECS, max_records_per_fetch=50,
                                  control_offsets={0: {0, 77, 399}, 2: {150}}),
}
OVERRIDES = {
    "partition-max-bytes": {"max.partition.fetch.bytes": "3000"},
    "max-bytes": {"fetch.max.bytes": "6000", "max.partition.fetch.bytes": "4000"},
}


def bootstrap(broker) -> str:
    return getattr(broker, "bootstrap", None) or f"127.0.0.1:{broker.port}"


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", list(BROKERS))
def test_wire_source_columns_equal_the_references(name, use_native):
    overrides = dict(FAST, **OVERRIDES.get(name, {}))
    with BROKERS[name]() as broker:
        port = KafkaWireSource(bootstrap(broker), TOPIC, overrides=dict(overrides),
                               use_native_hashing=use_native)
        ref = RefSource(bootstrap(broker), TOPIC, overrides=dict(overrides),
                        use_native_hashing=use_native)
        try:
            assert port.partitions() == ref.partitions() == [0, 1, 2]
            assert port.watermarks() == ref.watermarks()
            got, want = columns(port), columns(ref)
        finally:
            port.close()
            ref.close()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for p in got:
        assert sorted(got[p]) == sorted(want[p])
        for k in want[p]:
            np.testing.assert_array_equal(got[p][k], want[p][k], f"{name} p{p} {k}")
    skipped = {0: 3, 2: 1} if name == "control" else {}
    assert {p: len(c["offsets"]) for p, c in got.items()} == \
        {p: 400 - skipped.get(p, 0) for p in range(3)}


FORMATS = {"v5": {}, "v4": dict(wire_format=4, use_pallas_counters=True),
           "compaction-off": dict(alive_compaction="off")}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("name,reason", [("plain", None), ("control", None),
                                         ("lz4", "compressed"),
                                         ("legacy-magic1-gzip", "legacy")])
def test_fused_record_set_rows_equal_chained_pack_batch(name, reason, fmt):
    if not native.native_available():
        pytest.skip("the native shim did not build")
    b = 1024
    config = AnalyzerConfig(num_partitions=3, batch_size=b, count_alive_keys=True,
                            alive_bitmap_bits=BITS, distinct_keys_per_partition=True,
                            hll_p=12, quantiles_per_partition=True, **FORMATS[fmt])
    with BROKERS[name]() as broker:
        src = KafkaWireSource(bootstrap(broker), TOPIC, overrides=dict(FAST))
        sink = packing.FusedPackSink(config, b, dense_of=lambda p: p)
        rows = list(src.batches(b, sink=sink))
        chained = list(src.batches(b))
        src.close()
    full = RecordBatch.concat(chained)
    cuts = [full.slice(lo, min(lo + b, len(full))) for lo in range(0, len(full), b)]
    assert [r.n_valid for r in rows] == [len(c) for c in cuts]
    for k, (row, batch) in enumerate(zip(rows, cuts)):
        assert row.buf.tobytes() == \
            packing.pack_batch(batch, config, use_native=True).tobytes(), f"row {k}"
        if config.compact_alive:
            for got, exp in zip(row.pairs, native.dedupe_slots_native(
                    batch.key_hash32, ~batch.key_null, ~batch.value_null, BITS)):
                np.testing.assert_array_equal(got, exp)
    assert sink.fallbacks == ({reason: len(full)} if reason else {})


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


SKETCHES = ["-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
            "--pallas", "--batch-size", "1024", "--alive-bitmap-bits", str(BITS)]
CLI_FORMATS = {"v5": [], "v4": ["--wire-format", "v4"],
               "compaction-off": ["--alive-compaction", "off"]}
#: Just after the record at offset 150 of partition 0 (partition p's
#: record at offset o has time ``ts0 + o * 997 + p``).
FROM_TS = str(1_700_000_000_000 + 150 * 997 + 1)


@pytest.fixture(scope="module")
def broker():
    recs = topic_records(11, parts=4, n=1500, keys=300)
    assert_slots_do_not_collide(recs)
    with FakeBroker(TOPIC, recs, max_records_per_fetch=200) as b:
        yield b


@pytest.fixture(scope="module")
def reference_reports(broker):
    """The reference CLI's report of each format (and from a timestamp)."""
    import contextlib
    import io

    out = {}
    base = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *SKETCHES,
            "--backend", "tpu", "--native", "off", "--quiet"]
    for fmt, flags in {**CLI_FORMATS, "from-ts": ["--from-timestamp", FROM_TS]}.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert ref_cli.main(base + flags) == 0
        out[fmt] = drop_timing(buf.getvalue())
    return out


@pytest.mark.parametrize("native_flag", ["on", "off"])
@pytest.mark.parametrize("fmt", list(CLI_FORMATS) + ["from-ts"])
def test_cli_report_equals_the_reference_clis(broker, reference_reports, fmt,
                                              native_flag, capsys):
    flags = CLI_FORMATS.get(fmt, ["--from-timestamp", FROM_TS])
    argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *SKETCHES, *flags,
            "--native", native_flag, "--backend", "cpu"]
    rc, result = cli.run(cli.build_parser().parse_args(argv))
    assert rc == 0
    assert drop_timing(capsys.readouterr().out) == reference_reports[fmt]
    assert result.fused == (native_flag == "on")
    assert result.fallbacks == {}
    # From the timestamp: offsets 151 on of partition 0, 150 on of the others.
    want = 4 * 1500 - (151 + 3 * 150 if fmt == "from-ts" else 0)
    assert result.records == want


def test_source_defaults_to_kafka_and_refuses_without_a_bootstrap(capsys):
    args = cli.build_parser().parse_args(["-t", TOPIC])
    assert args.source == "kafka"
    assert ref_cli.build_parser().parse_args(["-t", TOPIC]).source == "kafka"
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit, match="--source kafka requires -b/--bootstrap-server"):
            main(["-t", TOPIC, "--backend", "cpu"])
    assert cli.main(["-t", TOPIC, "--source", "synthetic", "--from-timestamp", "5",
                     "--backend", "cpu"]) == 1
    assert "--from-timestamp requires --source kafka" in capsys.readouterr().err
    assert cli.parse_timestamp_ms("2020-09-13T12:26:40") == 1_600_000_000_000
    assert ref_cli.parse_timestamp_ms("2020-09-13T12:26:40") == 1_600_000_000_000


def test_from_timestamp_past_the_end_and_empty_topic_exit_as_the_reference(capsys):
    recs = {0: [(o, 1_600_000_000_000 + o, b"k", b"v") for o in range(50)], 1: []}
    with FakeBroker(TOPIC, recs) as b:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", "--from-timestamp",
                "2100-01-01T00:00:00"]
        assert ref_cli.main(argv + ["--backend", "cpu", "--quiet"]) == 0
        ref_err = capsys.readouterr().err
        assert cli.main(argv + ["--backend", "cpu"]) == 0
        assert capsys.readouterr().err == ref_err
        assert "No records at or after 2100-01-01T00:00:00" in ref_err
    with FakeBroker(TOPIC, {0: [], 1: []}) as b:
        assert cli.main(["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", "--backend", "cpu"]) == 254
        assert "no content" in capsys.readouterr().err


def test_dump_segments_of_a_kafka_scan_rescan_to_the_same_report(broker, tmp_path, capsys):
    argv = ["-t", TOPIC, *SKETCHES, "--backend", "cpu"]
    dump = tmp_path / "dump"
    assert cli.main(argv + ["-b", f"127.0.0.1:{broker.port}",
                            "--dump-segments", str(dump)]) == 0
    kafka = drop_timing(capsys.readouterr().out)
    assert sorted(p.name for p in dump.iterdir()) == \
        [f"{TOPIC}-{p}.c0.ktaseg" for p in range(4)]
    for native_flag in ("on", "off"):
        assert cli.main(argv + ["--source", "segfile", "--segment-dir", str(dump),
                                "--native", native_flag]) == 0
        assert drop_timing(capsys.readouterr().out) == kafka
    # The reference reads the port's dump and prints the same report.
    assert ref_cli.main(argv[:-1] + ["tpu", "--source", "segfile", "--segment-dir",
                                     str(dump), "--quiet"]) == 0
    assert drop_timing(capsys.readouterr().out) == kafka
    # A second dump into the same directory is refused, as by the reference.
    assert cli.main(argv + ["-b", f"127.0.0.1:{broker.port}",
                            "--dump-segments", str(dump)]) == 1
    assert "already contains 4 segment file(s)" in capsys.readouterr().err


@pytest.mark.cuda
def test_cuda_kafka_scan_equals_cpu_scan(broker, capsys):
    """On a card: the fused and chained Kafka scans on cuda print the cpu
    scan's report and launch their format's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kafka_topic_analyzer_tpu_torch.ops import counters_merge, counters_update

    base = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *SKETCHES]
    for flags, kernel in (([], counters_merge.counters_merge),
                          (["--wire-format", "v4"], counters_update.counters_update)):
        assert cli.main(base + flags + ["--backend", "cpu"]) == 0
        want = drop_timing(capsys.readouterr().out)
        for native_flag in ("on", "off"):
            kernel.launches = 0
            assert cli.main(base + flags + ["--native", native_flag,
                                            "--backend", "gpu"]) == 0
            assert drop_timing(capsys.readouterr().out) == want
            assert kernel.launches > 0
