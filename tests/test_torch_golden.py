"""The golden-bytes tier held against the port.

Every input here comes from ``tests/test_golden.py``: its primitive
writers, CRC32-C and xxHash32 written from their definitions, its
store-mode compressors and its record batch, response bodies and canned
``GoldenBroker``, all laid out byte by byte from the Kafka protocol spec
(KIP-98 record batch, Metadata v1/v12, ListOffsets v1/v7, Fetch v4/v12,
ApiVersions v0/v3).  None of it is built by either package's encoder.
Each of that file's 19 cases has its twin below, against the port's
``io/kafka_codec``, ``io/compression`` and ``io/native`` and, end to end,
the port's ``cli.main``.

End to end, the port's report under each codec must carry the cells the
reference's ``_assert_golden_report`` derives by hand from the reference
tool's metric semantics, and be the reference CLI's stdout byte for byte
but for the ``Scanning took:`` line (and the ``Estimated Msg/s:`` line
derived from it, checked against it in each run): the torch backend on the host
(``--device cpu``) against the reference's device backend (``--backend
tpu`` on JAX's CPU), and the numpy oracle (``--backend cpu``) against the
reference's oracle.

The ``--json`` documents of the same pairs are compared on the report
fields ``overall``, ``partitions``, ``alive_keys``,
``extremes_per_partition``, ``topic``, ``ingest_workers``,
``superbatch_k`` and ``dispatch_depth``, and on the key set.  Left out,
with the reason:

- ``duration_secs``: the scan's wall clock;
- ``flight``: shares and seconds of the host's stage timers;
- ``telemetry``: the process-wide registries, which book timers, and
  whose wire-byte and fused-row counters follow the ingest path the
  backend takes (the reference's device backend on JAX's CPU decodes
  through the chained path, the port's through the fused one);
- ``ingest_workers_per_controller``, ``follow``, ``windows``, ``health``
  and the other blocks a golden scan does not produce are absent from
  both documents (the key-set check holds that).

``dispatch_depth`` is the backend's, not the package's: 2 for the device
backends (``--dispatch-depth``'s default) and 1 for the oracles, in both
packages.  A reference run at its default backend (the oracle) beside a
port run at its default (the device backend) reads 1 against 2; that is
the intended divergence of the default backend, not of the depth.
"""

import json
import re

import pytest
import torch

import test_golden as golden
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.io import compression as comp
from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

CODECS = [kc.COMPRESSION_NONE, kc.COMPRESSION_GZIP, kc.COMPRESSION_SNAPPY,
          kc.COMPRESSION_LZ4, kc.COMPRESSION_ZSTD]
COMPRESSED = CODECS[1:]
CODEC_IDS = ["none", "gzip", "snappy", "lz4", "zstd"]
#: (port flags, reference flags) that select the same backend.
BACKENDS = {
    "torch-cpu": (["--device", "cpu"], ["--backend", "tpu"]),
    "oracle": (["--backend", "cpu"], ["--backend", "cpu"]),
}
REPORT_FIELDS = ("overall", "partitions", "alive_keys", "extremes_per_partition",
                 "topic", "ingest_workers", "superbatch_k", "dispatch_depth")


@pytest.fixture(autouse=True)
def _reset_registries():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def expect_records(frames) -> None:
    got = [(off, ts, k, v) for frame in frames
           for off, (ts, k, v) in kc.decode_frame_records(frame)]
    assert got == golden.GOLDEN_RECORDS


# -- primitives ---------------------------------------------------------------


def test_crc32c_known_vectors_and_codec_parity():
    assert golden.crc32c(b"123456789") == 0xE3069283
    assert golden.crc32c(b"") == 0
    assert golden.crc32c(b"\x00" * 32) == 0x8A9136AA
    for payload in (b"", b"a", b"hello kafka", bytes(range(256)) * 3):
        want = golden.crc32c(payload)
        assert kc._crc32c(payload) == want
        assert kc._crc32c_py(payload) == want
        assert native.crc32c_native(payload) == want


def test_xxh32_known_vectors_frame_the_ports_lz4_decoders():
    """The spec's xxHash32 vectors, then an LZ4 frame whose header
    checksum they make, through both of the port's LZ4 decoders."""
    assert golden.xxh32(b"") == 0x02CC5D05
    assert golden.xxh32(b"Hello World") == 0xB1FD16EE
    section = golden.golden_records_section()
    frame = golden.lz4_frame(section)
    assert frame[6] == (golden.xxh32(bytes([0x60, 0x40])) >> 8) & 0xFF
    assert comp.lz4_decompress(frame) == section
    assert comp.lz4_decompress_py(frame) == section


# -- decoder-level golden bodies ------------------------------------------------


def test_golden_record_batch_plain_python_decode():
    expect_records(kc.iter_batch_frames(golden.golden_batch(), verify_crc=True))


def test_golden_record_batch_native_decode():
    assert native.native_available(), native.native_status()
    buf = golden.golden_batch()
    assert native.scan_record_set_native(buf, verify_crc=True) == (3, len(buf), 3)
    soa, used, covered = native.decode_record_set_native(buf, verify_crc=True)
    assert used == len(buf) and covered == 3
    assert list(soa["offsets"]) == [0, 1, 2]
    t0 = golden.T0_MS
    assert list(soa["ts_ms"]) == [t0, t0 + 1, t0 + 2]
    assert list(soa["key_len"]) == [5, 4, 0]
    assert list(soa["value_len"]) == [6, 0, 9]
    assert list(soa["key_null"]) == [0, 0, 1]
    assert list(soa["value_null"]) == [0, 1, 0]


@pytest.mark.parametrize("codec", COMPRESSED, ids=CODEC_IDS[1:])
def test_golden_record_batch_compressed(codec):
    expect_records(kc.iter_batch_frames(golden.golden_batch(codec), verify_crc=True))
    assert [off for off, _ in kc.decode_record_batches(
        golden.golden_batch(codec), verify_crc=True)] == [0, 1, 2]


def test_golden_snappy_xerial_framing():
    section = golden.golden_records_section()
    for framed in (golden.snappy_xerial(section), golden.snappy_raw(section)):
        assert comp.snappy_decompress(framed) == section
        assert comp.snappy_decompress_py(framed) == section
        assert comp.decompress(kc.COMPRESSION_SNAPPY, framed) == section


def test_golden_metadata_bodies_decode():
    for version, body in ((1, golden.metadata_v1_body(9092)),
                          (12, golden.metadata_v12_body(9092))):
        md = kc.decode_metadata_response(kc.ByteReader(body), version)
        assert md.brokers == {1: ("127.0.0.1", 9092)}
        assert md.controller_id == 1
        assert len(md.topics) == 1
        t = md.topics[0]
        assert (t.error, t.name) == (0, golden.GOLDEN_TOPIC)
        assert [(p.error, p.partition, p.leader) for p in t.partitions] == [(0, 0, 1)]


def test_golden_list_offsets_bodies_decode():
    assert kc.decode_list_offsets_response(
        kc.ByteReader(golden.list_offsets_v1_body(3)), 1) == {0: (0, 3, -1)}
    assert kc.decode_list_offsets_response(
        kc.ByteReader(golden.list_offsets_v7_body(3)), 7) == {0: (0, 3, 0)}


def test_golden_fetch_bodies_decode():
    records = golden.golden_batch()
    for version, body in ((4, golden.fetch_v4_body(records)),
                          (12, golden.fetch_v12_body(records))):
        fps = kc.decode_fetch_response(kc.ByteReader(body), version)
        assert len(fps) == 1
        fp = fps[0]
        assert (fp.partition, fp.error, fp.high_watermark) == (0, 0, 3)
        assert bytes(fp.records) == records
        expect_records(kc.iter_batch_frames(bytes(fp.records), verify_crc=True))


def test_golden_api_versions_bodies_decode():
    ranges = kc.decode_api_versions_response(
        kc.ByteReader(golden.api_versions_v0_body()), 0)
    assert ranges[kc.API_FETCH] == (0, 4)
    assert ranges[kc.API_METADATA] == (0, 1)
    assert kc.decode_api_versions_response(
        kc.ByteReader(golden.api_versions_v3_body()), 3) == ranges
    with pytest.raises(kc.UnsupportedVersionError):
        kc.decode_api_versions_response(
            kc.ByteReader(golden.api_versions_v0_body(error=35)), 3)


# -- the golden broker, end to end ------------------------------------------------


def drop_scan_time(text: str) -> str:
    """``text`` without the ``Scanning took:`` line, and without the
    ``Estimated Msg/s:`` line once it is checked to be the golden record
    count over that line's seconds (at least 1), as the reference
    computes it: both follow the run's wall clock."""
    secs = int(re.search(r"^Scanning took: (\d+) seconds$", text, re.M).group(1))
    rate = len(golden.GOLDEN_RECORDS) // max(secs, 1)
    assert f"\nEstimated Msg/s: {rate}\n" in text
    return "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith(("Scanning took:", "Estimated Msg/s:")))


def scan(main, codec: int, flags, capsys) -> str:
    with golden.GoldenBroker(codec) as broker:
        rc = main(["-t", golden.GOLDEN_TOPIC, "-b", f"127.0.0.1:{broker.port}",
                   "--librdkafka", "check.crcs=true", "-c",
                   "--alive-bitmap-bits", "20", "--quiet", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def port_and_reference(codec: int, backend: str, extra, capsys) -> "tuple[str, str]":
    port_flags, ref_flags = BACKENDS[backend]
    port = scan(cli.main, codec, [*port_flags, *extra], capsys)
    default_registry().reset()
    ref_registry().reset()
    ref = scan(ref_cli.main, codec, [*ref_flags, *extra], capsys)
    return port, ref


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_golden_broker_end_to_end(backend, capsys):
    """Twin of the reference's uncompressed ``--backend cpu`` and
    ``--backend tpu`` cases."""
    port, ref = port_and_reference(kc.COMPRESSION_NONE, backend, [], capsys)
    golden._assert_golden_report(port)
    assert drop_scan_time(port) == drop_scan_time(ref)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("codec", COMPRESSED, ids=CODEC_IDS[1:])
def test_golden_broker_compressed_end_to_end(codec, backend, capsys):
    port, ref = port_and_reference(codec, backend, [], capsys)
    golden._assert_golden_report(port)
    assert drop_scan_time(port) == drop_scan_time(ref)


@pytest.mark.parametrize("extra", [["--wire-format", "v4"], ["--alive-compaction", "off"]],
                         ids=["v4", "compaction-off"])
def test_golden_broker_wire_variants(extra, capsys):
    """The torch backend's other fold (v4) and the uncompacted alive path,
    under gzip."""
    port, ref = port_and_reference(kc.COMPRESSION_GZIP, "torch-cpu", extra, capsys)
    golden._assert_golden_report(port)
    assert drop_scan_time(port) == drop_scan_time(ref)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_golden_broker_json_document(codec, backend, capsys):
    port, ref = (json.loads(doc) for doc in
                 port_and_reference(codec, backend, ["--json"], capsys))
    assert port.keys() == ref.keys()
    for field in REPORT_FIELDS:
        assert port[field] == ref[field], field
    assert port["dispatch_depth"] == (2 if backend == "torch-cpu" else 1)
    assert port["overall"]["count"] == 3


@pytest.mark.cuda
def test_cuda_golden_broker_end_to_end(capsys):
    """On a card: the CLI at its default device prints the host run's
    report under each codec, v5 and v4, and folds the one row through its
    wire format's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kafka_topic_analyzer_tpu_torch.ops import counters_merge, counters_update

    for codec, extra, kernel in (
            (codec, extra, kernel) for codec in CODECS
            for extra, kernel in (([], counters_merge.counters_merge),
                                  (["--wire-format", "v4"], counters_update.counters_update))):
        want = scan(cli.main, codec, ["--device", "cpu", *extra], capsys)
        kernel.launches = 0
        got = scan(cli.main, codec, extra, capsys)
        golden._assert_golden_report(got)
        assert drop_scan_time(got) == drop_scan_time(want)
        assert kernel.launches == 1
