"""The port's producer (``io/kafka_produce.py``) against the reference's,
and the live-broker tier run through the port.

The produce record set must decode, through the port's own decoder, back
to the records that went in; the Produce request body must be the
reference's bytes; version negotiation runs against the loopback fake
broker.  The live test needs a reachable broker and runs only with
``KTA_KAFKA_BOOTSTRAP=host:port`` set:

    KTA_KAFKA_BOOTSTRAP=127.0.0.1:9092 pytest tests/test_torch_live_broker.py
"""

import os
import uuid

import numpy as np
import pytest

from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.io import kafka_produce as ref_produce
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
from kafka_topic_analyzer_tpu_torch.io.kafka_produce import (
    API_PRODUCE,
    _negotiated,
    create_topic,
    encode_produce_request,
    produce,
)
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import (
    BrokerConnection,
    KafkaWireSource,
    records_to_batch,
)

BOOT = os.environ.get("KTA_KAFKA_BOOTSTRAP")


def records(partitions: int = 3, n: int = 400, seed: int = 7):
    """Per-partition (ts_ms, key, value) rows from a seed: null keys,
    tombstones, repeated keys and varying sizes."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in range(partitions):
        rows = []
        for i in range(n):
            key = f"k{p}-{int(rng.integers(29))}".encode() if rng.random() > 0.2 else None
            value = (None if key is not None and rng.random() < 0.1
                     else bytes(int(rng.integers(0, 210))))
            rows.append((1_700_000_000_000 + 1_000 * i + p, key, value))
        out[p] = rows
    return out


def test_produce_record_set_roundtrips_through_the_ports_decoder():
    rows = records(partitions=1, n=120)[0]
    record_set = kc.encode_record_batch(
        [(i, ts, k, v) for i, (ts, k, v) in enumerate(rows)]
    )
    decoded = list(kc.decode_record_batches(record_set, verify_crc=True))
    assert [off for off, _ in decoded] == list(range(len(rows)))
    assert [r for _, r in decoded] == rows


@pytest.mark.parametrize("acks,timeout_ms", [(-1, 30_000), (1, 5_000), (0, 1)])
def test_produce_request_bytes_equal_the_reference(acks, timeout_ms):
    """The Produce body the port sends is the reference's, byte for byte,
    around the same record set; it also parses back field for field."""
    rows = [(i, ts, k, v) for i, (ts, k, v) in enumerate(records(1, 50)[0])]
    record_set = kc.encode_record_batch(rows)
    assert record_set == ref_kc.encode_record_batch(rows)
    body = encode_produce_request("t.opic", 7, record_set, acks=acks,
                                  timeout_ms=timeout_ms).done()
    assert body == ref_produce.encode_produce_request(
        "t.opic", 7, record_set, acks=acks, timeout_ms=timeout_ms).done()
    r = kc.ByteReader(body)
    assert r.string() is None
    assert (r.i16(), r.i32(), r.i32(), r.string()) == (acks, timeout_ms, 1, "t.opic")
    assert (r.i32(), r.i32(), r.bytes_()) == (1, 7, record_set)
    assert r.remaining() == 0


def test_version_negotiation_against_the_fake_broker():
    """`_negotiated` clamps into the advertised range through a real
    ApiVersions round trip, caches it on the connection, and refuses a
    broker whose floor is above what the producer speaks (the reference's
    message)."""
    from fake_broker import FakeBroker

    with FakeBroker("t", {0: []},
                    api_ranges={kc.API_VERSIONS: (0, 3), API_PRODUCE: (3, 9)}) as b:
        conn = BrokerConnection("127.0.0.1", b.port)
        try:
            assert _negotiated(conn, API_PRODUCE, 3, 8) == 8
            assert _negotiated(conn, API_PRODUCE, 3, 7) == 7
            conn.request = None  # cached: a second handshake would raise
            assert _negotiated(conn, API_PRODUCE, 3, 8) == 8
        finally:
            conn.close()
    with FakeBroker("t", {0: []},
                    api_ranges={kc.API_VERSIONS: (0, 3), API_PRODUCE: (9, 12)}) as b:
        conn = BrokerConnection("127.0.0.1", b.port)
        try:
            with pytest.raises(kc.KafkaProtocolError, match=r"v9-12.*speaks v3-8"):
                _negotiated(conn, API_PRODUCE, 3, 8)
        finally:
            conn.close()


@pytest.mark.skipif(not BOOT, reason="set KTA_KAFKA_BOOTSTRAP=host:port to run "
                                     "against a live broker")
def test_live_broker_end_to_end():
    """A fresh topic on the live broker: produce known records, scan them
    through the port's wire client, and hold every exact metric to the
    oracle fed the same records locally (CreateTime timestamps assumed)."""
    topic = f"kta-live-{uuid.uuid4().hex[:12]}"
    partitions = 3
    recs = records(partitions)
    create_topic(BOOT, topic, partitions)
    base = produce(BOOT, topic, recs)
    assert all(b == 0 for b in base.values()), base
    cfg = AnalyzerConfig(num_partitions=partitions, batch_size=256,
                         count_alive_keys=True, alive_bitmap_bits=20)
    src = KafkaWireSource(BOOT, topic)
    try:
        got = run_scan(topic, src, CpuExactBackend(cfg, init_now_s=0), 256).metrics
    finally:
        src.close()
    oracle = CpuExactBackend(cfg, init_now_s=0)
    rows = [(p, ts, k, v) for p in range(partitions) for (ts, k, v) in recs[p]]
    for lo in range(0, len(rows), 256):
        oracle.update(records_to_batch(rows[lo:lo + 256]))
    want = oracle.finalize()
    assert np.array_equal(got.per_partition, want.per_partition)
    assert np.array_equal(got.per_partition_extremes, want.per_partition_extremes)
    assert (got.overall_count, got.overall_size, got.alive_keys) == \
        (want.overall_count, want.overall_size, want.alive_keys)
    assert (got.earliest_ts_s, got.latest_ts_s) == (want.earliest_ts_s, want.latest_ts_s)
