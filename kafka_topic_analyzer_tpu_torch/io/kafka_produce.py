"""Minimal Kafka producer (port of the reference's ``io/kafka_produce.py``):
just enough to seed a live broker for the integration tier.

The analyzer is consumer-only; end-to-end validation against a broker
this repository did not write needs a way to put known records into a
topic first.  That is this module's whole job: a test rig, not a product
surface — no batching, retries, idempotence or transactions.

Wire format: ApiVersions-negotiated CreateTopics (v0–v4 classic) and
Produce (v3–v7 classic; v3 is the Kafka 4.0 floor after KIP-896, and v7
the ceiling this parser consumes — v8 appended per-partition
``record_errors``/``error_message`` fields the response loop below does
not read, so negotiating it would desync the connection).  Record sets
are encoded by the same `kafka_codec.encode_record_batch` the fake broker
uses, so the bytes a live broker stores are the bytes the decode path is
tested against.

Used by ``tests/test_torch_live_broker.py`` (the live test runs only with
``KTA_KAFKA_BOOTSTRAP`` set).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import (
    BrokerConnection,
    parse_bootstrap,
)

API_PRODUCE = 0
API_CREATE_TOPICS = 19

ERR_TOPIC_ALREADY_EXISTS = 36

#: (ts_ms, key, value): offsets are assigned by the broker; the encoder is
#: fed offsets 0..n-1 so the batch header's base offset and deltas are what
#: a producer must send (base 0, delta = position in the batch).
ProduceRecord = Tuple[int, Optional[bytes], Optional[bytes]]


def _negotiated(conn: BrokerConnection, api_key: int, lo: int, hi: int) -> int:
    """Highest version in [lo, hi] the broker advertises for ``api_key``.

    One ApiVersions v0 round trip, cached on the connection.  v0 is
    supported everywhere (KIP-511 keeps its response header v0), and this
    module needs no flexible encoding, so the consumer client's downgrade
    steps are not repeated here."""
    if conn.api_versions is None:
        r = conn.request(kc.API_VERSIONS, 0, kc.encode_api_versions_request(0))
        conn.api_versions = kc.decode_api_versions_response(r, 0)
    vmin, vmax = conn.api_versions.get(api_key, (lo, lo))
    v = min(hi, vmax)
    if v < max(lo, vmin):
        raise kc.KafkaProtocolError(
            f"broker offers api {api_key} v{vmin}-{vmax}; "
            f"this producer speaks v{lo}-{hi}"
        )
    return v


def create_topic(bootstrap: str, topic: str, partitions: int,
                 replication: int = 1, timeout_ms: int = 30_000) -> None:
    """CreateTopics through the first bootstrap broker.

    TOPIC_ALREADY_EXISTS is tolerated (an idempotent test set-up); any
    other per-topic error raises.  Real clusters route CreateTopics to
    the controller; a single-node test broker is the controller, and a
    NOT_CONTROLLER error from a bigger cluster raises with the broker's
    own message rather than chasing the controller."""
    host, port = parse_bootstrap(bootstrap)[0]
    conn = BrokerConnection(host, port)
    try:
        v = _negotiated(conn, API_CREATE_TOPICS, 0, 4)
        w = kc.ByteWriter()
        w.i32(1).string(topic).i32(partitions).i16(replication)
        w.i32(0)  # assignments: broker-chosen
        w.i32(0)  # configs: broker defaults
        w.i32(timeout_ms)
        if v >= 1:
            w.i8(0)  # validate_only=false
        r = conn.request(API_CREATE_TOPICS, v, w.done())
        if v >= 2:
            r.i32()  # throttle_time_ms
        for _ in range(r.i32()):
            name = r.string()
            err = r.i16()
            msg = r.string() if v >= 1 else None
            if err not in (0, ERR_TOPIC_ALREADY_EXISTS):
                raise kc.KafkaProtocolError(
                    f"CreateTopics('{name}') failed: error {err}"
                    + (f" ({msg})" if msg else "")
                )
    finally:
        conn.close()


def encode_produce_request(topic: str, partition: int, record_set: bytes,
                           acks: int = -1,
                           timeout_ms: int = 30_000) -> "kc.ByteWriter":
    """Produce v3–v7 body (one schema across that range):
    transactional_id, acks, timeout, one topic, one partition."""
    w = kc.ByteWriter()
    w.string(None)           # transactional_id
    w.i16(acks)
    w.i32(timeout_ms)
    w.i32(1).string(topic)   # topic_data[1]
    w.i32(1).i32(partition)  # partition_data[1]
    w.bytes_(record_set)
    return w


def produce(bootstrap: str, topic: str,
            partition_records: Dict[int, List[ProduceRecord]],
            timeout_ms: int = 30_000) -> Dict[int, int]:
    """Produce each partition's records (one uncompressed batch per
    partition, acks=-1) and return partition → the broker's base offset.

    Leaders come from a negotiated Metadata round trip (v5 on current
    brokers, v1 on old ones), so multi-node clusters work; one connection
    serves every partition a broker leads."""
    host, port = parse_bootstrap(bootstrap)[0]
    boot = BrokerConnection(host, port)
    conns: "Dict[int, BrokerConnection]" = {}
    try:
        # Negotiated: v1 is gone from Kafka 4.0 brokers (KIP-896; v5 is
        # their classic floor), and no flexible v9+ encoding is needed.
        mv = _negotiated(boot, kc.API_METADATA, 1, 5)
        # A topic created moments ago may report LEADER_NOT_AVAILABLE or
        # leader -1 until the election propagates: retry for a bounded
        # time, then name the stuck partitions.
        deadline = time.monotonic() + 30.0
        while True:
            meta = kc.decode_metadata_response(
                boot.request(kc.API_METADATA, mv,
                             kc.encode_metadata_request([topic], mv)),
                mv,
            )
            (tmeta,) = [t for t in meta.topics if t.name == topic]
            if tmeta.error:
                raise kc.KafkaProtocolError(
                    f"Metadata('{topic}') error {tmeta.error}"
                )
            leaderless = [
                p.partition for p in tmeta.partitions
                if p.error or p.leader < 0 or p.leader not in meta.brokers
            ]
            if not leaderless:
                break
            if time.monotonic() >= deadline:
                raise kc.KafkaProtocolError(
                    f"topic '{topic}' partitions {sorted(leaderless)} "
                    "still leaderless after 30s"
                )
            time.sleep(0.5)
        leaders = {p.partition: p.leader for p in tmeta.partitions}
        base_offsets: "Dict[int, int]" = {}
        for pid, recs in sorted(partition_records.items()):
            if pid not in leaders:
                raise kc.KafkaProtocolError(
                    f"partition {pid} not in topic '{topic}' metadata"
                )
            node = leaders[pid]
            if node not in conns:
                nh, np_ = meta.brokers[node]
                conns[node] = BrokerConnection(nh, np_)
            conn = conns[node]
            # Ceiling v7: the loop below parses exactly the v3–v7
            # partition_response schema (see the module docstring).
            v = _negotiated(conn, API_PRODUCE, 3, 7)
            record_set = kc.encode_record_batch(
                [(i, ts, k, val) for i, (ts, k, val) in enumerate(recs)]
            )
            r = conn.request(
                API_PRODUCE, v,
                encode_produce_request(topic, pid, record_set,
                                       timeout_ms=timeout_ms).done(),
            )
            # Each request carries one topic with one partition
            # (encode_produce_request), so ``rp == pid`` names the
            # partition just produced.
            for _ in range(r.i32()):       # responses[]
                r.string()                 # topic
                for _ in range(r.i32()):   # partition_responses[]
                    rp = r.i32()
                    err = r.i16()
                    base = r.i64()
                    r.i64()                # log_append_time
                    if v >= 5:
                        r.i64()            # log_start_offset
                    if err:
                        raise kc.KafkaProtocolError(
                            f"Produce({topic}/{rp}) failed: error {err}"
                        )
                    if rp == pid:
                        base_offsets[pid] = base
        return base_offsets
    finally:
        boot.close()
        for c in conns.values():
            c.close()
