"""Kafka wire-protocol codec: primitives + the three RPCs the analyzer needs
(port of the reference's ``io/kafka_codec.py``: the whole codec, encode
and decode sides; the CRC32-C and the compression codecs reach the port's
own native shim).

The reference delegates the entire Kafka protocol to librdkafka (C)
(src/kafka.rs:6-11, Cargo.toml:19).  This build speaks the protocol directly:
the analyzer only ever *reads* — Metadata (api 3), ListOffsets (api 2), Fetch
(api 1), plus ApiVersions (api 18) for the handshake — so a compact codec
covers the whole surface.  Both the client (`kafka_wire.py`) and the test
fake broker use these encoders/decoders, mirroring SURVEY.md §4's
backend-contract strategy.

Implemented versions — each API in both the classic and the KIP-482
flexible (compact/tagged-field) encodings, negotiated per broker via
ApiVersions (`_FLEXIBLE_FROM` below; version choice in kafka_wire.py's
`_CANDIDATES`):
- Metadata v1–v5 classic / v12 flexible (v5 is the Kafka 4.0 floor after
  KIP-896), ListOffsets v1 classic / v7 flexible, Fetch v4 classic /
  v12 flexible (sessionless: session_id 0, epoch -1), ApiVersions
  v0 classic / v3 flexible-request (response header stays v0 per KIP-511)
- SaslHandshake v1 + SaslAuthenticate v0 for PLAIN/SCRAM (`kafka_wire.py`)
- RecordBatch v2 ("magic 2", Kafka >= 0.11) with zigzag-varint records;
  all four codecs decode via io/compression.py: gzip (zlib), snappy
  (xerial framing), LZ4 frames, and zstd (from-scratch RFC 8878 decoder,
  io/zstd_py.py).  v0/v1 MessageSets are rejected with a clear error.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_SASL_HANDSHAKE = 17
API_VERSIONS = 18
API_OFFSET_FOR_LEADER_EPOCH = 23
API_SASL_AUTHENTICATE = 36

ERR_SASL_AUTHENTICATION_FAILED = 58

EARLIEST_TIMESTAMP = -2
LATEST_TIMESTAMP = -1

#: Kafka error codes the client interprets.
ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_NOT_LEADER_FOR_PARTITION = 6
#: KIP-320 fencing errors: the request's current_leader_epoch is older
#: (74) or newer (75) than the leader's — the client must refresh
#: metadata, and a *regression* means the log may have been truncated.
ERR_FENCED_LEADER_EPOCH = 74
ERR_UNKNOWN_LEADER_EPOCH = 75


class KafkaProtocolError(RuntimeError):
    pass


class CorruptFrameError(KafkaProtocolError):
    """Bytes that are wrong, as opposed to a transport fault.  Corruption
    at rest is deterministic, so retrying does not help.

    ``kind`` classifies the damage; the context fields say where it is:

    - ``partition``: the partition the bytes claim or belong to
    - ``base_offset``: the frame's claimed base offset (-1 unknown)
    - ``span``: (start, end) byte range of the damage, when known
    - ``claimed_end``: one past the last offset the header claims (-1
      unknown)
    - ``num_records``: the header's record count (0 when unreadable)
    - ``crc_expected`` / ``crc_actual``: set for checksum mismatches
    """

    kind = "corrupt"

    def __init__(
        self,
        message: str,
        *,
        partition: "Optional[int]" = None,
        base_offset: int = -1,
        span: "Optional[Tuple[int, int]]" = None,
        claimed_end: int = -1,
        num_records: int = 0,
        crc_expected: "Optional[int]" = None,
        crc_actual: "Optional[int]" = None,
    ):
        super().__init__(message)
        self.partition = partition
        self.base_offset = base_offset
        self.span = span
        self.claimed_end = claimed_end
        self.num_records = num_records
        self.crc_expected = crc_expected
        self.crc_actual = crc_actual


class CrcMismatchError(CorruptFrameError):
    """Stored CRC32-C (v2) / CRC32 (legacy) disagrees with the bytes."""

    kind = "crc-mismatch"


class TruncatedFrameError(CorruptFrameError):
    """A frame or record body ends before its declared length (inside the
    buffer — a partial *trailing* batch is the broker's byte-limit
    truncation and is tolerated, not classified)."""

    kind = "truncated"


class MalformedHeaderError(CorruptFrameError):
    """Structurally impossible header fields: non-positive batch length,
    unknown magic, negative record count/length, bad nesting."""

    kind = "malformed-header"


class BadCompressionError(CorruptFrameError):
    """The frame's compressed payload does not decode (bad gzip/snappy/
    LZ4/zstd stream, or an unknown codec id)."""

    kind = "bad-compression"


class BadUtf8Error(CorruptFrameError):
    """A wire field declared as a string is not valid UTF-8."""

    kind = "bad-utf8"


#: The full classification surface — untrusted wire input must map onto
#: exactly these (tests/test_corruption.py fuzzes the contract).
CORRUPTION_KINDS = (
    "crc-mismatch", "truncated", "malformed-header", "bad-compression",
    "bad-utf8",
)


class UnsupportedVersionError(KafkaProtocolError):
    """Error 35: the broker rejected the request's api version — the
    caller may retry at a lower version (KIP-511 ApiVersions dance)."""


ERR_UNSUPPORTED_VERSION = 35


# ---------------------------------------------------------------------------
# primitives


class ByteWriter:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def raw(self, b: bytes) -> "ByteWriter":
        self._parts.append(b)
        return self

    def i8(self, v: int) -> "ByteWriter":
        return self.raw(struct.pack(">b", v))

    def i16(self, v: int) -> "ByteWriter":
        return self.raw(struct.pack(">h", v))

    def i32(self, v: int) -> "ByteWriter":
        return self.raw(struct.pack(">i", v))

    def i64(self, v: int) -> "ByteWriter":
        return self.raw(struct.pack(">q", v))

    def u32(self, v: int) -> "ByteWriter":
        return self.raw(struct.pack(">I", v))

    def string(self, s: Optional[str]) -> "ByteWriter":
        if s is None:
            return self.i16(-1)
        b = s.encode()
        return self.i16(len(b)).raw(b)

    def bytes_(self, b: Optional[bytes]) -> "ByteWriter":
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def varint(self, v: int) -> "ByteWriter":
        """Zigzag varint (signed)."""
        z = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
        z &= (1 << 64) - 1
        out = bytearray()
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        return self.raw(bytes(out))

    def varbytes(self, b: Optional[bytes]) -> "ByteWriter":
        if b is None:
            return self.varint(-1)
        return self.varint(len(b)).raw(b)

    # -- flexible-version (KIP-482) primitives ------------------------------

    def uvarint(self, v: int) -> "ByteWriter":
        """UNSIGNED varint — compact lengths and tag ids (flexible
        encodings use these, unlike record fields' zigzag varints)."""
        if v < 0:
            raise ValueError("uvarint requires v >= 0")
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        return self.raw(bytes(out))

    def compact_string(self, s: Optional[str]) -> "ByteWriter":
        """COMPACT_NULLABLE_STRING: uvarint(len + 1), 0 = null."""
        if s is None:
            return self.uvarint(0)
        b = s.encode()
        return self.uvarint(len(b) + 1).raw(b)

    def compact_bytes(self, b: Optional[bytes]) -> "ByteWriter":
        if b is None:
            return self.uvarint(0)
        return self.uvarint(len(b) + 1).raw(b)

    def compact_array_len(self, n: Optional[int]) -> "ByteWriter":
        """COMPACT_ARRAY header: uvarint(count + 1), 0 = null array."""
        return self.uvarint(0 if n is None else n + 1)

    def tags(self) -> "ByteWriter":
        """Empty tagged-field buffer (this client sends no tagged fields)."""
        return self.uvarint(0)

    def done(self) -> bytes:
        return b"".join(self._parts)


class ByteReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if n < 0 or self.pos < 0 or self.pos + n > len(self.buf):
            raise KafkaProtocolError(
                f"truncated message: need {n} bytes at {self.pos}, have {len(self.buf)}"
            )
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        try:
            # bytes() first: response buffers may be memoryviews (the
            # zero-copy receive path) and memoryview has no .decode.
            return bytes(self._take(n)).decode()
        except UnicodeDecodeError as e:
            # Untrusted wire input must not leak UnicodeDecodeError.
            raise BadUtf8Error(f"invalid UTF-8 string on the wire: {e}") from e

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def bytes_view(self) -> "Optional[memoryview]":
        """Like bytes_ but zero-copy: a memoryview over the buffer.  For
        bulk fields (fetch record sets run to tens of MB) where the caller
        only slices/unpacks.  (memoryview truthiness follows __len__, like
        bytes — an empty view is falsy.)"""
        n = self.i32()
        if n < 0:
            return None
        if n > len(self.buf) - self.pos:
            raise KafkaProtocolError(
                f"truncated message: need {n} bytes at {self.pos}, "
                f"have {len(self.buf)}"
            )
        v = memoryview(self.buf)[self.pos : self.pos + n]
        self.pos += n
        return v

    def varint(self) -> int:
        shift = 0
        z = 0
        while True:
            b = self._take(1)[0]
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise KafkaProtocolError("varint too long")
        return (z >> 1) ^ -(z & 1)  # un-zigzag

    def varbytes(self) -> Optional[bytes]:
        n = self.varint()
        if n < 0:
            return None
        return self._take(n)

    # -- flexible-version (KIP-482) primitives ------------------------------

    def uvarint(self) -> int:
        shift = 0
        v = 0
        while True:
            b = self._take(1)[0]
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise KafkaProtocolError("uvarint too long")

    def compact_string(self) -> Optional[str]:
        n = self.uvarint()
        if n == 0:
            return None
        try:
            return bytes(self._take(n - 1)).decode()
        except UnicodeDecodeError as e:
            raise BadUtf8Error(f"invalid UTF-8 string on the wire: {e}") from e

    def compact_bytes(self) -> Optional[bytes]:
        n = self.uvarint()
        if n == 0:
            return None
        return self._take(n - 1)

    def compact_bytes_view(self) -> "Optional[memoryview]":
        """Zero-copy compact bytes — the flexible twin of bytes_view, for
        fetch record sets."""
        n = self.uvarint()
        if n == 0:
            return None
        n -= 1
        if n > len(self.buf) - self.pos:
            raise KafkaProtocolError(
                f"truncated message: need {n} bytes at {self.pos}, "
                f"have {len(self.buf)}"
            )
        v = memoryview(self.buf)[self.pos : self.pos + n]
        self.pos += n
        return v

    def compact_array_len(self) -> int:
        """COMPACT_ARRAY count; null arrays read as empty."""
        n = self.uvarint()
        return 0 if n == 0 else n - 1

    def skip_tags(self) -> None:
        """Skip a tagged-field buffer (forward compatibility: unknown
        tagged fields are ignorable by contract)."""
        for _ in range(self.uvarint()):
            self.uvarint()  # tag id
            self._take(self.uvarint())

    def remaining(self) -> int:
        return len(self.buf) - self.pos


# ---------------------------------------------------------------------------
# request framing


#: First flexible (KIP-482 tagged/compact encoding) version per API this
#: client speaks.  Flexible requests use header v2 (a tag buffer after
#: client_id) and flexible responses header v1 (a tag buffer after the
#: correlation id) — EXCEPT ApiVersions responses, which stay header v0 at
#: every version so that brokers can answer clients whose flexible support
#: is still unknown.
_FLEXIBLE_FROM = {
    API_METADATA: 9,
    API_FETCH: 12,
    API_LIST_OFFSETS: 6,
    API_VERSIONS: 3,
    API_OFFSET_FOR_LEADER_EPOCH: 4,
}


def is_flexible(api_key: int, api_version: int) -> bool:
    v = _FLEXIBLE_FROM.get(api_key)
    return v is not None and api_version >= v


def encode_request(
    api_key: int, api_version: int, correlation_id: int, client_id: str, body: bytes
) -> bytes:
    """Length-prefixed request with header v1 — or v2 (trailing tag
    buffer) for flexible api versions (src client.id analog: the
    reference sets client.id=topic-analyzer, src/kafka.rs:36)."""
    w = ByteWriter()
    w.i16(api_key).i16(api_version).i32(correlation_id).string(client_id)
    if is_flexible(api_key, api_version):
        w.tags()
    payload = w.done() + body
    return struct.pack(">i", len(payload)) + payload


def decode_request_header(buf: bytes) -> Tuple[int, int, int, Optional[str], ByteReader]:
    r = ByteReader(buf)
    api_key = r.i16()
    api_version = r.i16()
    corr = r.i32()
    client_id = r.string()  # header v2 keeps the classic NULLABLE_STRING
    if is_flexible(api_key, api_version):
        r.skip_tags()
    return api_key, api_version, corr, client_id, r


# ---------------------------------------------------------------------------
# Metadata v1 / v5 (classic encoding; v5 is the floor on Kafka 4.0 brokers
# after KIP-896 removed pre-2.1 protocol versions) / v12 (flexible,
# KIP-482 compact encoding + KIP-516 topic ids)

#: All-zero UUID = "name lookup" in topic-id-aware requests (KIP-516).
_NULL_UUID = b"\x00" * 16


def encode_metadata_request(
    topics: Optional[List[str]], version: int = 1
) -> bytes:
    w = ByteWriter()
    if version >= 9:
        w.compact_array_len(None if topics is None else len(topics))
        for t in topics or []:
            if version >= 10:
                w.raw(_NULL_UUID)  # topic_id: lookup by name
            w.compact_string(t)
            w.tags()
        w.i8(0)  # allow_auto_topic_creation = false (read-only tool)
        if version <= 10:
            w.i8(0)  # include_cluster_authorized_operations
        w.i8(0)  # include_topic_authorized_operations
        w.tags()
        return w.done()
    if topics is None:
        w.i32(-1)
    else:
        w.i32(len(topics))
        for t in topics:
            w.string(t)
    if version >= 4:
        w.i8(0)  # allow_auto_topic_creation = false (read-only tool)
    return w.done()


def decode_metadata_request(
    r: ByteReader, version: int = 1
) -> Optional[List[str]]:
    """Topic names of a Metadata request (fake-broker side)."""
    if version >= 9:
        n = r.uvarint()
        if n == 0:
            topics = None
        else:
            topics = []
            for _ in range(n - 1):
                if version >= 10:
                    r._take(16)  # topic_id
                topics.append(r.compact_string() or "")
                r.skip_tags()
        r.i8()  # allow_auto_topic_creation
        if version <= 10:
            r.i8()
        r.i8()
        r.skip_tags()
        return topics
    n = r.i32()
    if n < 0:
        return None
    topics = [r.string() or "" for _ in range(n)]
    if version >= 4:
        r.i8()
    return topics


@dataclasses.dataclass
class PartitionMetadata:
    error: int
    partition: int
    leader: int


@dataclasses.dataclass
class TopicMetadata:
    error: int
    name: str
    partitions: List[PartitionMetadata]
    #: Broker-flagged internal topic (``__consumer_offsets`` and friends;
    #: Metadata v1+).  Fleet discovery (fleet/discovery.py) excludes these
    #: by default — auditing the cluster means the *user's* topics.
    is_internal: int = 0


@dataclasses.dataclass
class MetadataResponse:
    brokers: "dict[int, tuple[str, int]]"  # node_id -> (host, port)
    controller_id: int
    topics: List[TopicMetadata]


def encode_metadata_response(resp: MetadataResponse, version: int = 1) -> bytes:
    w = ByteWriter()
    if version >= 9:
        w.i32(0)  # throttle_time_ms
        w.compact_array_len(len(resp.brokers))
        for node_id, (host, port) in resp.brokers.items():
            w.i32(node_id).compact_string(host).i32(port)
            w.compact_string(None)  # rack
            w.tags()
        w.compact_string(None)  # cluster_id
        w.i32(resp.controller_id)
        w.compact_array_len(len(resp.topics))
        for t in resp.topics:
            w.i16(t.error).compact_string(t.name)
            if version >= 10:
                w.raw(_NULL_UUID)  # topic_id
            w.i8(t.is_internal)
            w.compact_array_len(len(t.partitions))
            for p in t.partitions:
                w.i16(p.error).i32(p.partition).i32(p.leader)
                w.i32(0)  # leader_epoch (v7+)
                w.compact_array_len(1).i32(p.leader)  # replicas
                w.compact_array_len(1).i32(p.leader)  # isr
                w.compact_array_len(0)  # offline_replicas
                w.tags()
            w.i32(-2147483648)  # topic_authorized_operations (v8+)
            w.tags()
        if 8 <= version <= 10:
            w.i32(-2147483648)  # cluster_authorized_operations
        w.tags()
        return w.done()
    if version >= 3:
        w.i32(0)  # throttle_time_ms
    w.i32(len(resp.brokers))
    for node_id, (host, port) in resp.brokers.items():
        w.i32(node_id).string(host).i32(port).string(None)  # rack
    if version >= 2:
        w.string(None)  # cluster_id
    w.i32(resp.controller_id)
    w.i32(len(resp.topics))
    for t in resp.topics:
        w.i16(t.error).string(t.name).i8(t.is_internal)
        w.i32(len(t.partitions))
        for p in t.partitions:
            w.i16(p.error).i32(p.partition).i32(p.leader)
            w.i32(1).i32(p.leader)  # replicas
            w.i32(1).i32(p.leader)  # isr
            if version >= 5:
                w.i32(0)  # offline_replicas: empty
    return w.done()


def decode_metadata_response(r: ByteReader, version: int = 1) -> MetadataResponse:
    if version >= 9:
        r.i32()  # throttle_time_ms
        brokers = {}
        for _ in range(r.compact_array_len()):
            node_id = r.i32()
            host = r.compact_string() or ""
            port = r.i32()
            r.compact_string()  # rack
            r.skip_tags()
            brokers[node_id] = (host, port)
        r.compact_string()  # cluster_id
        controller = r.i32()
        topics = []
        for _ in range(r.compact_array_len()):
            err = r.i16()
            name = r.compact_string() or ""
            if version >= 10:
                r._take(16)  # topic_id
            internal = r.i8()
            parts = []
            for _ in range(r.compact_array_len()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                r.i32()  # leader_epoch
                for _ in range(r.compact_array_len()):
                    r.i32()  # replicas
                for _ in range(r.compact_array_len()):
                    r.i32()  # isr
                for _ in range(r.compact_array_len()):
                    r.i32()  # offline_replicas
                r.skip_tags()
                parts.append(PartitionMetadata(perr, pid, leader))
            r.i32()  # topic_authorized_operations
            r.skip_tags()
            topics.append(TopicMetadata(err, name, parts, is_internal=internal))
        if 8 <= version <= 10:
            r.i32()  # cluster_authorized_operations
        r.skip_tags()
        return MetadataResponse(brokers, controller, topics)
    if version >= 3:
        r.i32()  # throttle_time_ms
    brokers = {}
    for _ in range(r.i32()):
        node_id = r.i32()
        host = r.string() or ""
        port = r.i32()
        r.string()  # rack
        brokers[node_id] = (host, port)
    if version >= 2:
        r.string()  # cluster_id
    controller = r.i32()
    topics = []
    for _ in range(r.i32()):
        err = r.i16()
        name = r.string() or ""
        internal = r.i8()
        parts = []
        for _ in range(r.i32()):
            perr = r.i16()
            pid = r.i32()
            leader = r.i32()
            for _ in range(r.i32()):
                r.i32()  # replicas
            for _ in range(r.i32()):
                r.i32()  # isr
            if version >= 5:
                for _ in range(r.i32()):
                    r.i32()  # offline_replicas
            parts.append(PartitionMetadata(perr, pid, leader))
        topics.append(TopicMetadata(err, name, parts, is_internal=internal))
    return MetadataResponse(brokers, controller, topics)


# ---------------------------------------------------------------------------
# ListOffsets v1 (classic) / v7 (flexible)


def encode_list_offsets_request(
    topic: str, partition_timestamps: List[Tuple[int, int]], version: int = 1
) -> bytes:
    w = ByteWriter()
    w.i32(-1)  # replica_id
    if version >= 6:
        w.i8(0)  # isolation_level: read_uncommitted (v2+)
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(partition_timestamps))
        for pid, ts in partition_timestamps:
            w.i32(pid)
            w.i32(-1)  # current_leader_epoch (v4+): unknown
            w.i64(ts)
            w.tags()
        w.tags()  # topic
        w.tags()  # request
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(partition_timestamps))
    for pid, ts in partition_timestamps:
        w.i32(pid).i64(ts)
    return w.done()


def decode_list_offsets_request(
    r: ByteReader, version: int = 1
) -> Tuple[str, List[Tuple[int, int]]]:
    r.i32()  # replica_id
    if version >= 6:
        r.i8()  # isolation_level
        ntopics = r.compact_array_len()
        if ntopics != 1:
            raise KafkaProtocolError(
                f"single-topic request invariant: got {ntopics} topics"
            )
        topic = r.compact_string() or ""
        out = []
        for _ in range(r.compact_array_len()):
            pid = r.i32()
            r.i32()  # current_leader_epoch
            out.append((pid, r.i64()))
            r.skip_tags()
        r.skip_tags()
        r.skip_tags()
        return topic, out
    ntopics = r.i32()
    if ntopics != 1:
        raise KafkaProtocolError(
            f"single-topic request invariant: got {ntopics} topics"
        )
    topic = r.string() or ""
    out = []
    for _ in range(r.i32()):
        out.append((r.i32(), r.i64()))
    return topic, out


def encode_list_offsets_response(
    topic: str, results: List[Tuple[int, ...]], version: int = 1
) -> bytes:
    """results: (partition, error, timestamp, offset[, leader_epoch])
    — the epoch element is optional (and only carried by v4+ wires)."""
    w = ByteWriter()
    if version >= 6:
        w.i32(0)  # throttle_time_ms (v2+)
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(results))
        for item in results:
            pid, err, ts, off = item[:4]
            w.i32(pid).i16(err).i64(ts).i64(off)
            w.i32(item[4] if len(item) > 4 else -1)  # leader_epoch (v4+)
            w.tags()
        w.tags()
        w.tags()
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(results))
    for item in results:
        pid, err, ts, off = item[:4]
        w.i32(pid).i16(err).i64(ts).i64(off)
    return w.done()


def decode_list_offsets_response(
    r: ByteReader, version: int = 1
) -> "dict[int, tuple[int, int, int]]":
    """{partition: (error, offset, leader_epoch)} — epoch -1 on wires
    that do not carry it (classic v1)."""
    out = {}
    if version >= 6:
        r.i32()  # throttle_time_ms
        for _ in range(r.compact_array_len()):
            r.compact_string()  # topic
            for _ in range(r.compact_array_len()):
                pid = r.i32()
                err = r.i16()
                r.i64()  # timestamp
                off = r.i64()
                epoch = r.i32()  # leader_epoch (v4+)
                r.skip_tags()
                out[pid] = (err, off, epoch)
            r.skip_tags()
        r.skip_tags()
        return out
    for _ in range(r.i32()):
        r.string()  # topic
        for _ in range(r.i32()):
            pid = r.i32()
            err = r.i16()
            r.i64()  # timestamp
            off = r.i64()
            out[pid] = (err, off, -1)
    return out


# ---------------------------------------------------------------------------
# Fetch v4 (classic) / v12 (flexible; sessionless — session_id 0, epoch -1)


def encode_fetch_request(
    topic: str,
    partition_offsets: List[Tuple[int, ...]],
    max_wait_ms: int,
    min_bytes: int,
    max_bytes: int,
    partition_max_bytes: int,
    version: int = 4,
) -> bytes:
    """``partition_offsets``: (partition, offset[, current_leader_epoch])
    — the optional epoch (KIP-320 fencing) rides the v9+ wire only; the
    classic v4 encoding has no epoch field, so fencing degrades to
    unfenced fetches there."""
    w = ByteWriter()
    w.i32(-1)  # replica_id
    w.i32(max_wait_ms).i32(min_bytes).i32(max_bytes).i8(0)  # isolation: read_uncommitted
    if version >= 12:
        w.i32(0).i32(-1)  # session_id / session_epoch: sessionless (KIP-227)
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(partition_offsets))
        for item in partition_offsets:
            pid, off = item[:2]
            w.i32(pid)
            # current_leader_epoch (v9+): the tracked epoch, or -1 unknown
            w.i32(item[2] if len(item) > 2 else -1)
            w.i64(off)
            w.i32(-1)       # last_fetched_epoch (v12+): none
            w.i64(-1)       # log_start_offset (v5+): consumer
            w.i32(partition_max_bytes)
            w.tags()
        w.tags()  # topic
        w.compact_array_len(0)  # forgotten_topics_data (v7+)
        w.compact_string("")    # rack_id (v11+)
        w.tags()
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(partition_offsets))
    for item in partition_offsets:
        pid, off = item[:2]
        w.i32(pid).i64(off).i32(partition_max_bytes)
    return w.done()


def decode_fetch_request(r: ByteReader, version: int = 4):
    """parts: (partition, offset, partition_max_bytes,
    current_leader_epoch) — epoch -1 on classic wires (no field) and
    from clients that do not track one (the fake broker validates it)."""
    r.i32()  # replica
    max_wait = r.i32()
    min_bytes = r.i32()
    max_bytes = r.i32()
    r.i8()  # isolation
    if version >= 12:
        r.i32()  # session_id
        r.i32()  # session_epoch
        ntopics = r.compact_array_len()
        if ntopics != 1:
            raise KafkaProtocolError(
                f"single-topic request invariant: got {ntopics} topics"
            )
        topic = r.compact_string() or ""
        parts = []
        for _ in range(r.compact_array_len()):
            pid = r.i32()
            epoch = r.i32()  # current_leader_epoch (v9+)
            off = r.i64()
            r.i32()  # last_fetched_epoch
            r.i64()  # log_start_offset
            pmax = r.i32()
            r.skip_tags()
            parts.append((pid, off, pmax, epoch))
        r.skip_tags()  # topic
        for _ in range(r.compact_array_len()):  # forgotten topics
            r.compact_string()
            for _ in range(r.compact_array_len()):
                r.i32()
            r.skip_tags()
        r.compact_string()  # rack_id
        r.skip_tags()
        return topic, parts, max_wait, min_bytes, max_bytes
    ntopics = r.i32()
    if ntopics != 1:
        raise KafkaProtocolError(
            f"single-topic request invariant: got {ntopics} topics"
        )
    topic = r.string() or ""
    parts = []
    for _ in range(r.i32()):
        pid = r.i32()
        off = r.i64()
        pmax = r.i32()
        parts.append((pid, off, pmax, -1))
    return topic, parts, max_wait, min_bytes, max_bytes


def encode_fetch_response(
    topic: str, partitions: List[Tuple[int, ...]], version: int = 4
) -> bytes:
    """partitions: (partition, error, high_watermark, record_set_bytes
    [, log_start_offset]) — log_start rides the v5+ wire only (the
    classic v4 encoding has no field for it)."""
    w = ByteWriter()
    w.i32(0)  # throttle_time_ms
    if version >= 12:
        w.i16(0)  # top-level error_code (v7+)
        w.i32(0)  # session_id (v7+)
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(partitions))
        for item in partitions:
            pid, err, hw, records = item[:4]
            w.i32(pid).i16(err).i64(hw)
            w.i64(hw)   # last_stable_offset (v4+)
            w.i64(item[4] if len(item) > 4 else 0)  # log_start_offset (v5+)
            w.compact_array_len(0)  # aborted_transactions
            w.i32(-1)   # preferred_read_replica (v11+)
            w.compact_bytes(records)
            w.tags()
        w.tags()
        w.tags()
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(partitions))
    for item in partitions:
        pid, err, hw, records = item[:4]
        w.i32(pid).i16(err).i64(hw)
        w.i64(hw)  # last_stable_offset
        w.i32(0)   # aborted_transactions: empty
        w.bytes_(records)
    return w.done()


@dataclasses.dataclass
class FetchedPartition:
    partition: int
    error: int
    high_watermark: int
    records: bytes
    #: Broker-reported first retained offset (v5+ wires; -1 when the wire
    #: does not carry it) — the retention-race accounting compares it
    #: against the cursor without an extra ListOffsets round trip.
    log_start_offset: int = -1


def decode_fetch_response(r: ByteReader, version: int = 4) -> List[FetchedPartition]:
    r.i32()  # throttle
    out = []
    if version >= 12:
        err_top = r.i16()
        if err_top:
            raise KafkaProtocolError(f"Fetch error {err_top}")
        r.i32()  # session_id
        for _ in range(r.compact_array_len()):
            r.compact_string()  # topic
            for _ in range(r.compact_array_len()):
                pid = r.i32()
                err = r.i16()
                hw = r.i64()
                r.i64()  # last_stable_offset
                log_start = r.i64()  # log_start_offset (v5+)
                for _ in range(r.compact_array_len()):  # aborted txns
                    r.i64()
                    r.i64()
                    r.skip_tags()
                r.i32()  # preferred_read_replica
                records = r.compact_bytes_view()
                r.skip_tags()
                out.append(
                    FetchedPartition(
                        pid, err, hw,
                        records if records is not None else b"",
                        log_start_offset=log_start,
                    )
                )
            r.skip_tags()
        r.skip_tags()
        return out
    for _ in range(r.i32()):
        r.string()  # topic
        for _ in range(r.i32()):
            pid = r.i32()
            err = r.i16()
            hw = r.i64()
            r.i64()  # last_stable_offset
            for _ in range(r.i32()):  # aborted txns
                r.i64()
                r.i64()
            records = r.bytes_view()
            out.append(
                FetchedPartition(
                    pid, err, hw, records if records is not None else b""
                )
            )
    return out


# ---------------------------------------------------------------------------
# ApiVersions v0 (classic) / v3 (flexible request; response header stays v0
# at EVERY version — the broker answers before knowing the client's
# flexible support)


def encode_api_versions_request(version: int = 0) -> bytes:
    if version < 3:
        return b""
    w = ByteWriter()
    w.compact_string("kafka-topic-analyzer-tpu")
    w.compact_string("2")
    w.tags()
    return w.done()


def encode_api_versions_response(
    apis: List[Tuple[int, int, int]], version: int = 0
) -> bytes:
    w = ByteWriter()
    w.i16(0)  # error
    if version >= 3:
        w.compact_array_len(len(apis))
        for key, vmin, vmax in apis:
            w.i16(key).i16(vmin).i16(vmax)
            w.tags()
        w.i32(0)  # throttle_time_ms (v1+)
        w.tags()
        return w.done()
    w.i32(len(apis))
    for key, vmin, vmax in apis:
        w.i16(key).i16(vmin).i16(vmax)
    return w.done()


def decode_api_versions_response(
    r: ByteReader, version: int = 0
) -> "dict[int, tuple[int, int]]":
    err = r.i16()
    if err == ERR_UNSUPPORTED_VERSION:
        # Answered in v0 format regardless of the requested version
        # (KIP-511): the caller downgrades and retries.
        raise UnsupportedVersionError("ApiVersions error 35")
    if err:
        raise KafkaProtocolError(f"ApiVersions error {err}")
    out = {}
    if version >= 3:
        for _ in range(r.compact_array_len()):
            api_key = r.i16()
            vmin = r.i16()
            vmax = r.i16()
            r.skip_tags()
            out[api_key] = (vmin, vmax)
        r.i32()  # throttle_time_ms
        r.skip_tags()
        return out
    for _ in range(r.i32()):
        # Read fields in explicit order: `out[r.i16()] = (r.i16(), r.i16())`
        # evaluates the RHS before the key and scrambles the triples.
        api_key = r.i16()
        vmin = r.i16()
        vmax = r.i16()
        out[api_key] = (vmin, vmax)
    return out


# ---------------------------------------------------------------------------
# OffsetForLeaderEpoch v3 (classic) / v4 (flexible) — KIP-320's divergence
# check: "what is the end offset of epoch E?"  The broker answers with the
# end offset of the largest epoch <= E; an answer BELOW the client's cursor
# means the log was truncated (unclean election) and everything from the
# answer to the cursor no longer exists.


def encode_offset_for_leader_epoch_request(
    topic: str,
    partitions: List[Tuple[int, int, int]],
    version: int = 3,
) -> bytes:
    """partitions: (partition, current_leader_epoch, leader_epoch) — the
    fencing epoch the client believes is current, and the epoch whose end
    offset it asks for."""
    w = ByteWriter()
    if version >= 3:
        w.i32(-1)  # replica_id (v3+): consumer
    if version >= 4:
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(partitions))
        for pid, cur_epoch, epoch in partitions:
            w.i32(pid).i32(cur_epoch).i32(epoch)
            w.tags()
        w.tags()  # topic
        w.tags()  # request
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(partitions))
    for pid, cur_epoch, epoch in partitions:
        w.i32(pid)
        w.i32(cur_epoch)  # current_leader_epoch (v2+)
        w.i32(epoch)
    return w.done()


def decode_offset_for_leader_epoch_request(
    r: ByteReader, version: int = 3
) -> Tuple[str, List[Tuple[int, int, int]]]:
    if version >= 3:
        r.i32()  # replica_id
    if version >= 4:
        ntopics = r.compact_array_len()
        if ntopics != 1:
            raise KafkaProtocolError(
                f"single-topic request invariant: got {ntopics} topics"
            )
        topic = r.compact_string() or ""
        out = []
        for _ in range(r.compact_array_len()):
            pid = r.i32()
            cur_epoch = r.i32()
            epoch = r.i32()
            r.skip_tags()
            out.append((pid, cur_epoch, epoch))
        r.skip_tags()
        r.skip_tags()
        return topic, out
    ntopics = r.i32()
    if ntopics != 1:
        raise KafkaProtocolError(
            f"single-topic request invariant: got {ntopics} topics"
        )
    topic = r.string() or ""
    out = []
    for _ in range(r.i32()):
        pid = r.i32()
        cur_epoch = r.i32()
        epoch = r.i32()
        out.append((pid, cur_epoch, epoch))
    return topic, out


def encode_offset_for_leader_epoch_response(
    topic: str,
    results: List[Tuple[int, int, int, int]],
    version: int = 3,
) -> bytes:
    """results: (partition, error, leader_epoch, end_offset)."""
    w = ByteWriter()
    w.i32(0)  # throttle_time_ms (v2+)
    if version >= 4:
        w.compact_array_len(1).compact_string(topic)
        w.compact_array_len(len(results))
        for pid, err, epoch, end_off in results:
            w.i16(err).i32(pid).i32(epoch).i64(end_off)
            w.tags()
        w.tags()
        w.tags()
        return w.done()
    w.i32(1).string(topic)
    w.i32(len(results))
    for pid, err, epoch, end_off in results:
        w.i16(err).i32(pid).i32(epoch).i64(end_off)
    return w.done()


def decode_offset_for_leader_epoch_response(
    r: ByteReader, version: int = 3
) -> "dict[int, tuple[int, int, int]]":
    """{partition: (error, leader_epoch, end_offset)} — end_offset is the
    first offset AFTER the requested epoch's last record (-1 on error)."""
    r.i32()  # throttle_time_ms
    out = {}
    if version >= 4:
        for _ in range(r.compact_array_len()):
            r.compact_string()  # topic
            for _ in range(r.compact_array_len()):
                err = r.i16()
                pid = r.i32()
                epoch = r.i32()
                end_off = r.i64()
                r.skip_tags()
                out[pid] = (err, epoch, end_off)
            r.skip_tags()
        r.skip_tags()
        return out
    for _ in range(r.i32()):
        r.string()  # topic
        for _ in range(r.i32()):
            err = r.i16()
            pid = r.i32()
            epoch = r.i32()
            end_off = r.i64()
            out[pid] = (err, epoch, end_off)
    return out


# ---------------------------------------------------------------------------
# SASL (handshake v1 + authenticate v0; PLAIN + SCRAM-SHA-256/512)


def encode_sasl_handshake_request(mechanism: str) -> bytes:
    return ByteWriter().string(mechanism).done()


def decode_sasl_handshake_request(r: ByteReader) -> str:
    return r.string() or ""


def encode_sasl_handshake_response(error: int, mechanisms: List[str]) -> bytes:
    w = ByteWriter()
    w.i16(error).i32(len(mechanisms))
    for m in mechanisms:
        w.string(m)
    return w.done()


def decode_sasl_handshake_response(r: ByteReader) -> "tuple[int, list[str]]":
    err = r.i16()
    mechanisms = [r.string() or "" for _ in range(r.i32())]
    return err, mechanisms


def sasl_plain_token(username: str, password: str) -> bytes:
    return b"\x00" + username.encode() + b"\x00" + password.encode()


def encode_sasl_authenticate_request(auth_bytes: bytes) -> bytes:
    return ByteWriter().bytes_(auth_bytes).done()


def decode_sasl_authenticate_request(r: ByteReader) -> bytes:
    return r.bytes_() or b""


def encode_sasl_authenticate_response(
    error: int,
    error_message: Optional[str] = None,
    auth_bytes: bytes = b"",
) -> bytes:
    return (
        ByteWriter().i16(error).string(error_message).bytes_(auth_bytes).done()
    )


def decode_sasl_authenticate_response(
    r: ByteReader,
) -> "tuple[int, Optional[str], bytes]":
    err = r.i16()
    msg = r.string()
    # bytes() guard: response buffers may be memoryviews (zero-copy
    # receive) and SCRAM parsing splits/decodes the token.
    auth = r.bytes_()  # SCRAM server-first/server-final rides here
    return err, msg, bytes(auth) if auth is not None else b""


# -- SCRAM (RFC 5802/7677 over Kafka's SaslAuthenticate round trips) --------

SCRAM_MECHANISMS = {"SCRAM-SHA-256": "sha256", "SCRAM-SHA-512": "sha512"}


def _scram_saslname(name: str) -> str:
    """RFC 5802 saslname escaping for the n= attribute."""
    return name.replace("=", "=3D").replace(",", "=2C")


def _scram_parse(msg: bytes) -> "dict[str, str]":
    out = {}
    try:
        text = msg.decode("utf-8")
    except UnicodeDecodeError as e:
        raise KafkaProtocolError(f"non-UTF-8 SCRAM server message: {e}") from e
    for part in text.split(","):
        if len(part) >= 2 and part[1] == "=":
            out[part[0]] = part[2:]
    return out


def _scram_hi(hash_name: str, password: bytes, salt: bytes, it: int) -> bytes:
    import hashlib

    return hashlib.pbkdf2_hmac(hash_name, password, salt, it)


class ScramClient:
    """Client side of one SCRAM exchange (no channel binding, like the
    Kafka clients).  Usage: first_message() → broker; final_message(
    server_first) → broker; verify_server_final(server_final)."""

    def __init__(self, mechanism: str, username: str, password: str):
        import base64
        import os as _os

        self.hash_name = SCRAM_MECHANISMS[mechanism]
        self.password = password.encode("utf-8")
        self.nonce = base64.b64encode(_os.urandom(24)).decode()
        self._first_bare = f"n={_scram_saslname(username)},r={self.nonce}"
        self._auth_message: Optional[bytes] = None
        self._salted: Optional[bytes] = None

    def first_message(self) -> bytes:
        return ("n,," + self._first_bare).encode("utf-8")

    def final_message(self, server_first: bytes) -> bytes:
        import base64
        import hashlib
        import hmac as _hmac

        attrs = _scram_parse(server_first)
        if "e" in attrs:
            raise KafkaProtocolError(f"SCRAM server error: {attrs['e']}")
        try:
            full_nonce = attrs["r"]
            salt = base64.b64decode(attrs["s"])
            iterations = int(attrs["i"])
        except (KeyError, ValueError) as e:
            raise KafkaProtocolError(
                f"malformed SCRAM server-first message: {e}"
            ) from e
        if not full_nonce.startswith(self.nonce):
            raise KafkaProtocolError(
                "SCRAM server nonce does not extend the client nonce"
            )
        if iterations < 4096 or iterations > 10_000_000:
            # RFC 7677 / Kafka's ScramMechanism.minIterations: a lower
            # count is a MITM downgrade making offline cracking cheap.
            raise KafkaProtocolError(
                f"SCRAM iteration count {iterations} out of range "
                "(4096..10M)"
            )
        without_proof = f"c=biws,r={full_nonce}"  # biws = b64("n,,")
        self._auth_message = ",".join(
            [self._first_bare, server_first.decode("utf-8"), without_proof]
        ).encode("utf-8")
        self._salted = _scram_hi(
            self.hash_name, self.password, salt, iterations
        )
        client_key = _hmac.new(
            self._salted, b"Client Key", self.hash_name
        ).digest()
        stored_key = hashlib.new(self.hash_name, client_key).digest()
        signature = _hmac.new(
            stored_key, self._auth_message, self.hash_name
        ).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        return (
            without_proof + ",p=" + base64.b64encode(proof).decode()
        ).encode("utf-8")

    def verify_server_final(self, server_final: bytes) -> None:
        import base64
        import hmac as _hmac

        attrs = _scram_parse(server_final)
        if "e" in attrs:
            raise KafkaProtocolError(f"SCRAM server error: {attrs['e']}")
        if "v" not in attrs or self._salted is None:
            raise KafkaProtocolError("malformed SCRAM server-final message")
        try:
            got = base64.b64decode(attrs["v"], validate=True)
        except Exception as e:
            raise KafkaProtocolError(
                f"malformed SCRAM server signature: {e}"
            ) from e
        server_key = _hmac.new(
            self._salted, b"Server Key", self.hash_name
        ).digest()
        expected = _hmac.new(
            server_key, self._auth_message, self.hash_name
        ).digest()
        if not _hmac.compare_digest(got, expected):
            raise KafkaProtocolError(
                "SCRAM server signature verification failed "
                "(broker does not know the password)"
            )


class ScramServer:
    """Server side, for the credential-enforcing fake broker (and as the
    client's test oracle).  One instance per connection attempt."""

    def __init__(
        self,
        mechanism: str,
        username: str,
        password: str,
        iterations: int = 4096,
        salt: Optional[bytes] = None,
    ):
        import os as _os

        self.hash_name = SCRAM_MECHANISMS[mechanism]
        self.username = username
        self.password = password.encode("utf-8")
        self.iterations = iterations
        self.salt = salt if salt is not None else _os.urandom(16)
        self._client_first_bare: Optional[str] = None
        self._server_first: Optional[str] = None
        self._user_ok = False

    def handle_first(self, client_first: bytes) -> bytes:
        import base64
        import os as _os

        text = client_first.decode("utf-8")
        if not text.startswith("n,,"):
            raise ValueError("expected gs2 header 'n,,'")
        self._client_first_bare = text[3:]
        attrs = _scram_parse(self._client_first_bare.encode())
        # Real brokers look credentials up by username; an unknown user
        # completes the exchange (no information leak) but always fails
        # the proof check.
        self._user_ok = attrs.get("n") == _scram_saslname(self.username)
        nonce = attrs.get("r", "") + base64.b64encode(_os.urandom(18)).decode()
        self._server_first = (
            f"r={nonce},s={base64.b64encode(self.salt).decode()},"
            f"i={self.iterations}"
        )
        return self._server_first.encode("utf-8")

    def handle_final(self, client_final: bytes) -> "tuple[bool, bytes]":
        import base64
        import hashlib
        import hmac as _hmac

        attrs = _scram_parse(client_final)
        cf_text = client_final.decode("utf-8")
        without_proof = cf_text[: cf_text.rfind(",p=")]
        auth_message = ",".join(
            [self._client_first_bare or "", self._server_first or "",
             without_proof]
        ).encode("utf-8")
        salted = _scram_hi(
            self.hash_name, self.password, self.salt, self.iterations
        )
        client_key = _hmac.new(salted, b"Client Key", self.hash_name).digest()
        stored_key = hashlib.new(self.hash_name, client_key).digest()
        signature = _hmac.new(stored_key, auth_message, self.hash_name).digest()
        try:
            proof = base64.b64decode(attrs.get("p", ""))
        except ValueError:
            proof = b""
        recovered = bytes(a ^ b for a, b in zip(proof, signature))
        if (
            not self._user_ok
            or len(proof) != len(signature)
            or not _hmac.compare_digest(
                hashlib.new(self.hash_name, recovered).digest(), stored_key
            )
        ):
            return False, b"e=invalid-proof"
        server_key = _hmac.new(salted, b"Server Key", self.hash_name).digest()
        server_sig = _hmac.new(server_key, auth_message, self.hash_name).digest()
        return True, b"v=" + base64.b64encode(server_sig)


# ---------------------------------------------------------------------------
# RecordBatch v2

COMPRESSION_NONE = 0
COMPRESSION_GZIP = 1
COMPRESSION_SNAPPY = 2
COMPRESSION_LZ4 = 3
COMPRESSION_ZSTD = 4

#: (timestamp_ms, key bytes|None, value bytes|None)
RecordTuple = Tuple[int, Optional[bytes], Optional[bytes]]

#: (absolute_offset, timestamp_ms, key, value) — offsets may have gaps, as
#: log compaction leaves holes in retained batches.
OffsetRecord = Tuple[int, int, Optional[bytes], Optional[bytes]]


def encode_record_batch(
    records: List[OffsetRecord],
    compression: int = COMPRESSION_NONE,
    last_offset: Optional[int] = None,
    leader_epoch: int = -1,
) -> bytes:
    """``last_offset`` overrides the batch header's covered range (default:
    the last record's offset) — a compacted log's batches keep their
    original last_offset_delta even when the tail records were removed.
    ``leader_epoch`` stamps the header's partition_leader_epoch (outside
    the CRC, like a real broker, which rewrites it on leader change)."""
    if not records:
        return b""
    base_offset = records[0][0]
    first_ts = records[0][1]
    max_ts = max(ts for _, ts, _, _ in records)
    body = ByteWriter()
    for off, ts, key, value in records:
        rec = ByteWriter()
        rec.i8(0)  # attributes
        rec.varint(ts - first_ts)
        rec.varint(off - base_offset)
        rec.varbytes(key)
        rec.varbytes(value)
        rec.varint(0)  # headers
        rb = rec.done()
        body.varint(len(rb)).raw(rb)
    payload = body.done()
    if compression == COMPRESSION_GZIP:
        # Kafka's gzip codec is RFC-1952 gzip framing (Java GZIPOutputStream),
        # not a bare zlib stream.
        co = zlib.compressobj(wbits=31)
        payload = co.compress(payload) + co.flush()
    elif compression == COMPRESSION_SNAPPY:
        from kafka_topic_analyzer_tpu_torch.io.compression import snappy_compress_xerial

        payload = snappy_compress_xerial(payload)
    elif compression == COMPRESSION_LZ4:
        from kafka_topic_analyzer_tpu_torch.io.compression import lz4_compress_frame

        payload = lz4_compress_frame(payload)
    elif compression == COMPRESSION_ZSTD:
        from kafka_topic_analyzer_tpu_torch.io.compression import zstd_compress_frame

        payload = zstd_compress_frame(payload)

    # Fields covered by the CRC (everything from attributes onward).
    crcw = ByteWriter()
    crcw.i16(compression)  # attributes (low bits = codec)
    crcw.i32(
        (last_offset if last_offset is not None else records[-1][0])
        - base_offset
    )  # last_offset_delta
    crcw.i64(first_ts).i64(max_ts)
    crcw.i64(-1).i16(-1).i32(-1)  # producer id/epoch, base sequence
    crcw.i32(len(records))
    crc_part = crcw.done() + payload
    crc = _crc32c(crc_part)  # Kafka checksums batches with CRC32-C

    head = ByteWriter()
    head.i64(base_offset)
    head.i32(4 + 1 + 4 + len(crc_part))  # batch_length: from leader_epoch on
    head.i32(leader_epoch)  # partition_leader_epoch (outside the CRC)
    head.i8(2)  # magic
    head.u32(crc)
    return head.done() + crc_part


def encode_control_batch(offset: int, ts_ms: int, commit: bool = True) -> bytes:
    """A transaction control batch (attributes bits: 0x20 control, 0x10
    transactional) holding one COMMIT/ABORT marker record.  Consumers
    never surface these as messages; offsets still advance past them."""
    key = struct.pack(">hh", 0, 1 if commit else 0)  # version, type
    value = struct.pack(">hi", 0, 0)  # version, coordinator epoch
    rec = ByteWriter()
    rec.i8(0)
    rec.varint(0)  # ts delta
    rec.varint(0)  # offset delta
    rec.varbytes(key)
    rec.varbytes(value)
    rec.varint(0)  # headers
    rb = rec.done()
    body = ByteWriter()
    body.varint(len(rb)).raw(rb)
    payload = body.done()

    crcw = ByteWriter()
    crcw.i16(0x30)  # attributes: control | transactional
    crcw.i32(0)  # last_offset_delta
    crcw.i64(ts_ms).i64(ts_ms)
    crcw.i64(-1).i16(-1).i32(-1)
    crcw.i32(1)
    crc_part = crcw.done() + payload
    head = ByteWriter()
    head.i64(offset)
    head.i32(4 + 1 + 4 + len(crc_part))
    head.i32(-1)
    head.i8(2)
    head.u32(_crc32c(crc_part))
    return head.done() + crc_part


def _encode_legacy_message(
    offset: int,
    ts_ms: int,
    key: Optional[bytes],
    value: Optional[bytes],
    magic: int,
    attributes: int = 0,
) -> bytes:
    body = bytearray([magic, attributes])
    if magic == 1:
        body += struct.pack(">q", ts_ms)
    body += struct.pack(">i", -1) if key is None else (
        struct.pack(">i", len(key)) + key
    )
    body += struct.pack(">i", -1) if value is None else (
        struct.pack(">i", len(value)) + value
    )
    msg = struct.pack(">I", zlib.crc32(bytes(body))) + bytes(body)
    return struct.pack(">qi", offset, len(msg)) + msg


def encode_message_set(
    records: List[OffsetRecord],
    magic: int = 1,
    compression: int = COMPRESSION_NONE,
    log_append_time: bool = False,
) -> bytes:
    """Legacy MessageSet v0/v1 encoder (tests / fake-broker fixtures for
    pre-0.11 segments).  Compressed sets use the wrapper-message scheme:
    the wrapper's offset is the last inner message's absolute offset, and
    magic-1 inner messages carry relative offsets starting at 0 (KIP-31);
    magic-0 inner messages keep absolute offsets."""
    if magic not in (0, 1):
        raise ValueError("legacy message sets are magic 0 or 1")
    if not records:
        return b""
    if compression == COMPRESSION_NONE:
        return b"".join(
            _encode_legacy_message(off, ts, k, v, magic)
            for off, ts, k, v in records
        )
    base = records[0][0]
    inner = b"".join(
        _encode_legacy_message(
            # KIP-31 relative offsets are deltas from the first inner
            # message (gaps from compaction are preserved), not 0..n-1.
            (off - base) if magic == 1 else off, ts, k, v, magic
        )
        for off, ts, k, v in records
    )
    from kafka_topic_analyzer_tpu_torch.io import compression as comp_mod

    if compression == COMPRESSION_GZIP:
        co = zlib.compressobj(wbits=31)
        payload = co.compress(inner) + co.flush()
    elif compression == COMPRESSION_SNAPPY:
        payload = comp_mod.snappy_compress_xerial(inner)
    elif compression == COMPRESSION_LZ4:
        payload = comp_mod.lz4_compress_frame(inner)
    elif compression == COMPRESSION_ZSTD:
        raise ValueError("zstd requires RecordBatch v2 (magic 2)")
    else:
        raise ValueError(f"unknown compression codec {compression}")
    attrs = compression | (0x08 if (log_append_time and magic == 1) else 0)
    wrapper_ts = records[-1][1] if magic == 1 else -1
    return _encode_legacy_message(
        records[-1][0], wrapper_ts, None, payload, magic, attrs
    )


def _crc32c_py(data: bytes) -> int:
    """Pure-Python CRC32-C (reference/fallback; ~100 ms/MB)."""
    table = _CRC32C_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_crc32c_impl = None  # resolved once on first use (per-frame hot path)


def _crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli) — Kafka's record-batch checksum.  Uses the
    port's native shim when it loads (`io.native.crc32c_native`);
    otherwise the Python table loop."""
    global _crc32c_impl
    if _crc32c_impl is None:
        from kafka_topic_analyzer_tpu_torch.io import native

        _crc32c_impl = (
            native.crc32c_native if native.native_available() else _crc32c_py
        )
    return _crc32c_impl(data)


def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


@dataclasses.dataclass
class BatchFrame:
    """One parsed RecordBatch v2 frame with its payload decompressed —
    the shared input of the per-record Python generator and the native
    array decoder (io/native.py::decode_records_native)."""

    base_offset: int
    first_ts: int
    num_records: int
    payload: bytes
    #: One past the last offset this batch COVERS (base + last_offset_delta
    #: + 1).  On compacted topics this can exceed the last retained record's
    #: offset — the fetch loop uses it to advance past removed ranges.
    end_offset: int = -1
    #: Pre-decoded records for legacy MessageSet v0/v1 entries (magic 0/1):
    #: [(abs_offset, ts_ms, key, value)].  When set, `payload` is empty and
    #: the per-record decoders read from here (the native array decoder
    #: returns None so callers fall back).
    legacy_records: Optional[list] = None
    #: Byte range of this frame in the record-set buffer it was parsed
    #: from (-1 when unknown) — the corruption layer slices the raw frame
    #: for quarantine from these.
    byte_start: int = -1
    byte_end: int = -1
    #: The header's partition_leader_epoch (v2 frames; -1 on legacy
    #: MessageSets, which predate epochs) — the wire layer tracks the max
    #: seen per partition for KIP-320 fencing, and a REGRESSION signals a
    #: stale replica / truncated log.
    leader_epoch: int = -1


def _decode_legacy_entry(
    buf: bytes, pos: int, end: int, verify_crc: bool, depth: int = 0
) -> "list[tuple[int, int, Optional[bytes], Optional[bytes]]]":
    """One MessageSet v0/v1 entry → [(abs_offset, ts_ms, key, value)].
    Compressed entries are wrapper messages whose value is a nested
    MessageSet (exactly one level in valid data — enforced).  Offset
    rules: magic-1 wrappers carry the absolute offset of the LAST inner
    message while inner messages store relative offsets (KIP-31, gaps
    preserved); magic-0 wrappers hold absolute inner offsets."""
    if end - pos < 26:  # header(12) + crc(4) + magic+attrs(2) + klen+vlen(8)
        raise MalformedHeaderError("legacy message below minimum size")
    offset = struct.unpack_from(">q", buf, pos)[0]
    crc = struct.unpack_from(">I", buf, pos + 12)[0]
    magic = buf[pos + 16]
    attributes = buf[pos + 17]
    if verify_crc:
        actual = zlib.crc32(buf[pos + 16 : end])
        if actual != crc:
            raise CrcMismatchError(
                f"legacy message CRC mismatch at offset {offset}",
                base_offset=offset,
                crc_expected=crc,
                crc_actual=actual,
            )
    p = pos + 18
    ts_ms = -1
    if magic == 1:
        if p + 8 > end:
            raise TruncatedFrameError("truncated v1 message timestamp")
        ts_ms = struct.unpack_from(">q", buf, p)[0]
        p += 8
    if p + 4 > end:
        raise TruncatedFrameError("truncated legacy message key")
    (klen,) = struct.unpack_from(">i", buf, p)
    p += 4
    key = None
    if klen >= 0:
        if p + klen > end:
            raise TruncatedFrameError("truncated legacy message key")
        key = buf[p : p + klen]
        p += klen
    if p + 4 > end:
        raise TruncatedFrameError("truncated legacy message value")
    (vlen,) = struct.unpack_from(">i", buf, p)
    p += 4
    value = None
    if vlen >= 0:
        if p + vlen > end:
            raise TruncatedFrameError("truncated legacy message value")
        value = buf[p : p + vlen]
        p += vlen
    codec = attributes & 0x07
    if codec == COMPRESSION_NONE:
        return [(offset, ts_ms, key, value)]
    # Wrapper message: decompress and recurse into the inner MessageSet.
    if depth >= 1:
        # Valid Kafka data nests exactly one wrapper level; deeper nesting
        # would multiply the per-decompression memory cap per level.
        raise MalformedHeaderError("nested compressed wrapper messages")
    if value is None:
        raise MalformedHeaderError("compressed wrapper message with null value")
    try:
        inner_buf = _decompress(codec, value)
    except CorruptFrameError:
        raise
    except Exception as e:
        raise BadCompressionError(
            f"legacy wrapper message at offset {offset}: {e}",
            base_offset=offset,
        ) from e
    inner: "list[tuple[int, int, Optional[bytes], Optional[bytes]]]" = []
    ipos = 0
    while ipos + 12 <= len(inner_buf):
        (isize,) = struct.unpack_from(">i", inner_buf, ipos + 8)
        iend = ipos + 12 + isize
        if isize <= 0 or iend > len(inner_buf):
            raise TruncatedFrameError("truncated inner message set")
        inner.extend(
            _decode_legacy_entry(inner_buf, ipos, iend, verify_crc, depth + 1)
        )
        ipos = iend
    if not inner:
        return []
    if magic == 1:
        # KIP-31: wrapper offset = last inner's ABSOLUTE offset, inner
        # offsets are relative — so base = wrapper - last, unconditionally.
        # Old producers that wrote absolute inner offsets get base == 0,
        # which this handles too (the official clients do the same).
        base = offset - inner[-1][0]
        inner = [(base + o, ts, k, v) for o, ts, k, v in inner]
    if magic == 1 and attributes & 0x08:
        # LogAppendTime: the wrapper's timestamp applies to every record.
        inner = [(o, ts_ms, k, v) for o, _ts, k, v in inner]
    return inner


@dataclasses.dataclass
class CorruptSpan:
    """One poisoned byte span isolated by `salvage_batch_frames`: the
    classified error plus everything the wire layer needs to skip, account
    for, and quarantine the frame — byte bounds for the raw evidence,
    claimed offsets for the resume position."""

    error: CorruptFrameError
    start: int           # byte start of the poisoned span in the buffer
    end: int             # byte end (exclusive) — iteration resumes here
    base_offset: int = -1   # header-claimed base offset (-1 unreadable)
    claimed_end: int = -1   # base + last_offset_delta + 1 when readable
    resume_offset: int = -1  # next salvaged frame's base offset (-1 unknown)
    num_records: int = 0    # header-claimed record count when plausible

    def skip_offset(self, floor: int) -> int:
        """Offset a skip should resume the partition at, or -1 when the
        span gives no bound past ``floor`` (unskippable)."""
        return preferred_skip_offset(
            floor, self.resume_offset, self.claimed_end
        )


def preferred_skip_offset(
    floor: int, resume_offset: int, claimed_end: int
) -> int:
    """The ONE skip-bound policy (CorruptSpan.skip_offset and the wire
    layer's _note_corrupt both use it): prefer the validated next-frame
    base over the corrupt frame's own claimed coverage.  ``claimed_end``
    comes from a header that just FAILED its checksum — a bit-flipped
    last_offset_delta must not swallow the rest of the partition — while
    ``resume_offset`` was structurally (and, under check.crcs, checksum-)
    validated by the salvage resync.  Offsets between the true coverage
    and the next retained frame hold no records (compaction holes), so
    preferring resume_offset never skips data.  -1 when neither candidate
    exceeds ``floor``."""
    for candidate in (resume_offset, claimed_end):
        if candidate > floor:
            return candidate
    return -1


#: Minimum plausible v2 batch_length: the fields it covers
#: (leader_epoch+magic+crc+attrs+delta+2 ts+pid+pepoch+bseq+count).
_MIN_V2_BATCH_LENGTH = 4 + 1 + 4 + 2 + 4 + 8 + 8 + 8 + 2 + 4 + 4
#: Minimum plausible legacy message_size: crc+magic+attrs+klen+vlen.
_MIN_LEGACY_MESSAGE_SIZE = 4 + 1 + 1 + 4 + 4


#: Kafka's codec ids (the low three bits of a batch's attributes) by name,
#: as the decompression counters label them.
CODEC_NAMES = {COMPRESSION_GZIP: "gzip", COMPRESSION_SNAPPY: "snappy",
               COMPRESSION_LZ4: "lz4", COMPRESSION_ZSTD: "zstd"}


def _decompress(codec: int, payload) -> bytes:
    """`compression.decompress` in a span ``decompress`` (args ``codec``,
    ``in`` and ``out`` bytes): its duration books
    ``kta_decompress_seconds_total`` and, once it succeeds, its bytes
    ``kta_decompress_{in,out}_bytes_total``, each by codec."""
    from kafka_topic_analyzer_tpu_torch.io.compression import decompress
    from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
    from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace

    name = CODEC_NAMES.get(codec, str(codec))
    with obs_trace.timed(
        "decompress", obs_metrics.DECOMPRESS_SECONDS.labels(codec=name),
        cat="io", codec=name, **{"in": len(payload)},
    ) as span:
        out = decompress(codec, payload)
        span.args["out"] = len(out)
    obs_metrics.DECOMPRESS_IN_BYTES.labels(codec=name).inc(len(payload))
    obs_metrics.DECOMPRESS_OUT_BYTES.labels(codec=name).inc(len(out))
    return out


def _parse_frame_at(
    buf: bytes, pos: int, end: int, verify_crc: bool
) -> Optional[BatchFrame]:
    """Parse one complete frame at ``pos`` (bounds already validated) into
    a BatchFrame — or None for an empty legacy entry.  Every failure mode
    raises a classified CorruptFrameError carrying the frame's byte span
    and whatever header fields were readable."""
    base_offset = struct.unpack_from(">q", buf, pos)[0]
    magic = buf[pos + 16]
    if magic in (0, 1):
        try:
            records = _decode_legacy_entry(buf, pos, end, verify_crc)
        except CorruptFrameError as e:
            e.span = (pos, end)
            if e.base_offset < 0:
                e.base_offset = base_offset
            if e.claimed_end < 0 and base_offset >= 0:
                # Legacy wrapper offsets are the LAST covered offset.
                e.claimed_end = base_offset + 1
            raise
        if not records:
            return None
        return BatchFrame(
            base_offset=records[0][0],
            first_ts=records[0][1],
            num_records=len(records),
            payload=b"",
            end_offset=records[-1][0] + 1,
            legacy_records=records,
            byte_start=pos,
            byte_end=end,
        )
    if magic != 2:
        raise MalformedHeaderError(
            f"unsupported record format magic={magic} (need magic <= 2)",
            base_offset=base_offset,
            span=(pos, end),
        )
    leader_epoch = struct.unpack_from(">i", buf, pos + 12)[0]
    r = ByteReader(buf, pos + 17)
    crc = r.u32()
    crc_start = r.pos
    attributes = r.i16()
    last_offset_delta = r.i32()
    first_ts = r.i64()
    r.i64()  # max_ts
    r.i64()  # producer id
    r.i16()  # producer epoch
    r.i32()  # base sequence
    num_records = r.i32()
    claimed_end = base_offset + max(last_offset_delta, 0) + 1
    if num_records < 0:
        raise MalformedHeaderError(
            f"negative record count at offset {base_offset}",
            base_offset=base_offset,
            span=(pos, end),
            claimed_end=claimed_end,
        )
    payload = buf[r.pos : end]
    if verify_crc:
        actual = _crc32c(buf[crc_start:end])
        if actual != crc:
            raise CrcMismatchError(
                f"record batch CRC mismatch at offset {base_offset}",
                base_offset=base_offset,
                span=(pos, end),
                claimed_end=claimed_end,
                num_records=num_records,
                crc_expected=crc,
                crc_actual=actual,
            )
    if attributes & 0x20:
        # Control batch (transaction commit/abort markers): consumers
        # never see these as messages — librdkafka filters them at any
        # isolation level — but their offsets ARE part of the log, so
        # the frame still advances the covered range.
        return BatchFrame(
            base_offset,
            first_ts,
            0,
            b"",
            end_offset=claimed_end,
            byte_start=pos,
            byte_end=end,
            leader_epoch=leader_epoch,
        )
    codec = attributes & 0x07
    if codec != COMPRESSION_NONE:
        try:
            payload = _decompress(codec, payload)
        except Exception as e:
            # Unknown codec or corrupt codec stream: classify so callers
            # (and the CLI) report one clean line — or skip/quarantine.
            raise BadCompressionError(
                f"record batch at offset {base_offset}: {e}",
                base_offset=base_offset,
                span=(pos, end),
                claimed_end=claimed_end,
                num_records=num_records,
            ) from e
    return BatchFrame(
        base_offset,
        first_ts,
        num_records,
        payload,
        end_offset=claimed_end,
        byte_start=pos,
        byte_end=end,
        leader_epoch=leader_epoch,
    )


def _plausible_frame_at(buf, q: int, n: int, verify_crc: bool) -> bool:
    """Is ``q`` a believable frame boundary?  Structural checks always;
    with ``verify_crc`` the candidate's checksum must also pass, so a
    resync cannot lock onto bytes that merely look like a header."""
    base = struct.unpack_from(">q", buf, q)[0]
    if base < 0:
        return False
    blen = struct.unpack_from(">i", buf, q + 8)[0]
    end = q + 12 + blen
    magic = buf[q + 16]
    if magic == 2:
        if blen < _MIN_V2_BATCH_LENGTH or end > n:
            return False
        if verify_crc:
            crc = struct.unpack_from(">I", buf, q + 17)[0]
            return _crc32c(buf[q + 21 : end]) == crc
        return True
    if magic in (0, 1):
        if blen < _MIN_LEGACY_MESSAGE_SIZE or end > n:
            return False
        if verify_crc:
            crc = struct.unpack_from(">I", buf, q + 12)[0]
            return zlib.crc32(buf[q + 16 : end]) == crc
        return True
    return False


def _resync(buf, pos: int, n: int, verify_crc: bool) -> "Tuple[int, int]":
    """Scan forward from a poisoned position for the next plausible frame
    boundary: (resync_byte, resume_offset).  (n, -1) when the rest of the
    buffer yields nothing — the caller then skips to the buffer end."""
    q = pos + 1
    while q + 17 <= n:
        if buf[q + 16] in (0, 1, 2) and _plausible_frame_at(
            buf, q, n, verify_crc
        ):
            return q, struct.unpack_from(">q", buf, q)[0]
        q += 1
    return n, -1


def _iter_frames(
    buf: bytes, verify_crc: bool, salvage: bool
) -> "Iterator[BatchFrame | CorruptSpan]":
    pos = 0
    n = len(buf)
    while pos + 17 <= n:  # base_offset + batch_length + leader_epoch + magic
        batch_length = struct.unpack_from(">i", buf, pos + 8)[0]
        end = pos + 12 + batch_length
        err: Optional[CorruptFrameError] = None
        frame: Optional[BatchFrame] = None
        magic = buf[pos + 16]
        min_len = (
            _MIN_LEGACY_MESSAGE_SIZE if magic in (0, 1)
            else _MIN_V2_BATCH_LENGTH
        )
        if batch_length <= 0:
            # A non-positive length is never a broker's byte-limit
            # truncation — silently stopping here would drop every frame
            # after it in the fetch response.
            err = MalformedHeaderError(
                f"non-positive batch length {batch_length} at record-set "
                f"byte {pos}",
                base_offset=struct.unpack_from(">q", buf, pos)[0],
            )
        elif magic in (0, 1, 2) and batch_length < min_len:
            # A positive length too small to hold the format's own header
            # is corruption, not truncation — and it must be rejected
            # BEFORE parsing, or the header reader would run past the
            # frame's declared end into the next frame's bytes (an
            # unclassified overrun at the buffer tail, silent garbage
            # fields mid-buffer).  The length field itself is suspect, so
            # the salvage skip re-syncs (span=None) instead of trusting it.
            err = MalformedHeaderError(
                f"batch length {batch_length} below the magic-{magic} "
                f"minimum size ({min_len}) at record-set byte {pos}",
                base_offset=struct.unpack_from(">q", buf, pos)[0],
            )
        elif end > n:
            return  # partial trailing batch (broker truncates at max_bytes)
        else:
            try:
                frame = _parse_frame_at(buf, pos, end, verify_crc)
            except CorruptFrameError as e:
                err = e
        if err is None:
            if frame is not None:
                yield frame
            pos = end
            continue
        if not salvage:
            raise err
        if err.span is not None:
            # The frame's bounds were readable: skip exactly this frame
            # using its length prefix — frames after it still decode.
            span_end = err.span[1]
            resume_q, resume_off = span_end, -1
            if span_end + 17 <= n:
                if _plausible_frame_at(buf, span_end, n, verify_crc):
                    # A validated boundary: its base offset is trustworthy.
                    resume_off = struct.unpack_from(">q", buf, span_end)[0]
                else:
                    blen_next = struct.unpack_from(">i", buf, span_end + 8)[0]
                    if blen_next > 0 and span_end + 12 + blen_next > n:
                        # Looks like the broker's trailing partial batch:
                        # stop at span_end, but offer NO resume offset —
                        # these bytes failed the plausibility check, so an
                        # i64 read from them would be arbitrary garbage.
                        pass
                    else:
                        # The claimed length lands on implausible bytes
                        # (the length field itself may be the corrupt
                        # part): fall back to the scan.
                        resume_q, resume_off = _resync(
                            buf, pos, n, verify_crc
                        )
        else:
            resume_q, resume_off = _resync(buf, pos, n, verify_crc)
        yield CorruptSpan(
            error=err,
            start=pos,
            end=resume_q,
            base_offset=err.base_offset,
            claimed_end=err.claimed_end,
            resume_offset=resume_off,
            num_records=err.num_records,
        )
        pos = max(resume_q, pos + 1)


def iter_batch_frames(buf: bytes, verify_crc: bool = False) -> Iterator[BatchFrame]:
    """Parse batch headers (CRC check, decompression) without touching
    records.  Tolerates a trailing partial batch (brokers may truncate at
    max_bytes).  Legacy MessageSet v0/v1 entries (pre-0.11 segments that
    survive on upgraded clusters) are decoded eagerly into
    ``legacy_records`` — the magic byte sits at entry offset 16 in all
    three formats, so mixed-format record sets stream through one loop.
    Corrupt frames raise a classified `CorruptFrameError`; use
    `salvage_batch_frames` to skip them instead."""
    for item in _iter_frames(buf, verify_crc, salvage=False):
        yield item  # salvage=False never yields CorruptSpan


def salvage_batch_frames(
    buf: bytes, verify_crc: bool = False
) -> "Iterator[BatchFrame | CorruptSpan]":
    """Like `iter_batch_frames`, but poisoned frames are isolated instead
    of raising: the stream yields a `CorruptSpan` for each and resumes at
    the next batch boundary.  A frame whose length prefix is intact is
    skipped exactly (payload-level damage: CRC mismatch, bad codec
    stream); when the header itself is mangled, the iterator re-syncs by
    scanning for the next plausible frame header (CRC-checked when
    ``verify_crc``, structural checks otherwise)."""
    return _iter_frames(buf, verify_crc, salvage=True)


def decode_frame_records(frame: BatchFrame) -> Iterator[Tuple[int, RecordTuple]]:
    """Per-record Python decode of one frame (reference implementation; the
    hot path uses the native array decoder).  Record-body damage — only
    reachable when the batch CRC wasn't verified or didn't cover it —
    raises classified `CorruptFrameError` subtypes carrying the frame's
    byte span, so the wire layer's skip/quarantine policy applies to
    payload corruption exactly like header corruption."""
    if frame.legacy_records is not None:
        for off, ts_ms, key, value in frame.legacy_records:
            yield off, (ts_ms, key, value)
        return
    payload = frame.payload
    rr = ByteReader(payload)
    try:
        for _ in range(frame.num_records):
            length = rr.varint()
            rec_end = rr.pos + length
            # A negative declared length would walk the reader backwards
            # (negative positions slice "successfully" in Python).
            if length < 0 or rec_end > len(payload):
                cls = MalformedHeaderError if length < 0 else TruncatedFrameError
                raise cls(
                    f"record length {length} out of range at offset "
                    f"{frame.base_offset}",
                    base_offset=frame.base_offset,
                    span=_frame_span(frame),
                    claimed_end=frame.end_offset,
                    num_records=frame.num_records,
                )
            rr.i8()  # attributes
            ts_delta = rr.varint()
            off_delta = rr.varint()
            key = rr.varbytes()
            value = rr.varbytes()
            nheaders = rr.varint()
            for _ in range(nheaders):
                hk = rr.varbytes()
                rr.varbytes()
                del hk
            rr.pos = rec_end  # tolerate unknown trailing record fields
            yield frame.base_offset + off_delta, (frame.first_ts + ts_delta, key, value)
    except CorruptFrameError:
        raise
    except KafkaProtocolError as e:
        # ByteReader overruns (truncated varint/field) inside a record body.
        raise TruncatedFrameError(
            f"corrupt record body in batch at offset {frame.base_offset}: {e}",
            base_offset=frame.base_offset,
            span=_frame_span(frame),
            claimed_end=frame.end_offset,
            num_records=frame.num_records,
        ) from e


def _frame_span(frame: BatchFrame) -> "Optional[Tuple[int, int]]":
    if frame.byte_start < 0 or frame.byte_end < 0:
        return None
    return (frame.byte_start, frame.byte_end)


def decode_record_batches(
    buf: bytes, verify_crc: bool = False
) -> Iterator[Tuple[int, RecordTuple]]:
    """Yield (absolute_offset, (timestamp_ms, key, value)) for every record."""
    for frame in iter_batch_frames(buf, verify_crc):
        yield from decode_frame_records(frame)
