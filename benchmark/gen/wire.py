"""The Kafka protocol as the benchmark's broker speaks it: ApiVersions v0,
Metadata v1–v5, ListOffsets v1 and Fetch v4, all in the classic
(non-flexible) encoding, plus the request side of Fetch v4 and Metadata v1
for a plain consumer. A request header is flexible (it carries a tag
buffer) only for an ApiVersions request of version 3 or more, the one
flexible request a client may send before it knows the broker's versions.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
EARLIEST_TIMESTAMP = -2
LATEST_TIMESTAMP = -1
#: (api, min version, max version) the broker answers.
SUPPORTED = ((API_FETCH, 0, 4), (API_LIST_OFFSETS, 0, 1), (API_METADATA, 0, 5))


class Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def i8(self) -> int:
        return self._unpack(">b")

    def i16(self) -> int:
        return self._unpack(">h")

    def i32(self) -> int:
        return self._unpack(">i")

    def i64(self) -> int:
        return self._unpack(">q")

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        s = bytes(self.buf[self.pos:self.pos + n]).decode()
        self.pos += n
        return s

    def uvarint(self) -> int:
        shift = v = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def skip_tags(self) -> None:
        for _ in range(self.uvarint()):
            self.uvarint()
            self.pos += self.uvarint()


def string(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def decode_request_header(payload: bytes) -> Tuple[int, int, int, Reader]:
    r = Reader(payload)
    api_key, api_version, corr = r.i16(), r.i16(), r.i32()
    r.string()  # client id
    if api_key == API_VERSIONS and api_version >= 3:
        r.skip_tags()
    return api_key, api_version, corr, r


def encode_api_versions_response() -> bytes:
    out = struct.pack(">hi", 0, len(SUPPORTED))
    for key, vmin, vmax in SUPPORTED:
        out += struct.pack(">hhh", key, vmin, vmax)
    return out


def decode_metadata_request(r: Reader) -> List[str]:
    """The topics asked for; empty for all (a null or empty array)."""
    n = r.i32()
    return [r.string() or "" for _ in range(max(n, 0))]


def encode_metadata_response(
    brokers: "dict[int, tuple[str, int]]",
    topics: "list[tuple[int, str, list[tuple[int, int]]]]",
    version: int,
) -> bytes:
    """``topics``: (error, name, [(partition, leader), ...])."""
    out = b""
    if version >= 3:
        out += struct.pack(">i", 0)  # throttle_time_ms
    out += struct.pack(">i", len(brokers))
    for node, (host, port) in brokers.items():
        out += struct.pack(">i", node) + string(host) + struct.pack(">i", port) + string(None)
    if version >= 2:
        out += string(None)  # cluster_id
    out += struct.pack(">ii", 0, len(topics))  # controller_id, topics
    for err, name, parts in topics:
        out += struct.pack(">h", err) + string(name) + struct.pack(">bi", 0, len(parts))
        for pid, leader in parts:
            out += struct.pack(">hiiiiii", 0, pid, leader, 1, leader, 1, leader)
            if version >= 5:
                out += struct.pack(">i", 0)  # offline_replicas
    return out


def decode_list_offsets_request(r: Reader) -> Tuple[str, List[Tuple[int, int]]]:
    r.i32()  # replica_id
    if r.i32() != 1:
        raise ValueError("one topic per ListOffsets request")
    topic = r.string() or ""
    return topic, [(r.i32(), r.i64()) for _ in range(r.i32())]


def encode_list_offsets_response(topic: str, results: "list[tuple[int, int, int, int]]") -> bytes:
    """results: (partition, error, timestamp, offset)."""
    out = struct.pack(">i", 1) + string(topic) + struct.pack(">i", len(results))
    for pid, err, ts, off in results:
        out += struct.pack(">ihqq", pid, err, ts, off)
    return out


def decode_fetch_request(r: Reader):
    """(topic, [(partition, offset, partition_max_bytes)], max_bytes)."""
    r.i32()  # replica_id
    r.i32()  # max_wait_ms
    r.i32()  # min_bytes
    max_bytes = r.i32()
    r.i8()  # isolation level
    if r.i32() != 1:
        raise ValueError("one topic per Fetch request")
    topic = r.string() or ""
    parts = [(r.i32(), r.i64(), r.i32()) for _ in range(r.i32())]
    return topic, parts, max_bytes


# -- the consumer's side --------------------------------------------------------


def request(api_key: int, version: int, corr: int, body: bytes) -> bytes:
    payload = struct.pack(">hhi", api_key, version, corr) + string("bench-drain") + body
    return struct.pack(">i", len(payload)) + payload


def encode_fetch_request(topic: str, parts: "list[tuple[int, int]]",
                         max_bytes: int, partition_max_bytes: int) -> bytes:
    out = struct.pack(">iiiib", -1, 500, 1, max_bytes, 0)
    out += struct.pack(">i", 1) + string(topic) + struct.pack(">i", len(parts))
    for pid, off in parts:
        out += struct.pack(">iqi", pid, off, partition_max_bytes)
    return out


def decode_fetch_response(buf: bytes) -> "list[tuple[int, int, int, int]]":
    """Per partition: (partition, error, records_start, records_size),
    positions in ``buf`` (the response body after its correlation id)."""
    r = Reader(buf)
    r.i32()  # throttle_time_ms
    out = []
    for _ in range(r.i32()):
        r.string()
        for _ in range(r.i32()):
            pid, err = r.i32(), r.i16()
            r.i64()
            r.i64()
            for _ in range(max(r.i32(), 0)):
                r.i64()
                r.i64()
            size = r.i32()
            out.append((pid, err, r.pos, max(size, 0)))
            r.pos += max(size, 0)
    return out
