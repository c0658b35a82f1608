"""Where a topic's ``.ktaseg`` chunks live and how to find them (port of
the reference's ``io/segstore.py``, its local tier).

- `SegmentStore`: the two operations a scan needs, enumerate a topic's
  chunks (`list_refs`) and open one (`open`).  `DirectorySegmentStore` is
  a local directory of memory-mapped files; `open_segment_store` makes one
  from ``--segment-dir`` (a path or ``file://`` path).  Remote stores
  (``http(s)://``, ``s3://``) are not yet ported and are refused.
- `SegmentCatalog`: one topic's chunks, validated: each header's
  partition matches its file name, a partition's chunks are ordered by
  start offset and must not overlap.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import re
from typing import TYPE_CHECKING, Dict, List, Tuple

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

if TYPE_CHECKING:  # segfile imports this module
    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFile


def topic_chunk_pattern(topic: str) -> "re.Pattern[str]":
    """Exact match on ``{topic}-{int}[.c{int}].ktaseg``: a prefix match
    would also take the segments of a topic named ``{topic}-extra``."""
    return re.compile(rf"^{re.escape(topic)}-(\d+)(?:\.c\d+)?\.ktaseg$")


@dataclasses.dataclass(frozen=True)
class SegmentRef:
    """One chunk in a store, before it is opened."""

    #: Store-relative name, e.g. ``orders-3.c12.ktaseg``.
    name: str
    #: Partition id parsed from the name (checked against the header).
    partition: int
    #: Size in bytes.
    size: int


class SegmentStore(abc.ABC):
    """A collection of ``.ktaseg`` chunks."""

    @abc.abstractmethod
    def list_refs(self, topic: str) -> List[SegmentRef]:
        """All chunks of ``topic``, sorted by name."""

    @abc.abstractmethod
    def open(self, ref: SegmentRef) -> "SegmentFile":
        """Open one chunk for reading."""

    @abc.abstractmethod
    def describe(self) -> str:
        """Where the store is, for messages."""


class DirectorySegmentStore(SegmentStore):
    """A local directory of ``.ktaseg`` files (what ``tools/make_segments``
    writes)."""

    def __init__(self, directory: str):
        self.directory = directory

    def list_refs(self, topic: str) -> List[SegmentRef]:
        pattern = topic_chunk_pattern(topic)
        refs = []
        for fname in sorted(os.listdir(self.directory)):
            m = pattern.match(fname)
            if m:
                refs.append(SegmentRef(
                    name=fname,
                    partition=int(m.group(1)),
                    size=os.path.getsize(os.path.join(self.directory, fname)),
                ))
        return refs

    def open(self, ref: SegmentRef) -> "SegmentFile":
        from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFile

        return SegmentFile(os.path.join(self.directory, ref.name))

    def describe(self) -> str:
        return self.directory


#: Schemes of the reference's remote tier, which the port refuses.
REMOTE_SCHEMES = ("http", "https", "s3")


def open_segment_store(spec: str) -> SegmentStore:
    """The store of ``--segment-dir``: a plain path or ``file://`` path is
    a local directory.  A remote spec raises: the remote tier is not yet
    ported, and the port never reads something else in its place."""
    m = re.match(r"^([a-z][a-z0-9+.-]*)://", spec)
    scheme = m.group(1) if m else None
    if scheme in REMOTE_SCHEMES:
        raise ValueError(
            f"remote segment stores are not yet ported ({spec!r}): the "
            "port reads a local directory of .ktaseg files (a plain path "
            "or file://DIR)"
        )
    if m and scheme != "file":
        raise ValueError(
            f"segment store scheme {scheme!r} is not supported (supported: "
            "a plain directory path, file://)"
        )
    path = spec[len("file://"):] if m else spec
    if not os.path.isdir(path):
        raise ValueError(f"segment store {spec!r} is not a directory")
    return DirectorySegmentStore(path)


class SegmentCatalog:
    """One topic's validated chunks in a store.

    Opens every chunk (header and column map; pages fault in only as
    batches read them), checks each header's partition against its file
    name, orders each partition's chunks by start offset and rejects
    overlapping chunks (stale files of an older dump would otherwise merge
    old and new records)."""

    def __init__(self, store: SegmentStore, topic: str):
        from kafka_topic_analyzer_tpu_torch.io.segfile import MalformedSegmentError

        self.store = store
        self.topic = topic
        self.segments: "Dict[int, List[SegmentFile]]" = {}
        self.num_files = 0
        self.total_bytes = 0
        for ref in store.list_refs(topic):
            seg = store.open(ref)
            if seg.partition != ref.partition:
                raise MalformedSegmentError(
                    f"{ref.name}: header partition {seg.partition} does "
                    f"not match filename",
                    path=ref.name,
                    partition=ref.partition,
                )
            self.segments.setdefault(seg.partition, []).append(seg)
            self.num_files += 1
            self.total_bytes += ref.size
        for p, chunks in self.segments.items():
            chunks.sort(key=lambda s: s.start_offset)
            for prev, nxt in zip(chunks, chunks[1:]):
                if nxt.start_offset < prev.end_offset:
                    raise MalformedSegmentError(
                        f"overlapping segment chunks for partition {p}: "
                        f"{os.path.basename(prev.path)} ends at "
                        f"{prev.end_offset} but "
                        f"{os.path.basename(nxt.path)} starts at "
                        f"{nxt.start_offset} — stale chunks from an older "
                        "dump?",
                        path=os.path.basename(nxt.path),
                        partition=p,
                    )
        obs_metrics.SEGMENT_FILES_OPENED.inc(self.num_files)
        obs_metrics.SEGMENT_BYTES_MAPPED.inc(self.total_bytes)

    def partitions(self) -> List[int]:
        return sorted(self.segments)

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        start = {p: c[0].start_offset for p, c in self.segments.items()}
        end = {p: c[-1].end_offset for p, c in self.segments.items()}
        return start, end

    def record_counts(self) -> Dict[int, int]:
        """Records per partition, known up front from the headers."""
        return {
            p: sum(s.count for s in chunks)
            for p, chunks in self.segments.items()
        }
