"""Segment catalog/fetch layer: where .ktaseg chunks live, how to find them
(port of the reference's ``io/segstore.py``).

The cold scan path (``--source segfile``) is tiered-storage-shaped: a
topic's retained history is a set of immutable segment chunks in *some*
store — a local directory today, an object store (S3/GCS) bucket later —
and the scan needs exactly two operations against it: enumerate a topic's
chunks and open one for reading.  This module is that seam:

- `SegmentStore` — the two-method fetch interface (`list_refs`, `open`).
  `DirectorySegmentStore` is the local tier (memory-mapped files);
  `ObjectSegmentStore` is the remote tier (DESIGN.md §21): an S3-shaped
  HTTP client (LIST + ranged GET via io/objstore.py's retry-budget
  transport) whose catalog validation runs off ranged HEADER probes —
  never a chunk body — and whose chunk bodies arrive lazily through the
  process-wide fetch scheduler (io/fetchsched.py) and the sha256-verified
  local cache.
  `open_segment_store` is the factory: plain paths and ``file://`` are
  local, ``http(s)://`` / ``s3://`` are remote.
- `SegmentCatalog` — a validated view of one topic's chunks: header↔name
  consistency, per-partition chunk ordering by start offset, overlap
  rejection, and the per-partition record counts the parallel cold path
  uses to balance its workers (segments are disjoint offset ranges, so
  sharding *by partition* keeps the parallel-ingest determinism argument — each
  partition's chunks live in exactly one worker, in offset order).

Opening a catalog books the ``kta_segment_*`` telemetry (files opened,
bytes mapped) so the ``--stats``/``--json`` cold-path digest can report
what the scan actually touched.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import re
import struct
from typing import TYPE_CHECKING, Dict, List, Tuple

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

if TYPE_CHECKING:  # circular at runtime: segfile imports this module
    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFile


def topic_chunk_pattern(topic: str) -> "re.Pattern[str]":
    """Exact match on ``{topic}-{int}[.c{int}].ktaseg``: a prefix match
    would also swallow segments of topics like ``{topic}-extra``."""
    return re.compile(rf"^{re.escape(topic)}-(\d+)(?:\.c\d+)?\.ktaseg$")


@dataclasses.dataclass(frozen=True)
class SegmentRef:
    """One enumerable chunk in a store, before it is opened."""

    #: Store-relative name, e.g. ``orders-3.c12.ktaseg``.
    name: str
    #: Partition id parsed from the name (the catalog cross-checks it
    #: against the opened header).
    partition: int
    #: Chunk size in bytes (telemetry + the reader's truncation check).
    size: int


class SegmentStore(abc.ABC):
    """Minimal fetch interface over a collection of .ktaseg chunks."""

    @abc.abstractmethod
    def list_refs(self, topic: str) -> List[SegmentRef]:
        """All chunks belonging to ``topic``, name-sorted."""

    @abc.abstractmethod
    def open(self, ref: SegmentRef) -> "SegmentFile":
        """Open one chunk for reading (memory-mapped for local stores)."""

    @abc.abstractmethod
    def describe(self) -> str:
        """Human-readable location, for error messages and logs."""


class DirectorySegmentStore(SegmentStore):
    """The local store: a directory of ``.ktaseg`` files (what
    ``--dump-segments`` and ``tools/make_segments`` produce)."""

    def __init__(self, directory: str):
        self.directory = directory

    def list_refs(self, topic: str) -> List[SegmentRef]:
        pattern = topic_chunk_pattern(topic)
        refs = []
        for fname in sorted(os.listdir(self.directory)):
            m = pattern.match(fname)
            if not m:
                continue
            refs.append(
                SegmentRef(
                    name=fname,
                    partition=int(m.group(1)),
                    size=os.path.getsize(os.path.join(self.directory, fname)),
                )
            )
        return refs

    def open(self, ref: SegmentRef) -> "SegmentFile":
        from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFile

        return SegmentFile(os.path.join(self.directory, ref.name))

    def describe(self) -> str:
        return self.directory


class ObjectSegmentStore(SegmentStore):
    """The remote tier: chunks in an S3-shaped object store, addressed by
    ``http(s)://host[:port]/bucket[/prefix]`` or ``s3://bucket[/prefix]``.

    Enumeration is one ListObjectsV2-shaped request; opening a ref costs
    a ranged HEADER probe (plus, for gappy chunks, an 8-byte suffix probe
    for the offset-exact end watermark) — catalog validation never
    downloads a chunk body.  Bodies arrive through `fetch_chunk`:
    sha256-verified local cache first (``--segment-cache``), then a
    budget-retried GET whose bytes are classified with the local reader's
    exact corruption taxonomy; a classification failure is re-fetched
    ONCE to rule out an in-flight flip (io/kafka_wire.py's rule) before
    it counts as at-rest corruption.
    """

    #: The source resolves ``--segment-readahead auto`` against this.
    is_remote = True

    def __init__(self, spec: str, fetch=None):
        from kafka_topic_analyzer_tpu_torch.config import SegmentFetchConfig
        from kafka_topic_analyzer_tpu_torch.io.objstore import (
            RetryingHttp,
            SegmentCache,
        )

        fetch = fetch if fetch is not None else SegmentFetchConfig()
        self.spec = spec.rstrip("/")
        self.transport = RetryingHttp(self.spec, fetch)
        self.cache = (
            SegmentCache(fetch.cache_dir, fetch.cache_max_bytes, self.spec)
            if fetch.cache_dir
            else None
        )

    def list_refs(self, topic: str) -> List[SegmentRef]:
        pattern = topic_chunk_pattern(topic)
        refs = []
        for name, size in sorted(self.transport.list_objects(f"{topic}-")):
            m = pattern.match(name)
            if not m:
                continue
            refs.append(
                SegmentRef(name=name, partition=int(m.group(1)), size=size)
            )
        return refs

    def open(self, ref: SegmentRef) -> "SegmentFile":
        from kafka_topic_analyzer_tpu_torch.io.segfile import (
            FLAG_OFFSETS,
            HEADER_SIZE,
            RemoteSegmentFile,
            parse_segment_header,
        )

        path = self.transport.object_path(ref.name)
        # Catalog probes deliberately carry NO partition: a store that is
        # unreachable at SETUP time fails the scan cleanly (after the
        # same attempt budget) rather than silently dropping partitions
        # from the catalog — the degraded surface only covers partitions
        # the scan actually admitted (body fetches, during batches()).
        whole = None
        if self.transport.range_ignored:
            # This server answers every ranged GET with the full object
            # (latched on first detection): issue ONE whole-object GET
            # per chunk and slice the header/tail probes locally, instead
            # of downloading the full object once per probe.  The cache
            # absorbs the cost entirely when enabled — consulted before
            # the GET (a warm catalog open downloads nothing) and seeded
            # after it (the body fetch later is a verified hit, so the
            # chunk crosses the wire once per scan, not twice).
            if self.cache is not None:
                whole = self.cache.get(ref.name, ref.size)
            if whole is None:
                whole = self.transport.get(
                    path, kind="header", expect=ref.size
                )
                if self.cache is not None:
                    self.cache.put(ref.name, ref.size, whole)
            # bytes(), not a view: a cache hit is a memmap and the header
            # is stored for bytes-equality checks downstream.
            header = bytes(whole[: min(HEADER_SIZE, ref.size)])
        else:
            header = self.transport.get(
                path,
                rng=(0, HEADER_SIZE - 1),
                kind="header",
                expect=min(HEADER_SIZE, ref.size),
            )
        _p, flags, _start, count = parse_segment_header(
            header, f"{self.spec}/{ref.name}"
        )
        end_offset = None
        if flags & FLAG_OFFSETS and count > 0:
            # Gappy chunk: the offset-exact end watermark is the LAST
            # offsets entry — an 8-byte suffix probe, not a body download.
            if whole is not None:
                tail = bytes(whole[ref.size - 8 : ref.size])
            else:
                tail = self.transport.get(
                    path,
                    rng=(ref.size - 8, ref.size - 1),
                    kind="header",
                    expect=8,
                )
            end_offset = struct.unpack("<q", tail)[0] + 1

        def fetch_body(validate):
            return self.fetch_chunk(ref, validate)

        return RemoteSegmentFile(
            fetch_body, ref.name, self.spec, ref.size, header, end_offset
        )

    def open_all(self, refs: List[SegmentRef]) -> "List[SegmentFile]":
        """Open many refs with their header probes in flight concurrently
        (order-preserving).  An archived year is tens of thousands of
        chunks; serial round-trips would put a wire RTT in front of every
        one before the scan even starts.  The probes run as DEMAND
        requests on the process-wide fetch scheduler — the catalog no
        longer brings its own pool, so its burst shares (and is bounded
        by) the same ``--fetch-concurrency`` admission as every other
        remote byte."""
        if len(refs) <= 1:
            return [self.open(r) for r in refs]
        from kafka_topic_analyzer_tpu_torch.io.fetchsched import get_scheduler

        return get_scheduler().run_all(
            [lambda r=r: self.open(r) for r in refs]
        )

    def fetch_chunk(self, ref: SegmentRef, validate):
        """One whole verified chunk body (RemoteSegmentFile.ensure_body's
        acquisition path): cache hit (sha256-checked once per process,
        then latched; served as a zero-copy memmap view) → else a
        budget-retried GET (bytes), classified by ``validate`` with one
        disambiguating re-fetch, then written back to the cache."""
        from kafka_topic_analyzer_tpu_torch.io.segfile import CorruptSegmentError

        if self.cache is not None:
            data = self.cache.get(ref.name, ref.size)
            if data is not None:
                try:
                    validate(data)
                    return data
                except CorruptSegmentError:
                    # The entry matches its OWN sha256 sidecar (so it is
                    # not rot) but no longer matches what the catalog
                    # validated — the archive was re-dumped at the same
                    # name and size.  A stale entry is a miss, never an
                    # abort: evict, book, fetch fresh.
                    from kafka_topic_analyzer_tpu_torch.io.objstore import (
                        _book_fallback,
                    )

                    self.cache.evict(ref.name, ref.size)
                    _book_fallback("cache-stale")
        path = self.transport.object_path(ref.name)
        data = self.transport.get(
            path, kind="body", partition=ref.partition, expect=ref.size
        )
        try:
            validate(data)
        except CorruptSegmentError:
            # Structural classification failed.  The MD5/ETag check (when
            # the server sends one) already retried in-flight damage, but
            # not every endpoint ETags — ONE ranged re-fetch disambiguates:
            # identical bytes fail identically (at-rest corruption, the
            # classified error propagates); different bytes mean the first
            # copy was damaged in flight.  Mirrors io/kafka_wire.py's
            # one-re-fetch rule for suspect frames.
            obs_metrics.CORRUPT_REFETCHES.inc()
            data = self.transport.get(
                path, kind="refetch", partition=ref.partition,
                expect=ref.size,
            )
            validate(data)
        if self.cache is not None:
            self.cache.put(ref.name, ref.size, data)
        return data

    def describe(self) -> str:
        return self.spec


#: Schemes `open_segment_store` routes (a plain path means file://).
SUPPORTED_STORE_SCHEMES = ("file", "http", "https", "s3")


def open_segment_store(spec: str, fetch=None) -> SegmentStore:
    """Store factory for ``--segment-dir``: a plain path or ``file://``
    spec is a local directory; ``http(s)://host[:port]/bucket[/prefix]``
    and ``s3://bucket[/prefix]`` open the remote tier (`ObjectSegmentStore`
    — DESIGN.md §21).  ``fetch`` (config.SegmentFetchConfig) carries the
    read-ahead/cache/retry knobs; unknown schemes are rejected with the
    supported list and the plug-in seam named."""
    m = re.match(r"^([a-z][a-z0-9+.-]*)://", spec)
    scheme = m.group(1) if m else None
    if scheme in ("http", "https", "s3"):
        return ObjectSegmentStore(spec, fetch=fetch)
    if m and scheme != "file":
        supported = ", ".join(
            f"{s}://" for s in SUPPORTED_STORE_SCHEMES
        )
        raise ValueError(
            f"segment store scheme {scheme!r} is not supported "
            f"(supported: a plain directory path, {supported}); "
            "io/segstore.py SegmentStore is the plug-in seam for more"
        )
    if fetch is not None and fetch.cache_dir:
        raise ValueError(
            "--segment-cache only applies to remote segment stores "
            "(http://, https://, s3:// specs) — a local directory IS "
            "the cache"
        )
    path = spec[len("file://"):] if m else spec
    if not os.path.isdir(path):
        raise ValueError(f"segment store {spec!r} is not a directory")
    return DirectorySegmentStore(path)


class SegmentCatalog:
    """One topic's validated chunk layout in a store.

    Opens every chunk (header + column map; the local store mmaps lazily —
    pages fault in only as batches read them), cross-checks the header's
    partition against the filename, orders each partition's chunks by
    start offset, and rejects overlapping chunks (stale files from an
    older dump would silently merge old and new records).
    """

    def __init__(self, store: SegmentStore, topic: str):
        from kafka_topic_analyzer_tpu_torch.io.segfile import MalformedSegmentError

        self.store = store
        self.topic = topic
        self.segments: "Dict[int, List[SegmentFile]]" = {}
        self.num_files = 0
        self.total_bytes = 0
        refs = store.list_refs(topic)
        # Remote stores open refs concurrently (ObjectSegmentStore.open_all
        # — a header round-trip per chunk must not serialize over an
        # archived year's chunk count); order is preserved either way.
        opener = getattr(store, "open_all", None)
        segs = opener(refs) if opener is not None else [
            store.open(r) for r in refs
        ]
        for ref, seg in zip(refs, segs):
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
        """Per-partition retained record counts — known exactly up front
        (unlike a live topic), so the parallel cold path can balance its
        workers by records instead of partition count."""
        return {
            p: sum(s.count for s in chunks)
            for p, chunks in self.segments.items()
        }
