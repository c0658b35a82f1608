"""Partition-sharded parallel ingest for one scan (port of the reference's
``parallel/ingest.py``, its single-device part).

One ingest stream (fetch or read, decode, pack, start the copy to the
device) caps a scan at one host core: every 16M-record scan on the card
waits on that stream while the device idles.  The native shim releases
the GIL, so more streams are more threads, not faster ones.  This module
runs N of them inside one scan:

- the partition set is sharded into N disjoint groups
  (``shard_partitions``: the round-robin rule of `parallel.mesh.
  assign_partitions`; cold sources whose catalogs know exact
  per-partition record counts pass ``weights`` and get a deterministic
  greedy-LPT balance instead);
- each group gets a private ``source.batches()`` stream on its own worker
  thread (the wire layer keeps connections private per stream, so
  workers never share a socket), which also stages its items: a decoded
  batch goes through ``stage`` (the backend's ``prepare``), a fused sink
  (one per worker, from ``sink_factory``) yields rows already staged.
  The torch backend gives each staging thread and each sink its own ring
  of pinned slots, so no slot is reachable from two threads;
- workers push ``(batch, staged)`` pairs into bounded per-worker queues
  (backpressure = queue depth, the prefetch contract's depth);
- the consuming thread merges the queues in a DETERMINISTIC round-robin
  order (worker 0, 1, ..., N-1, 0, ... — exhausted workers drop out of the
  rotation).

Why the merge can be any fixed order at all: every fold the backend runs is
associative and commutative ACROSS partitions (counters add, min/max and
HLL registers merge by max, DDSketch rows add), and last-writer-wins
alive-key tracking is order-sensitive within a partition, whose records
all travel in one worker's stream in offset order.  Checkpoints stay
fold-consistent per partition (each partition lives in exactly one
worker, ``next_offset`` semantics unchanged), and the fault and
corruption policies compose per worker: degraded, corrupt and lost
partitions aggregate on the shared source.  One caveat the reference
shares: the alive bitmap's slot is the key's fnv32 alone, so keys of
different partitions that share a slot make the alive-key count depend
on the merge order.  That order is a pure function of the inputs, so an
N-worker scan equals the reference's N-worker scan byte for byte, and
equals the 1-worker scan whenever no slot is written from two partitions.

Thread-safety rule for this module: worker code paths (anything that
runs on an ``_IngestWorker`` thread) never mutate scan-shared dict, list
or set state without holding a lock — shared mutable state is either
confined to the consumer thread (the merge loop) or crosses threads only
through the per-worker ``queue.Queue``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.packing import PackedRow
from kafka_topic_analyzer_tpu_torch.parallel.mesh import assign_partitions
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

_SENTINEL = object()


class _Error:
    """Exception envelope (as in utils/prefetch.py): raised on the
    consumer side at the failed worker's position in the rotation."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def shard_partitions(
    partitions: List[int],
    workers: int,
    weights: "Optional[Dict[int, int]]" = None,
) -> List[List[int]]:
    """Disjoint partition groups, one per worker.

    Without ``weights``: round-robin, literally `parallel.mesh.
    assign_partitions`.

    With ``weights`` (partition -> expected records; the segment-file
    catalog knows these exactly — `SegmentFileSource.
    partition_record_counts`): deterministic greedy LPT — partitions
    descend by weight (ties by id) onto the least-loaded group (ties by
    group index), so a skewed catalog doesn't leave workers idle behind
    one hot partition.  The grouping stays a pure function of the inputs.

    Empty groups are dropped (callers clamp ``workers`` to the partition
    count first, but a caller that does not must still get only live
    workers)."""
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if weights:
        loads = [0] * workers
        groups: "List[List[int]]" = [[] for _ in range(workers)]
        for p in sorted(partitions, key=lambda p: (-weights.get(p, 0), p)):
            w = min(range(workers), key=lambda i: (loads[i], i))
            groups[w].append(p)
            loads[w] += weights.get(p, 0)
        # Offset order within a worker's stream is per partition either
        # way; ascending ids keep the group layout readable in --stats.
        return [sorted(g) for g in groups if g]
    return [g for g in assign_partitions(partitions, workers) if g]


def allocate_row_workers(
    budget: int, row_counts: "Dict[int, int]"
) -> "Dict[int, int]":
    """Split an ingest-worker budget across rows (``row_counts``: row ->
    partition count): every non-empty row gets 1 even when ``budget`` is
    smaller, and the rest goes one worker at a time to the row with the
    most partitions per worker (ties by row index), clamped at the row's
    partition count — a worker beyond it would own an empty group.  A
    pure function of its inputs.  The fleet scheduler splits the global
    worker budget across an admitted wave of topic scans with it
    (fleet/scheduler.py)."""
    if budget < 1:
        raise ValueError("worker budget must be >= 1")
    alloc = {r: (1 if n > 0 else 0) for r, n in row_counts.items()}
    spent = sum(alloc.values())
    while spent < budget:
        best = None
        for r in sorted(row_counts):
            n, w = row_counts[r], alloc[r]
            if w == 0 or w >= n:
                continue
            ratio = n / w
            if best is None or ratio > best[0]:
                best = (ratio, r)
        if best is None:
            break  # every row saturated at its partition count
        alloc[best[1]] += 1
        spent += 1
    return alloc


class _IngestWorker(threading.Thread):
    """One worker: a private ``source.batches()`` stream for one partition
    group, staged on this thread, fed into a bounded queue.  Mirrors the
    prefetch contract: errors travel to the consumer as `_Error`,
    exhaustion as a sentinel, and close-on-exit drains the thread AND
    closes the underlying generator."""

    def __init__(
        self,
        wid: str,
        source: RecordSource,
        batch_size: int,
        group: List[int],
        start_at: "Optional[Dict[int, int]]",
        stage: "Optional[Callable[[RecordBatch], object]]",
        depth: int,
        cancel: threading.Event,
        sink=None,
    ):
        super().__init__(daemon=True, name=f"kta-ingest-{wid}")
        self.wid = wid
        self.group = list(group)
        self.queue: "queue.Queue[object]" = queue.Queue(maxsize=max(depth, 1))
        self._stage = stage
        self._cancel = cancel
        # The generator object is created here (cheap — the body only runs
        # on first next()) so close() can reach it even if the thread never
        # gets scheduled; only this thread ever *advances* it.  A fused
        # sink (private to this worker: a sink is single-threaded state)
        # makes the stream yield packed, staged PackedRow items, for which
        # `stage` never runs.
        self._it = source.batches(
            batch_size, partitions=self.group, start_at=start_at,
            **({"sink": sink} if sink is not None else {}),
        )
        self._source_closed = False
        self._stall = obs_metrics.INGEST_WORKER_STALL_SECONDS.labels(worker=wid)
        self._active = obs_metrics.INGEST_WORKER_ACTIVE_SECONDS.labels(worker=wid)

    def _put(self, item: object) -> bool:
        """Bounded put; gives up when the consumer cancelled.  Time spent
        blocked on a full queue is the worker's backpressure stall, booked
        per worker so ``--stats`` and Prometheus show which shard outruns
        the device."""
        if self._cancel.is_set():
            # Checked before the fast path: an aborting close() drains the
            # queues, and a cancelled worker must not slip items into the
            # fresh space and keep fetching and staging dead work.
            return False
        try:
            self.queue.put_nowait(item)
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter()
        try:
            while not self._cancel.is_set():
                try:
                    self.queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            self._stall.inc(time.perf_counter() - t0)

    def run(self) -> None:
        # Lifetime booking brackets the whole stream, the final put of the
        # sentinel (or the error) included: every stall lies inside the
        # active window, so busy fraction = (active - stall) / active
        # stays in [0, 1] for workers whose partitions drain early
        # (obs/doctor.py reads both counters).
        t_run = time.perf_counter()
        try:
            for batch in self._it:
                if isinstance(batch, PackedRow):
                    staged = batch.staged  # fused: staged by the sink
                else:
                    staged = (
                        self._stage(batch) if self._stage is not None else None
                    )
                if not self._put((batch, staged)):
                    return  # cancelled; finally closes the source stream
            self._put(_SENTINEL)
        except BaseException as e:
            self._put(_Error(e))
        finally:
            self._active.inc(time.perf_counter() - t_run)
            if self._cancel.is_set():
                self.close_source()

    def close_source(self) -> None:
        """Close the underlying batches() generator (GeneratorExit unwinds
        its finally blocks, releasing the stream's private connections).
        Called from the owning thread on cancel, or from ``close()`` after
        the thread has exited (a generator can only be closed while no
        thread is executing it)."""
        if self._source_closed:
            return
        self._source_closed = True
        close = getattr(self._it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # a dying stream must not mask the real error
                pass


class ParallelIngest:
    """Fan-in over N ingest workers with a deterministic round-robin merge.

    Iterating yields ``(batch, staged)`` exactly like the staged prefetch
    stream the single-worker path consumes, so the engine's bookkeeping
    loop is the same for N=1 and N>1.  ``close()`` mirrors the prefetch
    close-on-exit contract: cancel, drain, join, and release every
    worker's underlying stream — the engine calls it from its ``finally``
    so errors and interrupts never leak threads or connections.
    """

    def __init__(
        self,
        source: RecordSource,
        batch_size: int,
        groups: List[List[int]],
        start_at: "Optional[Dict[int, int]]" = None,
        stage: "Optional[Callable[[RecordBatch], object]]" = None,
        depth: int = 2,
        sink_factory: "Optional[Callable[[], object]]" = None,
        wid_base: int = 0,
        label_prefix: str = "",
    ):
        """``wid_base`` numbers the workers from there on: a mesh scan
        runs one fan-in per data row (engine.py), and the worker labels of
        its pools must stay disjoint; ``label_prefix`` (the controller,
        ``"c1."``, under several) keeps them apart across processes."""
        if not groups:
            raise ValueError("parallel ingest needs at least one group")
        self._cancel = threading.Event()
        self.workers = [
            _IngestWorker(
                f"{label_prefix}{wid_base + w}", source, batch_size, g,
                start_at, stage, depth,
                self._cancel,
                sink=sink_factory() if sink_factory is not None else None,
            )
            for w, g in enumerate(groups)
        ]
        self._depth_gauge = obs_metrics.INGEST_QUEUE_DEPTH.labels(
            pool=f"{label_prefix}{wid_base}"
        )
        #: Rotation position and per-worker liveness for the merge.
        self._rr = 0
        self._alive = [True] * len(self.workers)
        self._alive_count = len(self.workers)
        self._closed = False
        for w in self.workers:
            w.start()

    def __iter__(self) -> "ParallelIngest":
        return self

    def __next__(self) -> "Tuple[RecordBatch | PackedRow, object]":
        # Deterministic rotation: always poll workers in index order,
        # blocking on each worker's own queue until it produces or
        # finishes.  Given deterministic per-worker streams this makes the
        # merged fold order a pure function of the inputs.
        while self._alive_count:
            w = self.workers[self._rr]
            if not self._alive[self._rr]:
                self._rr = (self._rr + 1) % len(self.workers)
                continue
            item = w.queue.get()
            if item is _SENTINEL:
                self._alive[self._rr] = False
                self._alive_count -= 1
                self._rr = (self._rr + 1) % len(self.workers)
                continue
            if isinstance(item, _Error):
                # One worker died: the scan aborts (the engine's failure
                # path snapshots committed progress and its finally calls
                # close(), cancelling the surviving workers).
                self._alive[self._rr] = False
                self._alive_count -= 1
                raise item.exc
            self._rr = (self._rr + 1) % len(self.workers)
            batch, staged = item
            obs_metrics.INGEST_WORKER_RECORDS.labels(worker=w.wid).inc(
                batch.num_valid
            )
            self._depth_gauge.set(self.queue_depth())
            return batch, staged
        raise StopIteration

    def queue_depth(self) -> int:
        """Total staged batches waiting in the fan-in (all workers)."""
        return sum(w.queue.qsize() for w in self.workers)

    def close(self) -> None:
        """Stop every worker and release their streams.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._cancel.set()
        # Drain so blocked workers observe the cancel promptly (their puts
        # poll the event between bounded-put timeouts).
        for w in self.workers:
            try:
                while True:
                    w.queue.get_nowait()
            except queue.Empty:
                pass
        # One shared deadline across all joins: N workers blocked in
        # broker I/O must cost ~5 s of shutdown latency in total, not N x 5 s.
        deadline = time.monotonic() + 5.0
        for w in self.workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
        for w in self.workers:
            if not w.is_alive():
                # The thread exited without running its cancel-path close
                # (error, exhaustion, or cancel won the race after the
                # loop): close the generator from here — safe now that no
                # thread is executing it.
                w.close_source()
        self._depth_gauge.set(0)


def iter_staged(
    it: "Iterator[RecordBatch | PackedRow]",
    stage: "Optional[Callable[[RecordBatch], object]]",
) -> "Iterator[Tuple[RecordBatch | PackedRow, object]]":
    """Single-worker staging adapter: the same ``(item, staged)`` shape
    `ParallelIngest` yields, staged on the thread that iterates: a
    `RecordBatch` goes through ``stage``; a `PackedRow` arrives staged by
    its sink."""
    for b in it:
        if isinstance(b, PackedRow):
            yield b, b.staged
        else:
            yield b, (stage(b) if stage is not None else None)
