"""TorchBackend: the streaming reduction with its state resident on one
device (port of the reference's ``TpuBackend``, superbatch K >= 1).

Per batch:
- `prepare` packs the row (wire v5 or v4, per-row alive pairs inside it
  when compaction is off) and, under compaction, the batch's compacted
  alive-pair table straight into a pinned host buffer and starts ONE
  asynchronous host→device copy of both (numpy packers, or the native
  shim with ``use_native``);
- `make_fused_sink` gives a `packing.FusedPackSink` whose rows are packed
  straight into the same pinned slots; a completed row (and, under
  compaction, its pairs packed into the slot's pair region) leaves
  through the same single copy;
- `update` views the device bytes as typed tensors and folds them into the
  state (backends/step.py), launching the counter kernel of the row's wire
  format on CUDA (`counters_merge` for v5, `counters_update` for v4), then
  records a CUDA event behind the fold as its completion token in the
  launch-site `base.DispatchQueue` (``dispatch_depth`` folds in flight;
  the throttle's wait is the device's backpressure on the drive loop).
  The token is a timing event, and a second one is recorded before the
  fold's first launch: the queue books the fold's span on the device when
  it retires it.

At superbatch K > 1 (``--superbatch``) `update_superbatch` folds K staged
rows per dispatch: one throttle, the K folds in list order
(`step.superbatch_fold`: one counter-kernel launch per row), then, under
alive compaction, ONE pair table — the last-writer-wins merge of the K
rows' raw pairs, packed into a pinned `packing.SuperbatchStager` slot on
the main thread and copied up once — and one CUDA event.  Staging is K =
1's: every row still leaves its ingest stream's ring slot through its own
asynchronous copy, so a pending superbatch holds device rows and host
pair arrays, never a ring slot, and no slot can be rewritten while its
row waits for the flush (the reference stacks K host rows into one
transfer instead).  The pair table's capacity is the K-row one,
``min(K·B, 2^bits)``, which also picks its form (masks or list).  A
pair list is applied in place by `ops.bitmap.bitmap_apply_pairs` (one
atomic kernel launch on a card), which needs no buffer beside the bitmap.

Nothing synchronizes until `finalize` (or a snapshot's `get_state`) but
the two real waits — a ring slot whose copy is still in flight, and the
dispatch queue's throttle — so packing the next batch overlaps the
device's work on this one, on the main thread, on a prefetch worker or on
N parallel-ingest workers (engine.py): `prepare` and the sinks run on the
ingest threads while `update` runs on the main thread.  The step and
finalize times booked by `base.instrument_steps` are therefore host
time: enqueue plus those waits.

Everything the backend enqueues runs on the one stream it holds
(``self.stream``), whichever thread issues it: the construction's
self-check and state init, every copy and its event, the folds with both
counter kernels, the snapshot and finalize copies to the host.  By
default that is the creating thread's current stream (the solo scan's
legacy default stream); each of the fleet's topic backends leases a
stream of its own from the process's `StreamPool` (``pooled_stream``),
so the scans of concurrent topics are ordered only within themselves.
Every device tensor a backend makes is allocated on its stream and used
only there, so the caching allocator never hands a block still in use on
one stream to another.  `close` frees the state at once (a batch fleet's
topic pass has ended) and gives a pooled stream back with the blocks the
allocator cached on it, for the next topic's state.

Pinned staging slots form rings of ``ring_slots(prefetch_depth)``, one
ring per ingest stream: each thread that calls `prepare` has its own
(thread-local), and each `make_fused_sink` call leases one for its sink.
No slot is reachable from two threads, so N workers can never pack into
a slot another is filling.  A slot is refilled only after the CUDA event
recorded behind its last copy has completed.  Rings come from a pool the
backend keeps: when a scan pass ends (`release_staging`), every ring its
streams leased goes back to the pool, so the passes of a follow service
re-entering the scan on this backend reuse the same pinned buffers, as
they reuse its state, dispatch queue and superbatch stager
(``rings_allocated`` counts the rings ever built).  A one-time pack→unpack
self-check at construction holds the device-side byte views against the
host layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device
from kafka_topic_analyzer_tpu_torch.backends.alive import AliveTable
from kafka_topic_analyzer_tpu_torch.backends.base import (
    READY,
    DispatchQueue,
    MetricBackend,
    book_resident,
    finalize_phase,
    instrument_steps,
)
from kafka_topic_analyzer_tpu_torch.backends.finalize import metrics_from_state
from kafka_topic_analyzer_tpu_torch.backends.step import (
    analyzer_step,
    apply_pair_table,
    superbatch_fold,
)
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, DispatchConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    AnalyzerState,
    copy_from_numpy_,
    state_nbytes,
    state_to_numpy,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
    SuperbatchStager,
    batch_alive_pairs,
    pack_batch,
    pack_pair_table,
    packed_nbytes,
    pair_table_capacity,
    pair_table_nbytes,
    unpack_device,
    unpack_numpy,
    unpack_pair_table_device,
    unpack_pair_table_numpy,
)
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics
from kafka_topic_analyzer_tpu_torch.utils.timefmt import utc_now_seconds


class StreamPool:
    """CUDA streams lent to backends, a list of free ones a device.  A
    backend leases one at its construction and gives it back at its
    `TorchBackend.close` (or its collection), and the last stream given
    back is the next one leased.  The caching allocator hands a freed
    block only to an allocation on the stream that made it, so the next
    backend on a stream builds its state in the memory the last one
    freed there, and the card memory reserved stays what the backends
    live at once need.  Two live backends never hold one stream; the
    pool holds as many streams as were ever leased at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: "dict[torch.device, list[torch.cuda.Stream]]" = {}

    def lease(self, device: torch.device) -> "torch.cuda.Stream":
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return torch.cuda.Stream(device)

    def give_back(self, stream: "torch.cuda.Stream") -> None:
        with self._lock:
            self._free.setdefault(stream.device, []).append(stream)


#: The process's pool: every fleet audit in a process draws on it, so the
#: blocks cached on its streams serve each audit after the first.
STREAM_POOL = StreamPool()


def ring_slots(prefetch_depth: int) -> int:
    """Pinned staging slots for a prefetch depth: the item being folded,
    ``depth`` queued behind it and the one the worker holds or fills (at
    least 3: one filled, two copies in flight).  A slot whose copy is
    still in flight is waited for, never overwritten, so a short ring only
    stalls the producer."""
    return max(3, prefetch_depth + 2)


class StagingRing:
    """One ingest stream's pinned host slots (``ring_slots(depth)`` of
    ``nbytes``), handed out round-robin: a slot is handed out again only
    once the CUDA event recorded behind its last copy has completed.  Not
    thread-safe by design — one stream, one thread."""

    def __init__(self, slots: int, nbytes: int, pin: bool):
        self.hosts = [
            torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
            for _ in range(slots)
        ]
        self.views = [host.numpy() for host in self.hosts]
        self.events: "list[torch.cuda.Event | None]" = [None] * slots
        self._next = 0

    def claim(self) -> int:
        """The next slot, once its last copy has completed (span
        ``slot-wait``)."""
        slot = self._next
        self._next = (slot + 1) % len(self.hosts)
        if self.events[slot] is not None:
            with obs_trace.timed("slot-wait", cat="ingest"):
                self.events[slot].synchronize()
        return slot


class StagedBatch:
    """A batch packed and on its way to the device: ``row`` is the packed
    row, ``pairs`` its compacted pair table (at K = 1 under compaction;
    else None), both device ``uint8`` tensors.  ``raw_pairs`` are the
    batch's (slot, alive) host arrays at K > 1 under compaction, which
    the superbatch's table merges (owned by this batch: fresh arrays,
    never views of a buffer the packer reuses); else None."""

    __slots__ = ("row", "pairs", "raw_pairs", "n_pairs")

    def __init__(self, row: torch.Tensor, pairs: "torch.Tensor | None",
                 raw_pairs=None, n_pairs: int = 0):
        self.row = row
        self.pairs = pairs
        self.raw_pairs = raw_pairs
        #: At most the live alive pairs its fold applies: its pair table's
        #: (``pairs``), else its row's own (a batch's records).
        self.n_pairs = n_pairs


def _host_view(t: torch.Tensor, dtype) -> np.ndarray:
    out = t.to("cpu", copy=True).numpy()
    return out if out.ndim == 0 else out.view(dtype)


def self_check_unpack(device: torch.device) -> None:
    """Pack known batches on the host, unpack them on ``device`` and
    compare field by field: catches a byte-view mismatch before it could
    corrupt results.  Covers both wire formats, per-row and both
    compacted pair forms, every HLL pair form, the register table and odd
    batch sizes (misaligned sections: the v4 ``ts_minmax`` is 8-byte
    aligned only when 9·B is a multiple of 8)."""
    from kafka_topic_analyzer_tpu_torch.io.synthetic import (
        SyntheticSource,
        SyntheticSpec,
    )

    spec = SyntheticSpec(
        num_partitions=3, messages_per_partition=40, keys_per_partition=16, seed=11
    )
    batch = next(SyntheticSource(spec).batches(100))
    configs = [
        AnalyzerConfig(
            num_partitions=3, batch_size=128, count_alive_keys=True,
            alive_bitmap_bits=16, enable_hll=True, hll_p=8,
            enable_quantiles=True,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=127, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=101, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True, wire_format=4,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=128, count_alive_keys=True,
            alive_bitmap_bits=16, enable_hll=True, hll_p=12,
            enable_quantiles=True, wire_format=4,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=127, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True, alive_compaction="off",
        ),
    ]
    for config in configs:
        row = pack_batch(batch, config)
        checks = [
            (unpack_numpy(row, config),
             unpack_device(torch.from_numpy(row).to(device), config)),
        ]
        if config.compact_alive:
            cap = pair_table_capacity(config, config.batch_size)
            pairs, _, _ = pack_pair_table(
                [batch_alive_pairs(batch, config)], config, cap
            )
            checks.append(
                (unpack_pair_table_numpy(pairs, config, cap),
                 unpack_pair_table_device(
                     torch.from_numpy(pairs).to(device), config, cap))
            )
        for expected, got in checks:
            for name, exp in expected.items():
                exp = np.asarray(exp)
                if not np.array_equal(_host_view(got[name], exp.dtype), exp):
                    raise RuntimeError(
                        f"packed-transfer self-check failed on field {name!r}: "
                        f"the {device} unpack disagrees with the host layout"
                    )


@instrument_steps
class TorchBackend(MetricBackend):
    """Batched replacement for the reference's per-message handler: feed
    batches in per-partition offset order, read the results once at the
    end."""

    packs_rows = True

    def __init__(
        self,
        config: AnalyzerConfig,
        init_now_s: "int | None" = None,
        device: "str | torch.device | None" = None,
        use_native: bool = False,
        prefetch_depth: int = 2,
        native_requested: "bool | None" = None,
        dispatch: "DispatchConfig | None" = None,
        pooled_stream: bool = False,
    ):
        """``dispatch`` sizes the superbatch and the in-flight bound
        (``--superbatch``, ``--dispatch-depth``; default K = 1, depth 2).
        All of the backend's device work runs on one CUDA stream: the
        creating thread's current stream, or with ``pooled_stream`` one
        leased from `STREAM_POOL` until `close` (a card backend only)."""
        super().__init__(config)
        self.device = resolve_device(device)
        #: Pack through the native shim when it loads (``--native``).
        self.use_native = use_native
        #: Whether ``--native`` asked for the shim (``auto`` or ``on``),
        #: loaded or not: a fused bypass is booked ``native-off`` only
        #: when it did not, as the reference books it.
        self.native_requested = (
            use_native if native_requested is None else native_requested
        )
        #: What `close` runs once: the resident bytes' release, a pooled
        #: stream's return (each also runs at the backend's collection).
        self._releases: "list[weakref.finalize]" = []
        if self.device.type != "cuda":
            if pooled_stream:
                raise ValueError(
                    f"a CUDA stream was asked for a backend on {self.device}"
                )
            self.stream = None
        elif pooled_stream:
            self.stream = STREAM_POOL.lease(self.device)
            self._releases.append(
                weakref.finalize(self, STREAM_POOL.give_back, self.stream)
            )
        else:
            self.stream = torch.cuda.current_stream(self.device)
        self.init_now_s = utc_now_seconds() if init_now_s is None else init_now_s
        b = config.batch_size
        self.dispatch_config = dispatch if dispatch is not None else DispatchConfig()
        #: Rows folded per dispatch (``--superbatch``, resolved).
        self.superbatch_k = self.dispatch_config.resolve(b)
        #: Superbatches allowed in flight (``--dispatch-depth``).
        self.dispatch_depth = self.dispatch_config.depth
        k = self.superbatch_k
        # One dispatch's pair table covers K rows.
        self._pair_cap = (
            pair_table_capacity(config, b, k) if config.compact_alive else 0
        )
        #: The alive state's form and size (an exact set or the bitmap).
        self._alive = AliveTable(config, self.device, self._pair_cap)
        with self._on_stream():
            self_check_unpack(self.device)
            self.state = AnalyzerState.init(
                config, self.device,
                alive=self._alive.init() if config.count_alive_keys else None,
            )
        booking = book_resident(self, state_nbytes(self.state))
        self._alive.booking = booking
        self._releases.append(booking)
        self._row_nbytes = packed_nbytes(config, b)
        #: At most the live pairs a row carries without compaction.
        self._row_pairs = (
            b if config.count_alive_keys and not config.compact_alive else 0
        )
        # The pair table starts on a 16-byte boundary of the staging row.
        # Only at K = 1 does a slot carry one (its own batch's); at K > 1
        # the table spans the superbatch and the stager holds it.
        self._pair_off = -(-self._row_nbytes // 16) * 16
        self._slot_pairs = config.compact_alive and k == 1
        self._nbytes = self._pair_off + (
            pair_table_nbytes(config, self._pair_cap) if self._slot_pairs else 0
        )
        self._slots = ring_slots(prefetch_depth)
        #: Pinned bytes of one ingest stream's ring (each staging thread
        #: and each fused sink holds one).
        self.ring_nbytes = self._slots * self._nbytes
        self._thread_rings = threading.local()
        #: Rings free for the next stream, and those leased this pass.
        self._free_rings: "list[StagingRing]" = []
        self._leased_rings: "list[StagingRing]" = []
        #: Bumped by `release_staging`: a thread-local ring leased in an
        #: earlier pass is back in the pool and must be leased again.
        self._ring_gen = 0
        self._ring_lock = threading.Lock()
        #: Staging rings built over the backend's life (one per
        #: concurrent stream, however many passes).
        self.rings_allocated = 0
        #: Rows folded into the state: one counter-kernel launch each, at
        #: any K.
        self.dispatches = 0
        self._queue = DispatchQueue(self.dispatch_depth)
        self._stager = (
            SuperbatchStager(
                pair_table_nbytes(config, self._pair_cap)
                if config.compact_alive else 0,
                self.dispatch_depth,
                pin=self.device.type == "cuda",
            )
            if k > 1 else None
        )

    def set_dispatch_depth(self, depth: int) -> None:
        """Re-bound the in-flight dispatch window between passes (the
        fleet scheduler's dispatch-share grants).  A shrink applies at
        once (the queue's throttle reads the bound per call); a grow
        clamps at the constructed depth, which sized the superbatch
        stager's ring."""
        depth = max(1, min(int(depth), self.dispatch_config.depth))
        self.dispatch_depth = depth
        self._queue.depth = depth

    def _on_stream(self):
        """Make the backend's stream current on the calling thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _lease_ring(self) -> StagingRing:
        """A ring for one ingest stream: a pooled one when a stream of an
        earlier pass gave one back, else a new one."""
        with self._ring_lock:
            if self._free_rings:
                ring = self._free_rings.pop()
            else:
                ring = StagingRing(
                    self._slots, self._nbytes, self.device.type == "cuda"
                )
                self.rings_allocated += 1
            self._leased_rings.append(ring)
            return ring

    def release_staging(self) -> None:
        """Return every ring leased since the last call to the pool (the
        pass's streams have ended).  A slot's pending copy is still waited
        for at its next claim."""
        with self._ring_lock:
            self._ring_gen += 1
            self._free_rings.extend(self._leased_rings)
            self._leased_rings = []

    def _thread_ring(self) -> StagingRing:
        """The calling thread's own ring for `prepare`."""
        held = getattr(self._thread_rings, "ring", None)
        if held is None or held[0] != self._ring_gen:
            held = self._thread_rings.ring = (self._ring_gen, self._lease_ring())
        return held[1]

    def _send(self, ring: StagingRing, slot: int, raw_pairs=None,
              n_pairs: "int | None" = None) -> StagedBatch:
        """Start the one asynchronous copy of a filled slot to the device,
        and record the event that frees the slot.  Ingest threads issue it
        on the backend's stream: the copy is enqueued before its item is
        queued to the main thread, and the fold after the item is
        dequeued, so the stream's order keeps every copy ahead of its
        fold, whichever worker sent it (span ``send``)."""
        self._live_state()
        with obs_trace.timed("send", cat="ingest"), self._on_stream():
            dev = torch.empty(self._nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(ring.hosts[slot], non_blocking=True)
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
                ring.events[slot] = event
        return StagedBatch(
            dev[: self._row_nbytes],
            dev[self._pair_off :] if self._slot_pairs else None,
            raw_pairs,
            self._row_pairs if n_pairs is None else n_pairs,
        )

    def _pack_pairs(self, pair_lists, out: np.ndarray) -> int:
        """Merge and pack one dispatch's compacted pair table into ``out``
        (a slot's pair region at K = 1, a stager buffer at K > 1),
        booking the raw→emitted compaction split; returns the pairs
        emitted."""
        _, raw, emitted = pack_pair_table(
            pair_lists, self.config, self._pair_cap, use_native=self.use_native,
            out=out,
        )
        obs_metrics.ALIVE_PAIRS_RAW.inc(raw)
        obs_metrics.ALIVE_PAIRS_EMITTED.inc(emitted)
        return emitted

    def prepare(self, batch: RecordBatch) -> StagedBatch:
        """Pack a batch into the next slot of the calling thread's ring
        and start its copy to the device (with its pair table at K = 1,
        its raw pairs kept on the host at K > 1)."""
        ring = self._thread_ring()
        slot = ring.claim()
        view = ring.views[slot]
        pack_batch(
            batch, self.config, use_native=self.use_native,
            out=view[: self._row_nbytes],
        )
        pairs = n_pairs = None
        if self.config.compact_alive:
            pairs = batch_alive_pairs(batch, self.config, self.use_native)
            if self._slot_pairs:
                n_pairs = self._pack_pairs([pairs], view[self._pair_off :])
                pairs = None
        return self._send(ring, slot, pairs, n_pairs)

    def make_fused_sink(self, dense_of) -> FusedPackSink:
        """A sink whose rows are packed straight into the slots of a ring
        of its own and come out staged exactly like `prepare`'s (call only
        when the native shim is loaded; one sink per ingest stream)."""
        ring = self._lease_ring()
        ptrs = [view.ctypes.data for view in ring.views]

        def alloc() -> np.ndarray:
            return ring.views[ring.claim()][: self._row_nbytes]

        def stage(row: np.ndarray, pairs=None) -> StagedBatch:
            slot = ptrs.index(row.ctypes.data)
            n_pairs = None
            if self._slot_pairs:
                n_pairs = self._pack_pairs([pairs], ring.views[slot][self._pair_off :])
                pairs = None
            return self._send(ring, slot, pairs, n_pairs)

        return FusedPackSink(
            self.config, self.config.batch_size, dense_of,
            stage=stage, alloc=alloc,
        )

    def _completion_token(self):
        """A token that completes with the work enqueued so far on the
        backend's stream: a timing CUDA event recorded there, or
        `base.READY` on the host, where the fold finished when it
        returned."""
        if self.stream is None:
            return READY
        event = torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        return event

    def _fold_start(self):
        """A timing event recorded before a fold's first launch (None on
        the host): the start of the fold's device span."""
        return None if self.stream is None else self._completion_token()

    def update(self, batch: "RecordBatch | StagedBatch") -> None:
        """Fold one batch (packed here if it was not prepared) into the
        state, once fewer than ``dispatch_depth`` folds are in flight.
        Asynchronous on CUDA.  At K > 1 the batch is a superbatch of
        one."""
        if self.superbatch_k > 1:
            self.update_superbatch([batch])
            return
        state = self._live_state()
        if isinstance(batch, RecordBatch):
            batch = self.prepare(batch)
        obs_metrics.WIRE_BYTES.inc(int(batch.row.numel()))
        if batch.pairs is not None:
            obs_metrics.WIRE_BYTES.inc(int(batch.pairs.numel()))
        self._queue.throttle()
        with self._on_stream():
            start = self._fold_start()
            self._alive.reserve(state, batch.n_pairs)
            analyzer_step(
                state, unpack_device(batch.row, self.config), self.config
            )
            if batch.pairs is not None:
                apply_pair_table(
                    state,
                    unpack_pair_table_device(batch.pairs, self.config, self._pair_cap),
                    self.config,
                )
            self._alive.counted(state)
            token = self._completion_token()
        self._queue.launched(token, 1, start)
        self.dispatches += 1

    def update_superbatch(
        self, staged: "list[StagedBatch | RecordBatch]"
    ) -> None:
        """Fold up to K batches in one dispatch, in list order (the state
        K sequential `update` calls would leave).  Blocks in the dispatch
        queue's throttle while ``dispatch_depth`` superbatches are in
        flight, before anything is staged; then folds every row, applies
        the superbatch's merged pair table once, records one CUDA event
        and books the dispatch with ``len(staged)`` batches.  Only the
        rows given are folded: the reference pads a partial tail with
        empty rows so that one compiled step serves every length, which
        the port does not need (so ``kta_wire_bytes_total`` books no
        padding)."""
        k = self.superbatch_k
        if not staged or len(staged) > k:
            raise ValueError(f"superbatch of {len(staged)} batches (K={k})")
        state = self._live_state()
        self._queue.throttle()  # before staging: bounds the stager's ring
        slot = self._stager.next_slot()
        items = [
            self.prepare(b) if isinstance(b, RecordBatch) else b for b in staged
        ]
        for item in items:
            obs_metrics.WIRE_BYTES.inc(int(item.row.numel()))
        with self._on_stream():
            pairs = None
            n_pairs = sum(item.n_pairs for item in items)
            if self.config.compact_alive:
                n_pairs = self._pack_pairs(
                    [item.raw_pairs for item in items
                     if item.raw_pairs is not None],
                    self._stager.views[slot],
                )
            start = self._fold_start()
            self._alive.reserve(state, n_pairs)
            if self.config.compact_alive:
                host = self._stager.hosts[slot]
                dev = torch.empty(host.numel(), dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                obs_metrics.WIRE_BYTES.inc(int(dev.numel()))
                if self.stream is not None:
                    self._stager.record(slot, self._completion_token())
                pairs = unpack_pair_table_device(dev, self.config, self._pair_cap)
            superbatch_fold(
                state, [item.row for item in items],
                lambda row: unpack_device(row, self.config), self.config,
                pairs=pairs,
            )
            self._alive.counted(state)
            token = self._completion_token()
        self._queue.launched(token, len(items), start)
        self.dispatches += len(items)

    snapshots = True

    def drain_dispatch(self) -> None:
        self._queue.drain()

    def close(self) -> None:
        """Free the device state now: retire the in-flight folds, drop the
        state, the staging rings and the superbatch stager, take the
        state's bytes off the process's live sum and give a pooled stream
        back, with the blocks freed on it, to the next backend that leases
        it.  A second call does nothing; a fold, a snapshot or a finalize
        after it raises."""
        if self.state is None:
            return
        try:
            self._queue.drain()
        finally:
            self.state = None
            self._stager = None
            with self._ring_lock:
                self._free_rings, self._leased_rings = [], []
            for release in self._releases:
                release()

    def _live_state(self) -> AnalyzerState:
        """The state, or a clear error once `close` has freed it."""
        if self.state is None:
            raise RuntimeError(
                "the backend is closed: its device state was freed"
            )
        return self.state

    def get_state(self) -> "dict[str, np.ndarray]":
        """Retire the in-flight folds and copy the state to the host, on
        the backend's stream: the copy is ordered after every fold already
        enqueued there, whichever thread asks, and returns once it is
        done."""
        state = self._live_state()
        self._queue.drain()
        with self._on_stream():
            return state_to_numpy(state)

    def set_state(self, leaves: "dict[str, np.ndarray]") -> None:
        """Copy a snapshot's leaves into the state's own tensors, on the
        backend's stream (ahead of every fold enqueued after it); an exact
        alive set is rebuilt from the snapshot's words
        (`alive.AliveTable.load`)."""
        state = self._live_state()
        with self._on_stream():
            rest = self._alive.load(state, leaves)
            copy_from_numpy_(dataclasses.replace(state, alive=None), rest)

    def finalize(self) -> TopicMetrics:
        """Retire the in-flight folds, copy the state to the host (waiting
        for the device) and derive the metrics there: `get_state`'s work
        and the derivation, each phase timed (`base.finalize_phase`).  The
        alive keys cross as their count alone: an exact set counts them on
        the device, the dense bitmap's words are counted on the host."""
        state = self._live_state()
        with finalize_phase("drain"):
            self._queue.drain()
        with finalize_phase("copy"), self._on_stream():
            alive_keys = self._alive.count(state)
            leaves = state_to_numpy(dataclasses.replace(state, alive=None))
        with finalize_phase("derive"):
            return metrics_from_state(leaves, self.config, self.init_now_s,
                                      alive_keys)
