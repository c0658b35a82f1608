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
``min(K·B, 2^bits)``, which also picks its form (masks or list) and
whether the pair scatter needs its scratch.

Nothing synchronizes until `finalize` (or a snapshot's `get_state`) but
the two real waits — a ring slot whose copy is still in flight, and the
dispatch queue's throttle — so packing the next batch overlaps the
device's work on this one, on the main thread, on a prefetch worker or on
N parallel-ingest workers (engine.py): `prepare` and the sinks run on the
ingest threads while `update` runs on the main thread.  The step and
finalize times booked by `base.instrument_steps` are therefore host
time: enqueue plus those waits.  The copy, its event and the fold all run
on the stream the backend holds (``self.stream``, the creating thread's
current stream), whichever thread issues them.

Pinned staging slots form rings of ``ring_slots(prefetch_depth)``, one
ring per ingest stream: each thread that calls `prepare` has its own
(thread-local), and each `make_fused_sink` call builds one for its sink.
No slot is reachable from two threads, so N workers can never pack into
a slot another is filling.  A slot is refilled only after the CUDA event
recorded behind its last copy has completed.  A one-time pack→unpack
self-check at construction holds the device-side byte views against the
host layout.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device
from kafka_topic_analyzer_tpu_torch.backends.base import (
    READY,
    DispatchQueue,
    MetricBackend,
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
    state_to_numpy,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_scratch
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
    SuperbatchStager,
    alive_table_mode,
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
        """The next slot, once its last copy has completed."""
        slot = self._next
        self._next = (slot + 1) % len(self.hosts)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        return slot


class StagedBatch:
    """A batch packed and on its way to the device: ``row`` is the packed
    row, ``pairs`` its compacted pair table (at K = 1 under compaction;
    else None), both device ``uint8`` tensors.  ``raw_pairs`` are the
    batch's (slot, alive) host arrays at K > 1 under compaction, which
    the superbatch's table merges (owned by this batch: fresh arrays,
    never views of a buffer the packer reuses); else None."""

    __slots__ = ("row", "pairs", "raw_pairs")

    def __init__(self, row: torch.Tensor, pairs: "torch.Tensor | None",
                 raw_pairs=None):
        self.row = row
        self.pairs = pairs
        self.raw_pairs = raw_pairs


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
    ):
        """``dispatch`` sizes the superbatch and the in-flight bound
        (``--superbatch``, ``--dispatch-depth``; default K = 1, depth 2)."""
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
        self.stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        self.init_now_s = utc_now_seconds() if init_now_s is None else init_now_s
        self_check_unpack(self.device)
        self.state = AnalyzerState.init(config, self.device)
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
        # Pair lists (per row, or a compacted table in its list form)
        # scatter through a persistent word accumulator.
        pair_lists = config.count_alive_keys and (
            not config.compact_alive
            or alive_table_mode(config, self._pair_cap) == 1
        )
        self._scratch = (
            bitmap_scratch(config.alive_bitmap_bits, self.device)
            if pair_lists else None
        )
        self._row_nbytes = packed_nbytes(config, b)
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

    def _on_stream(self):
        """Make the backend's stream current on the calling thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _new_ring(self) -> StagingRing:
        return StagingRing(self._slots, self._nbytes, self.device.type == "cuda")

    def _thread_ring(self) -> StagingRing:
        """The calling thread's own ring for `prepare`."""
        ring = getattr(self._thread_rings, "ring", None)
        if ring is None:
            ring = self._thread_rings.ring = self._new_ring()
        return ring

    def _send(self, ring: StagingRing, slot: int, raw_pairs=None) -> StagedBatch:
        """Start the one asynchronous copy of a filled slot to the device,
        and record the event that frees the slot.  Ingest threads issue it
        on the backend's stream: the copy is enqueued before its item is
        queued to the main thread, and the fold after the item is
        dequeued, so the stream's order keeps every copy ahead of its
        fold, whichever worker sent it."""
        with self._on_stream():
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
        )

    def _pack_pairs(self, pair_lists, out: np.ndarray) -> None:
        """Merge and pack one dispatch's compacted pair table into ``out``
        (a slot's pair region at K = 1, a stager buffer at K > 1),
        booking the raw→emitted compaction split."""
        _, raw, emitted = pack_pair_table(
            pair_lists, self.config, self._pair_cap, use_native=self.use_native,
            out=out,
        )
        obs_metrics.ALIVE_PAIRS_RAW.inc(raw)
        obs_metrics.ALIVE_PAIRS_EMITTED.inc(emitted)

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
        pairs = None
        if self.config.compact_alive:
            pairs = batch_alive_pairs(batch, self.config, self.use_native)
            if self._slot_pairs:
                self._pack_pairs([pairs], view[self._pair_off :])
                pairs = None
        return self._send(ring, slot, pairs)

    def make_fused_sink(self, dense_of) -> FusedPackSink:
        """A sink whose rows are packed straight into the slots of a ring
        of its own and come out staged exactly like `prepare`'s (call only
        when the native shim is loaded; one sink per ingest stream)."""
        ring = self._new_ring()
        ptrs = [view.ctypes.data for view in ring.views]

        def alloc() -> np.ndarray:
            return ring.views[ring.claim()][: self._row_nbytes]

        def stage(row: np.ndarray, pairs=None) -> StagedBatch:
            slot = ptrs.index(row.ctypes.data)
            if self._slot_pairs:
                self._pack_pairs([pairs], ring.views[slot][self._pair_off :])
                pairs = None
            return self._send(ring, slot, pairs)

        return FusedPackSink(
            self.config, self.config.batch_size, dense_of,
            stage=stage, alloc=alloc,
        )

    def _completion_token(self):
        """A token that completes with the work enqueued so far on the
        backend's stream: a CUDA event recorded there, or `base.READY` on
        the host, where the fold finished when it returned."""
        if self.stream is None:
            return READY
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def update(self, batch: "RecordBatch | StagedBatch") -> None:
        """Fold one batch (packed here if it was not prepared) into the
        state, once fewer than ``dispatch_depth`` folds are in flight.
        Asynchronous on CUDA.  At K > 1 the batch is a superbatch of
        one."""
        if self.superbatch_k > 1:
            self.update_superbatch([batch])
            return
        if isinstance(batch, RecordBatch):
            batch = self.prepare(batch)
        obs_metrics.WIRE_BYTES.inc(int(batch.row.numel()))
        if batch.pairs is not None:
            obs_metrics.WIRE_BYTES.inc(int(batch.pairs.numel()))
        self._queue.throttle()
        with self._on_stream():
            analyzer_step(
                self.state, unpack_device(batch.row, self.config), self.config,
                scratch=self._scratch,
            )
            if batch.pairs is not None:
                apply_pair_table(
                    self.state,
                    unpack_pair_table_device(batch.pairs, self.config, self._pair_cap),
                    self.config,
                    scratch=self._scratch,
                )
            token = self._completion_token()
        self._queue.launched(token, 1)
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
        self._queue.throttle()  # before staging: bounds the stager's ring
        slot = self._stager.next_slot()
        items = [
            self.prepare(b) if isinstance(b, RecordBatch) else b for b in staged
        ]
        for item in items:
            obs_metrics.WIRE_BYTES.inc(int(item.row.numel()))
        with self._on_stream():
            pairs = None
            if self.config.compact_alive:
                self._pack_pairs(
                    [item.raw_pairs for item in items
                     if item.raw_pairs is not None],
                    self._stager.views[slot],
                )
                host = self._stager.hosts[slot]
                dev = torch.empty(host.numel(), dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                obs_metrics.WIRE_BYTES.inc(int(dev.numel()))
                if self.stream is not None:
                    self._stager.record(slot, self._completion_token())
                pairs = unpack_pair_table_device(dev, self.config, self._pair_cap)
            superbatch_fold(
                self.state, [item.row for item in items],
                lambda row: unpack_device(row, self.config), self.config,
                pairs=pairs, scratch=self._scratch,
            )
            token = self._completion_token()
        self._queue.launched(token, len(items))
        self.dispatches += len(items)

    snapshots = True

    def drain_dispatch(self) -> None:
        self._queue.drain()

    def get_state(self) -> "dict[str, np.ndarray]":
        """Retire the in-flight folds and copy the state to the host, on
        the backend's stream: the copy is ordered after every fold already
        enqueued there, whichever thread asks, and returns once it is
        done."""
        self._queue.drain()
        with self._on_stream():
            return state_to_numpy(self.state)

    def set_state(self, leaves: "dict[str, np.ndarray]") -> None:
        """Copy a snapshot's leaves into the state's own tensors, on the
        backend's stream (ahead of every fold enqueued after it)."""
        with self._on_stream():
            copy_from_numpy_(self.state, leaves)

    def finalize(self) -> TopicMetrics:
        """Retire the in-flight folds, copy the state to the host (waiting
        for the device) and derive the metrics there."""
        return metrics_from_state(self.get_state(), self.config, self.init_now_s)
