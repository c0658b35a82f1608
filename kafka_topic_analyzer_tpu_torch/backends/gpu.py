"""TorchBackend: the streaming reduction with its state resident on one
device (port of the reference's ``TpuBackend`` at superbatch K=1).

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
)
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    AnalyzerState,
    copy_from_numpy_,
    state_to_numpy,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_scratch
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
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
    row, ``pairs`` the compacted pair table (None unless the config
    compacts alive pairs), both device ``uint8`` tensors."""

    __slots__ = ("row", "pairs")

    def __init__(self, row: torch.Tensor, pairs: "torch.Tensor | None"):
        self.row = row
        self.pairs = pairs


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
        dispatch_depth: int = 2,
        native_requested: "bool | None" = None,
    ):
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
        self._pair_cap = pair_table_capacity(config, b) if config.compact_alive else 0
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
        self._pair_off = -(-self._row_nbytes // 16) * 16
        self._nbytes = self._pair_off + (
            pair_table_nbytes(config, self._pair_cap) if config.compact_alive else 0
        )
        self._slots = ring_slots(prefetch_depth)
        #: Pinned bytes of one ingest stream's ring (each staging thread
        #: and each fused sink holds one).
        self.ring_nbytes = self._slots * self._nbytes
        self._thread_rings = threading.local()
        #: Batches folded into the state (one dispatch each at K=1).
        self.dispatches = 0
        #: Folds allowed in flight (``--dispatch-depth``).
        self.dispatch_depth = dispatch_depth
        self._queue = DispatchQueue(dispatch_depth)

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

    def _send(self, ring: StagingRing, slot: int) -> StagedBatch:
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
            dev[self._pair_off :] if self.config.compact_alive else None,
        )

    def _pack_pairs(self, pairs, view: np.ndarray) -> None:
        """Pack one dispatch's compacted pair table into a slot's pair
        region (``view``), booking the raw→emitted compaction split."""
        _, raw, emitted = pack_pair_table(
            [pairs], self.config, self._pair_cap, use_native=self.use_native,
            out=view[self._pair_off :],
        )
        obs_metrics.ALIVE_PAIRS_RAW.inc(raw)
        obs_metrics.ALIVE_PAIRS_EMITTED.inc(emitted)

    def prepare(self, batch: RecordBatch) -> StagedBatch:
        """Pack a batch into the next slot of the calling thread's ring
        and start its copy to the device."""
        ring = self._thread_ring()
        slot = ring.claim()
        view = ring.views[slot]
        pack_batch(
            batch, self.config, use_native=self.use_native,
            out=view[: self._row_nbytes],
        )
        if self.config.compact_alive:
            self._pack_pairs(
                batch_alive_pairs(batch, self.config, self.use_native), view
            )
        return self._send(ring, slot)

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
            if self.config.compact_alive:
                self._pack_pairs(pairs, ring.views[slot])
            return self._send(ring, slot)

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
        Asynchronous on CUDA."""
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
