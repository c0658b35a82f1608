"""ShardedTorchBackend: the streaming reduction over a (data, space) mesh
(port of the reference's ``parallel/sharded.py``).

The record stream is sharded over both mesh axes, as in the reference:
partitions go to data rows (`parallel.mesh.assign_partitions`), and each
data row's batch is split into ``space_shards`` contiguous chunks of
``batch_size / space_shards`` records (`packing.pack_chunks`), one per
(data, space) shard.  Everything but the alive bitmap folds chunk-local
into the shard's own rows of the state, and reduces once, at finalize:

- counters, byte sums, counts and DDSketch buckets: sum over the D·S rows;
- timestamp and size extremes: min / max over the D·S rows;
- HLL registers: max over the D·S rows;
- the alive bitmap: each space shard owns a slot range of its data row's
  bitmap; the D rows OR together, on the device, before the one copy to
  the host, where the popcount runs (`backends.finalize`).

Last-writer-wins is order-sensitive, and a key's records may straddle
chunks.  With compaction off every space shard therefore applies all S
chunks' pairs of its row in chunk order, each masked to its own range
(the reference all-gathers them over the space axis; here the row's
chunks are on the device already).  Under compaction the host merges
each data row's pairs per dispatch into one table, which every space
shard of the row applies to its range after the row's folds.

State layout — the reference's, so that snapshots cross packages:
record-parallel leaves are ``[D·S, ...]`` (shard (d, s) is row
``d·S + s``), the bitmap ``[D, W]`` with its words split over the space
axis.  Each device of the mesh (`parallel.mesh.make_mesh`: round-robin,
so one card holds every shard) keeps the rows of its shards as one
stacked tensor per leaf, and each shard folds into views of its rows:
the counter kernels are handed a view's ``data_ptr()``, at its storage
offset, and launch inside the shard device's context.

Per dispatch (one round at K = 1, up to K rounds at ``--superbatch K``):
one throttle of the dispatch queue; the rounds' chunk stacks
``[K, D, S, chunk_nbytes]`` (and, under compaction, one pair table per
data row) assembled in a pinned `packing.SuperbatchStager` slot on the
main thread and copied to each device in one asynchronous copy; then for
every round, data row and space shard `backends.step.analyzer_step` on
the shard's chunk (one counter-kernel launch each: rounds × D·S per
dispatch), the pair tables, and one completion token per dispatch.  The
reference pads a partial superbatch tail with empty rounds; the port
folds only the rounds it has (`backends.gpu`, ROADMAP's standing
divergences).

Several controllers (``--distributed``, `parallel.mesh.
initialize_distributed`): each process holds, stages and folds only its
own data rows (`local_rows`, a contiguous block of L rows: ``D`` above
reads L), and ignores the round entries of the others' rows.  A fold
launches no collective.  The processes meet at the collectives the engine
runs in the same order on every process, all of them over the gloo group
on host tensors: the per-round `global_any` agreement, finalize's merge
(each process first reduces its own rows, then one all-reduce per leaf
by its merge law, the bitmap's words by bitwise OR) and
`gather_telemetry`.  Snapshots are per process (`snapshot_scope`,
`get_state_local`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from kafka_topic_analyzer_tpu_torch._torch_support import i32_to_u32, u32_to_i32
from kafka_topic_analyzer_tpu_torch.backends.base import (
    READY,
    DispatchQueue,
    MetricBackend,
    instrument_steps,
)
from kafka_topic_analyzer_tpu_torch.backends.finalize import metrics_from_state
from kafka_topic_analyzer_tpu_torch.backends.gpu import self_check_unpack
from kafka_topic_analyzer_tpu_torch.backends.step import (
    analyzer_step,
    apply_pair_table,
)
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, DispatchConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    MERGE_LAW,
    AliveBitmapState,
    AnalyzerState,
    DDSketchState,
    HLLState,
    MessageMetricsState,
    merge_rows,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_num_words, bitmap_scratch
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
    SuperbatchStager,
    alive_table_mode,
    batch_alive_pairs,
    pack_chunks,
    pack_pair_table,
    packed_nbytes,
    pair_table_capacity,
    pair_table_nbytes,
    unpack_device,
    unpack_pair_table_device,
)
from kafka_topic_analyzer_tpu_torch.parallel.mesh import (
    Mesh,
    local_data_rows,
    make_mesh,
    process_count,
    process_index,
)
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics
from kafka_topic_analyzer_tpu_torch.utils.timefmt import utc_now_seconds


#: The collective of each `models.state.MERGE_LAW` fold.
_REDUCE_OP = {
    np.add: dist.ReduceOp.SUM,
    np.minimum: dist.ReduceOp.MIN,
    np.maximum: dist.ReduceOp.MAX,
}


def _all_reduce(arr: np.ndarray, op) -> np.ndarray:
    """``arr`` reduced by ``op`` over every process of the group (a host
    tensor on the gloo group; the same result on every process)."""
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
    dist.all_reduce(t, op=op)
    return t.numpy().reshape(arr.shape)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class PackedShard:
    """One data row's batch packed into its space chunks ``[S,
    chunk_nbytes]`` (`ShardedTorchBackend.prepare_shard`, or a fused
    sink's row): a host array the dispatch copies into its pinned slot.
    ``pairs`` are the row's (slot u32[n], flag u8[n]) host arrays in
    stream order under compaction (the dispatch merges them per data
    row), else None."""

    __slots__ = ("chunks", "pairs")

    def __init__(self, chunks: np.ndarray, pairs=None):
        self.chunks = chunks
        self.pairs = pairs


class _Tokens:
    """Completion token of work enqueued on several devices: one CUDA
    event per device (the `base.DispatchQueue` token surface)."""

    def __init__(self, events):
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


def _on(device: torch.device):
    """Make ``device`` current for the launches inside (a no-op on the
    host): the counter kernels refuse tables off the current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _stacked_init(config: AnalyzerConfig, rows: int, device) -> AnalyzerState:
    """A fresh state with ``rows`` stacked shard rows on ``device``: every
    record-parallel leaf ``[rows, ...]``, the bitmap ``[rows, W / S]``."""
    one = AnalyzerState.init(
        dataclasses.replace(config, count_alive_keys=False), device
    )

    def stack(t: torch.Tensor) -> torch.Tensor:
        return t.unsqueeze(0).repeat(rows, *([1] * t.dim()))

    return AnalyzerState(
        metrics=MessageMetricsState(**{
            f.name: stack(getattr(one.metrics, f.name))
            for f in dataclasses.fields(MessageMetricsState)
        }),
        alive=AliveBitmapState(words=torch.zeros(
            (rows, bitmap_num_words(config.alive_bitmap_bits, config.space_shards)),
            dtype=torch.int32, device=device,
        )) if config.count_alive_keys else None,
        hll=HLLState(regs=stack(one.hll.regs)) if one.hll is not None else None,
        quantiles=(
            DDSketchState(counts=stack(one.quantiles.counts))
            if one.quantiles is not None else None
        ),
    )


def _row_view(stack: AnalyzerState, r: int) -> AnalyzerState:
    """Shard row ``r`` of a stacked state, as views the step updates in
    place."""
    return AnalyzerState(
        metrics=MessageMetricsState(**{
            f.name: getattr(stack.metrics, f.name)[r]
            for f in dataclasses.fields(MessageMetricsState)
        }),
        alive=(
            AliveBitmapState(words=stack.alive.words[r])
            if stack.alive is not None else None
        ),
        hll=HLLState(regs=stack.hll.regs[r]) if stack.hll is not None else None,
        quantiles=(
            DDSketchState(counts=stack.quantiles.counts[r])
            if stack.quantiles is not None else None
        ),
    )


def _leaves(stack: AnalyzerState) -> "dict[str, torch.Tensor]":
    """Leaf path → stacked tensor (`models.state.state_to_numpy`'s keys)."""
    out = {
        f"metrics.{f.name}": getattr(stack.metrics, f.name)
        for f in dataclasses.fields(MessageMetricsState)
    }
    if stack.alive is not None:
        out["alive.words"] = stack.alive.words
    if stack.hll is not None:
        out["hll.regs"] = stack.hll.regs
    if stack.quantiles is not None:
        out["quantiles.counts"] = stack.quantiles.counts
    return out


@instrument_steps
class ShardedTorchBackend(MetricBackend):
    """The analyzer over a (data, space) mesh of torch devices: feed it one
    round at a time through `update_shards` (one batch per data row, each
    row's partitions in offset order), read the results once at the end.
    `update` splits a mixed batch by partition → row (``partition % D``).
    Under several controllers every process must call `update_shards`,
    `global_any`, `finalize` and `gather_telemetry` for the same rounds
    and in the same order (the engine does)."""

    packs_rows = True
    snapshots = True
    sharded = True

    def __init__(
        self,
        config: AnalyzerConfig,
        mesh: "Mesh | None" = None,
        init_now_s: "int | None" = None,
        device: "str | torch.device | None" = None,
        use_native: bool = False,
        native_requested: "bool | None" = None,
        dispatch: "DispatchConfig | None" = None,
    ):
        """``mesh`` defaults to `parallel.mesh.make_mesh` over every
        visible CUDA device, or over ``device`` when one is named
        (``"cpu"``: the host)."""
        super().__init__(config)
        config.validate_mesh()
        d, s = config.data_shards, config.space_shards
        if mesh is None:
            named = device not in (None, "cuda", "gpu")
            mesh = make_mesh(d, s, devices=[device] if named else None)
        if mesh.shape != (d, s):
            raise ValueError("mesh shape does not match config.mesh_shape")
        self.mesh = mesh
        #: The data rows this process feeds and holds: all of them with one
        #: controller, else its contiguous block (`parallel.mesh`).
        self.local_rows = local_data_rows(mesh)
        self._multiprocess = process_count() > 1
        self.device = mesh.device_of(self.local_rows[0], 0)
        self.use_native = use_native
        self.native_requested = (
            use_native if native_requested is None else native_requested
        )
        self.init_now_s = utc_now_seconds() if init_now_s is None else init_now_s
        #: Every record chunk packs with this config (its batch size sets
        #: the HLL wire mode and so the sections).
        self.chunk_config = (
            dataclasses.replace(config, batch_size=config.chunk_size)
            if s > 1 else config
        )
        #: Local shard index j·S + s (j-th local row) → (device, row in
        #: that device's stack).
        self._where: "list[tuple[torch.device, int]]" = []
        counts: "dict[torch.device, int]" = {}
        for r in self.local_rows:
            for c in range(s):
                dev = mesh.device_of(r, c)
                self._where.append((dev, counts.get(dev, 0)))
                counts[dev] = counts.get(dev, 0) + 1
        self.devices = list(counts)
        self._compact = config.compact_alive
        self.dispatch_config = dispatch if dispatch is not None else DispatchConfig()
        #: Rounds folded per dispatch (``--superbatch``, resolved).
        self.superbatch_k = k = self.dispatch_config.resolve(config.batch_size)
        self.dispatch_depth = self.dispatch_config.depth
        # One pair table per data row covers the dispatch's K rounds.
        self._pair_cap = (
            pair_table_capacity(config, config.batch_size, k) if self._compact else 0
        )
        pair_lists = config.count_alive_keys and (
            not self._compact or alive_table_mode(config, self._pair_cap) == 1
        )
        self._stacks: "dict[torch.device, AnalyzerState]" = {}
        self._scratch: "dict[torch.device, torch.Tensor | None]" = {}
        for dev, rows in counts.items():
            with _on(dev):
                self_check_unpack(dev)
                self._stacks[dev] = _stacked_init(config, rows, dev)
                self._scratch[dev] = (
                    bitmap_scratch(config.alive_bitmap_bits, dev, s)
                    if pair_lists else None
                )
        self._shards = [_row_view(self._stacks[dev], r) for dev, r in self._where]
        # The pinned slot of one dispatch: K rounds of [L, S] chunks (L
        # local rows), each on a 16-byte stride (typed views need no copy),
        # then L tables.
        rows = len(self.local_rows)
        self._chunk_nbytes = packed_nbytes(self.chunk_config, config.chunk_size)
        self._stride = _align16(self._chunk_nbytes)
        self._table_off = _align16(k * rows * s * self._stride)
        self._table_nbytes = (
            pair_table_nbytes(config, self._pair_cap) if self._compact else 0
        )
        self._table_stride = _align16(self._table_nbytes)
        self._stager = SuperbatchStager(
            self._table_off + rows * self._table_stride,
            self.dispatch_depth,
            pin=any(dev.type == "cuda" for dev in self.devices),
            book=k > 1,
        )
        self._queue = DispatchQueue(self.dispatch_depth)
        self._empty: "np.ndarray | None" = None
        #: Rounds folded into the state (rounds × D·S counter-kernel
        #: launches).
        self.dispatches = 0

    # -- staging -------------------------------------------------------------

    def _pack(self, batch: "RecordBatch | None", out=None) -> np.ndarray:
        """`packing.pack_chunks` of one data row's batch (None: an empty
        row, the round of a drained row)."""
        return pack_chunks(
            batch if batch is not None else RecordBatch.empty(0),
            self.chunk_config, self.config.space_shards,
            use_native=self.use_native, out=out,
        )

    def _row_pairs(self, batch: "RecordBatch | None"):
        if batch is None or len(batch) == 0:
            return np.empty(0, np.uint32), np.empty(0, np.uint8)
        return batch_alive_pairs(batch, self.config, self.use_native)

    def prepare_shard(self, batch: RecordBatch) -> PackedShard:
        """Pack one data row's batch into its chunks on the ingest thread
        (with its alive pairs under compaction)."""
        return PackedShard(
            self._pack(batch), self._row_pairs(batch) if self._compact else None
        )

    def make_fused_sink(self, dense_of) -> FusedPackSink:
        """A sink whose rows are ``[S, chunk_nbytes]`` chunk stacks (flat
        at S = 1), the `pack_chunks` rule (one sink per data row's ingest
        stream; call only when the native shim is loaded)."""
        return FusedPackSink(
            self.chunk_config, self.config.chunk_size, dense_of,
            stage=PackedShard, space_shards=self.config.space_shards,
        )

    # -- folds ---------------------------------------------------------------

    def update(self, batch: RecordBatch) -> None:
        """Split a mixed batch by partition → data row (``partition % D``)
        and fold it as one round."""
        d = self.config.data_shards
        row_of = np.asarray(batch.partition) % d
        self.update_shards(
            [batch.take(np.nonzero(row_of == r)[0]) for r in range(d)]
        )

    def update_shards(self, batches: list) -> None:
        """Fold one round; ``batches[d]`` feeds data row ``d``: a
        `PackedShard`, a decoded batch or None (a drained row).  Entries
        of rows another process owns are ignored (that process folds
        them in its own call)."""
        self._dispatch([batches])

    def update_shards_superbatch(self, rounds: list) -> None:
        """Fold up to K rounds in one dispatch, in order: the state K
        `update_shards` calls would leave."""
        k = self.superbatch_k
        if not rounds or len(rounds) > k:
            raise ValueError(f"superbatch of {len(rounds)} rounds (K={k})")
        self._dispatch(rounds)

    def _dispatch(self, rounds: list) -> None:
        cfg = self.config
        d, s = cfg.data_shards, cfg.space_shards
        for batches in rounds:
            if len(batches) != d:
                raise ValueError(f"expected {d} shard batches, got {len(batches)}")
        rows = self.local_rows
        self._queue.throttle()  # before staging: bounds the stager's ring
        slot = self._stager.next_slot()
        view = self._stager.views[slot]
        chunks = view[: self._table_off].reshape(-1, len(rows), s, self._stride)
        for i, batches in enumerate(rounds):
            for j, r in enumerate(rows):
                b = batches[r]
                out = chunks[i, j, :, : self._chunk_nbytes]
                if isinstance(b, PackedShard):
                    np.copyto(out, b.chunks)
                elif b is None:
                    if self._empty is None:
                        self._empty = self._pack(None)
                    np.copyto(out, self._empty)
                else:
                    self._pack(b, out=out)
            obs_metrics.WIRE_BYTES.inc(len(rows) * s * self._chunk_nbytes)
        if self._compact:
            for j, r in enumerate(rows):
                lists = [
                    b.pairs if isinstance(b, PackedShard) else self._row_pairs(b)
                    for b in (batches[r] for batches in rounds)
                    if b is not None
                ]
                off = self._table_off + j * self._table_stride
                _, raw, emitted = pack_pair_table(
                    lists, cfg, self._pair_cap, use_native=self.use_native,
                    out=view[off : off + self._table_nbytes],
                )
                obs_metrics.ALIVE_PAIRS_RAW.inc(raw)
                obs_metrics.ALIVE_PAIRS_EMITTED.inc(emitted)
            obs_metrics.WIRE_BYTES.inc(len(rows) * self._table_nbytes)
        host = self._stager.hosts[slot]
        copies = {}
        for dev in self.devices:
            with _on(dev):
                buf = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
                buf.copy_(host, non_blocking=True)
                copies[dev] = buf
        self._stager.record(slot, self._token())
        self._fold(copies, len(rounds))
        self._queue.launched(self._token(), len(rounds))
        self.dispatches += len(rounds)

    def _fold(self, copies: dict, n_rounds: int) -> None:
        """Every round's local shards, in round order, then the local
        rows' pair tables: each shard on its device, from that device's
        copy."""
        cfg, ccfg = self.config, self.chunk_config
        s = cfg.space_shards
        rows = len(self.local_rows)
        ordered = cfg.count_alive_keys and not self._compact and s > 1
        for k in range(n_rounds):
            for j in range(rows):
                unpacked = {}

                def chunk(dev, c):
                    if (dev, c) not in unpacked:
                        row = copies[dev][
                            ((k * rows + j) * s + c) * self._stride :
                        ][: self._chunk_nbytes]
                        unpacked[dev, c] = unpack_device(row, ccfg)
                    return unpacked[dev, c]

                for c in range(s):
                    dev, _ = self._where[j * s + c]
                    with _on(dev):
                        analyzer_step(
                            self._shards[j * s + c], chunk(dev, c), ccfg,
                            scratch=self._scratch[dev], space_index=c,
                            space_chunks=(
                                [chunk(dev, o) for o in range(s)] if ordered else None
                            ),
                        )
        if self._compact:
            for j in range(rows):
                off = self._table_off + j * self._table_stride
                for c in range(s):
                    dev, _ = self._where[j * s + c]
                    with _on(dev):
                        apply_pair_table(
                            self._shards[j * s + c],
                            unpack_pair_table_device(
                                copies[dev][off : off + self._table_nbytes],
                                cfg, self._pair_cap,
                            ),
                            ccfg, scratch=self._scratch[dev], space_index=c,
                        )

    def _token(self):
        """Completes with the work enqueued so far on every device of the
        mesh: one CUDA event per card, `base.READY` on the host."""
        events = []
        for dev in self.devices:
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                events.append(event)
        if not events:
            return READY
        return events[0] if len(events) == 1 else _Tokens(events)

    def drain_dispatch(self) -> None:
        """Retire the in-flight folds: a local wait, never a collective
        (the engine's failure path calls it on one process alone)."""
        self._queue.drain()

    # -- lockstep (several controllers) ---------------------------------------

    def global_any(self, flag: bool) -> bool:
        """Whether any process's ``flag`` is set: the per-round agreement
        (does anyone still have data?) and the scan-issue flags.  A
        collective under several controllers, with the same result on
        every process."""
        if not self._multiprocess:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def gather_telemetry(self) -> "list[dict]":
        """Every process's registry snapshot, in process order, the same
        list on every process (a collective under several controllers)."""
        snap = default_registry().snapshot()
        if not self._multiprocess:
            return [snap]
        docs: list = [None] * process_count()
        dist.all_gather_object(docs, {"pid": process_index(), "telemetry": snap})
        return [doc["telemetry"] for doc in sorted(docs, key=lambda d: d["pid"])]

    @property
    def controller_index(self) -> int:
        """This process's index (0 with one controller): the engine
        prefixes its ingest workers' labels with it, so that the gathered
        registries' worker samples stay apart."""
        return process_index()

    @property
    def snapshot_scope(self):
        """None with one controller; ``(pid, nproc, local_rows)`` under
        several, and the engine then snapshots per process through
        `get_state_local`/`set_state_local` (`checkpoint._snapshot_path`)."""
        if not self._multiprocess:
            return None
        return process_index(), process_count(), list(self.local_rows)

    # -- snapshots -----------------------------------------------------------

    def _host_leaves(self, paths=None) -> "dict[str, np.ndarray]":
        """Leaf path → the stacked host array of the local shards, rows in
        shard order (the bitmap as ``[L·S, W/S]`` int32 patterns)."""
        out = {}
        for dev, stack in self._stacks.items():
            rows = [i for i, (where, _) in enumerate(self._where) if where == dev]
            with _on(dev):
                for path, t in _leaves(stack).items():
                    if paths is not None and path not in paths:
                        continue
                    host = t.to("cpu", copy=True).numpy()
                    if path not in out:
                        out[path] = np.empty(
                            (len(self._where),) + host.shape[1:], host.dtype
                        )
                    out[path][rows] = host
        return out

    def get_state(self) -> "dict[str, np.ndarray]":
        """Retire the in-flight folds and copy the stacked state to the
        host in the reference's layout: ``[D·S, ...]`` record-parallel
        leaves, the bitmap ``[D, W]`` (uint32).  One controller only: the
        state of several spans their processes."""
        self._single_controller("get_state")
        return self.get_state_local()

    def set_state(self, leaves: "dict[str, np.ndarray]") -> None:
        """Copy stacked leaves (`get_state`'s form) into the state's own
        tensors; one controller only."""
        self._single_controller("set_state")
        self.set_state_local(leaves)

    def _single_controller(self, name: str) -> None:
        if self._multiprocess:
            raise ValueError(
                f"{name} spans every process's rows; under several "
                f"controllers use {name}_local"
            )

    def get_state_local(self) -> "dict[str, np.ndarray]":
        """`get_state` of this process's L data rows: ``[L·S, ...]``
        record-parallel leaves, the bitmap ``[L, W]`` (the reference's
        process-local layout)."""
        self._queue.drain()
        out = self._host_leaves()
        if "alive.words" in out:
            out["alive.words"] = i32_to_u32(
                out["alive.words"].reshape(len(self.local_rows), -1)
            )
        return out

    def set_state_local(self, leaves: "dict[str, np.ndarray]") -> None:
        """Copy this process's stacked leaves (`get_state_local`'s form)
        into the state's own tensors."""
        want = _leaves(next(iter(self._stacks.values())))
        if set(leaves) != set(want):
            raise ValueError(
                f"state leaves {sorted(leaves)} do not match the backend's "
                f"{sorted(want)}"
            )
        n = len(self._where)
        for path, arr in leaves.items():
            if path == "alive.words":
                arr = u32_to_i32(arr).reshape(n, -1)
            arr = np.require(arr, requirements="C")
            for dev, stack in self._stacks.items():
                rows = [i for i, (where, _) in enumerate(self._where) if where == dev]
                dst = _leaves(stack)[path]
                if (len(arr), *arr.shape[1:]) != (n, *dst.shape[1:]):
                    raise ValueError(
                        f"state leaf {path} has shape {arr.shape}, the "
                        f"backend's {(n, *dst.shape[1:])}"
                    )
                with _on(dev):
                    dst.copy_(torch.from_numpy(np.ascontiguousarray(arr[rows])))

    # -- finalize ------------------------------------------------------------

    def _alive_words(self) -> np.ndarray:
        """The bitmap's local data rows ORed on the device, one space
        shard's slot range at a time, then copied to the host, and ORed
        across the processes there (uint32[W])."""
        s = self.config.space_shards
        parts = []
        for c in range(s):
            acc = None
            for j in range(len(self.local_rows)):
                dev, row = self._where[j * s + c]
                words = self._stacks[dev].alive.words[row]
                if acc is None:
                    acc_dev = dev
                    with _on(dev):
                        acc = words.clone()
                else:
                    with _on(acc_dev):
                        acc.bitwise_or_(words.to(acc_dev))
            with _on(acc_dev):
                parts.append(acc.to("cpu").numpy())
            del acc
        words = np.concatenate(parts)
        if self._multiprocess:
            words = _all_reduce(words, dist.ReduceOp.BOR)
        return i32_to_u32(words)

    def finalize(self) -> TopicMetrics:
        """Retire the in-flight folds, reduce the local rows of every leaf
        (`models.state.merge_rows`: sums, min/max, HLL max, DDSketch sum)
        and the bitmap's local rows (OR, on the device), then across the
        processes (one all-reduce per leaf by its merge law, in leaf
        order, the bitmap last), and derive the metrics on the host: the
        same metrics on every process."""
        self._queue.drain()
        small = [p for p in _leaves(next(iter(self._stacks.values())))
                 if p != "alive.words"]
        leaves = merge_rows(self._host_leaves(small))
        if self._multiprocess:
            leaves = {path: _all_reduce(arr, _REDUCE_OP[MERGE_LAW[path]])
                      for path, arr in sorted(leaves.items())}
        if self.config.count_alive_keys:
            leaves["alive.words"] = self._alive_words()
        return metrics_from_state(leaves, self.config, self.init_now_s)
