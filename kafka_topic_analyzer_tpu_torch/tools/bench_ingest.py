"""Host-ingest capacity benchmark: where does the wire drain bind, and what
is the per-core ceiling?  (Port of the reference's ``tools/bench_ingest.py``;
all of it is host code, the same measurements over the port's wire client,
native shim, packer and parallel ingest.)

    python -m kafka_topic_analyzer_tpu_torch.tools.bench_ingest \
        --records 2000000 --repeat 1 --streams 2

Measurements, one JSON line (the last stdout line):

1. ``drain_msgs_per_sec`` — wall-clock drain through a real loopback TCP
   broker (`tools/bench_e2e.BrokerProcess`; ``--streams N`` drains N
   brokers at once from N threads of this process).  The serving process
   shares the host's cores, so this understates a dedicated core.
2. ``drain_cpu_msgs_per_sec`` — records / client-process CPU seconds
   (``os.times``; the spawned broker is excluded): the rate one dedicated
   core sustains including its share of kernel TCP receive work, beside
   the GIL-stall percentiles (``gil_stall_*``) of the drain.
3. ``pipeline_msgs_per_sec`` — the socket-free client pipeline (native
   record-set scan + decode + range-accept + re-batching) over pre-built
   wire buffers: the per-core capacity when bytes arrive for free; with
   ``--fused`` (the default) also decode→pack chained (decode, re-batch,
   `packing.pack_batch`) against fused (`packing.FusedPackSink`), and
   with ``--pipeline-threads N`` each of them in N threads at once.
4. ``scan_msgs_per_sec`` (``--workers N``) — one topic drained through N
   partition-sharded workers of `parallel.ingest.ParallelIngest`, the
   engine's ``--ingest-workers`` fan-in without a backend: the ingest
   ceiling, with per-worker records and rates, and the doctor's
   occupancy evidence under ``--flight-record``.

No device is touched: the figures are the host's (name its CPU count,
``nproc``, beside them).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import threading
import time

import numpy as np

from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc


class _StallSampler(threading.Thread):
    """Measures the client process's longest GIL-held stretches during a
    drain: a thread asking for a 1 ms sleep can only resume once it can
    re-acquire the GIL, so (observed - requested) bounds the serialized
    GIL-held share that would block a second drain thread (does a
    per-core rate times N cores survive the GIL?).  On a 1-core box, OS timeslices granted to the broker child
    land in the same delay, so this is an UPPER bound on GIL stalls."""

    def __init__(self) -> None:
        super().__init__(daemon=True)
        self.delays: "list[float]" = []
        # NB: not named _stop — threading.Thread uses a _stop() method
        # internally; shadowing it with an Event breaks join().
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            self.delays.append(time.perf_counter() - t0 - 0.001)

    def finish(self) -> "dict[str, float]":
        self._halt.set()
        self.join(2)
        if self.is_alive():
            # The sampler never confirmed stopping (a pathological stall
            # outlived the join timeout): computing percentiles would race
            # its ongoing appends — list growth mid-sort can misindex.
            # No numbers beat wrong numbers in a published benchmark.
            return {}
        # Snapshot only now that the thread has provably exited: the list
        # is quiescent, so sort + percentile indexing see one stable view.
        delays = list(self.delays)
        if not delays:
            return {}
        d = np.sort(np.asarray(delays))
        return {
            "gil_stall_p50_ms": round(float(d[len(d) // 2]) * 1e3, 2),
            "gil_stall_p99_ms": round(float(d[int(len(d) * 0.99)]) * 1e3, 2),
            "gil_stall_max_ms": round(float(d[-1]) * 1e3, 2),
        }


def _drain_stream(port: int, topic: str, batch_size: int, barrier,
                  out: "list", idx: int) -> None:
    """One stream's drain: own wire client, own loopback broker.  All
    streams rendezvous after connection setup so the timed window measures
    concurrent drains, not staggered ones."""
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource

    src = KafkaWireSource(f"127.0.0.1:{port}", topic)
    try:
        barrier.wait(timeout=120)
        got = 0
        t0 = time.perf_counter()
        for batch in src.batches(batch_size):
            got += len(batch)
        out[idx] = (got, time.perf_counter() - t0)
    finally:
        src.close()


def _patched_record_sets(templates: "list[bytes]", windows: int,
                         records_per_batch: int,
                         frames_per_set: int = 8) -> "list[bytes]":
    """Record sets of ``frames_per_set`` consecutive base_offset-patched
    template frames (the first 8 bytes of a v2 frame are not CRC-covered) —
    the same multi-frame-per-response shape real fetch responses have, so
    per-decode-call fixed costs are amortized like the wire client's."""
    out = []
    group = bytearray()
    for w in range(windows):
        t = bytearray(templates[w % len(templates)])
        struct.pack_into(">q", t, 0, w * records_per_batch)
        group += t
        if (w + 1) % frames_per_set == 0:
            out.append(bytes(group))
            group = bytearray()
    if group:
        out.append(bytes(group))
    return out


def measure_pipeline(record_sets: "list[bytes]", total_records: int,
                     batch_size: int, verify_crc: bool) -> "tuple[int, float]":
    """Drive scan → decode → accept → re-batch over in-memory buffers,
    mirroring the wire client's per-response hot path (kafka_wire.py
    fetch_leader phase 1 + accept_records + flush)."""
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import _chunk_to_batch
    from kafka_topic_analyzer_tpu_torch.io.native import (
        decode_record_set_native,
        scan_record_set_native,
    )
    from kafka_topic_analyzer_tpu_torch.records import RecordBatch

    total = total_records
    pend: "list[RecordBatch]" = []
    pend_count = 0
    n_out = 0
    t0 = time.perf_counter()
    for rs in record_sets:
        prescan = scan_record_set_native(rs, verify_crc)
        soa, used, covered = decode_record_set_native(
            rs, verify_crc, prescan=prescan
        )
        offs = soa["offsets"]
        hi = int(np.searchsorted(offs, total, "left"))
        pend.append(_chunk_to_batch(soa, slice(0, hi), 0))
        pend_count += hi
        if pend_count >= batch_size:
            out, pend, pend_count = RecordBatch.resplit(
                pend, batch_size, force=False
            )
            n_out += sum(len(b) for b in out)
    n_out += pend_count
    return n_out, time.perf_counter() - t0


def _bench_pack_config(partitions: int, batch_size: int):
    """The representative full-featured pack config both decode→pack
    referees share (alive bitmap + HLL — the default heavy path)."""
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig

    return AnalyzerConfig(
        num_partitions=partitions, batch_size=batch_size,
        count_alive_keys=True, enable_hll=True,
    )


def measure_pipeline_chained(record_sets: "list[bytes]", total_records: int,
                             batch_size: int, verify_crc: bool,
                             config) -> "tuple[int, float]":
    """The CHAINED decode→pack referee: the measure_pipeline hot path plus
    the shim's pack_batch over every re-batched buffer — the bytes leave
    the decode as SoA columns, get re-batched, and are read back by the
    packer."""
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import _chunk_to_batch
    from kafka_topic_analyzer_tpu_torch.io.native import (
        decode_record_set_native,
        scan_record_set_native,
    )
    from kafka_topic_analyzer_tpu_torch.packing import pack_batch
    from kafka_topic_analyzer_tpu_torch.records import RecordBatch

    total = total_records
    pend: "list[RecordBatch]" = []
    pend_count = 0
    n_out = 0
    t0 = time.perf_counter()
    for rs in record_sets:
        prescan = scan_record_set_native(rs, verify_crc)
        soa, used, covered = decode_record_set_native(
            rs, verify_crc, prescan=prescan
        )
        offs = soa["offsets"]
        hi = int(np.searchsorted(offs, total, "left"))
        pend.append(_chunk_to_batch(soa, slice(0, hi), 0))
        pend_count += hi
        if pend_count >= batch_size:
            out, pend, pend_count = RecordBatch.resplit(
                pend, batch_size, force=False
            )
            for b in out:
                pack_batch(b, config, use_native=True)
                n_out += len(b)
    if pend:
        out, pend, pend_count = RecordBatch.resplit(pend, batch_size, True)
        for b in out:
            pack_batch(b, config, use_native=True)  # partial tail packs with n_valid < B
            n_out += len(b)
    return n_out, time.perf_counter() - t0


def measure_pipeline_fused(record_sets: "list[bytes]", total_records: int,
                           batch_size: int, verify_crc: bool,
                           config) -> "tuple[int, float]":
    """The FUSED referee: the same record sets through
    FusedPackSink.append_record_set — one native pass from set bytes to
    packed rows, no SoA columns, no re-batching copy."""
    from kafka_topic_analyzer_tpu_torch.io.native import scan_record_set_native
    from kafka_topic_analyzer_tpu_torch.packing import FusedPackSink

    sink = FusedPackSink(config, batch_size, dense_of=lambda p: p)
    n_out = 0
    t0 = time.perf_counter()
    for rs in record_sets:
        prescan = scan_record_set_native(rs, verify_crc)
        n, _, _, _ = sink.append_record_set(
            rs, 0, total_records, 0, verify_crc, prescan=prescan
        )
        n_out += n
        sink.take_completed()
    sink.flush()
    sink.take_completed()
    return n_out, time.perf_counter() - t0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=20_000_000)
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--records-per-batch", type=int, default=4096)
    ap.add_argument("--templates", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=1 << 20)
    ap.add_argument("--vmin", type=int, default=100)
    ap.add_argument("--vmax", type=int, default=420)
    ap.add_argument("--check-crcs", action="store_true")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also referee the fused decode→pack pass against "
                         "the chained decode→SoA→pack path (single-thread "
                         "always; per-thread when --pipeline-threads is "
                         "set).  --no-fused skips both packed referees")
    ap.add_argument("--repeat", type=int, default=3,
                    help="pipeline passes; the best is the headline "
                         "(capacity is a max — interference on a shared box "
                         "only subtracts), with the median and the full run "
                         "list reported alongside")
    ap.add_argument("--skip-drain", action="store_true",
                    help="only the socket-free pipeline measurement")
    ap.add_argument("--pipeline-threads", type=int, default=0,
                    help="also run the socket-free pipeline concurrently "
                         "in N threads (private buffer copies — budget "
                         "~records x 300 B of RAM PER THREAD).  The "
                         "referee for the GIL-share claim: client compute "
                         "only, no loopback-TCP kernel time.  0 = skip")
    ap.add_argument("--workers", type=int, default=0,
                    help="also measure ONE scan drained through N "
                         "partition-sharded parallel-ingest workers "
                         "(parallel/ingest.py fan-in; the in-scan analog "
                         "of --streams' N independent scans).  Reports the "
                         "aggregate wall rate, records/client-CPU-second, "
                         "per-worker rates, and the GIL-stall percentiles "
                         "(scan_gil_stall_*).  0 = skip")
    ap.add_argument("--flight-record", action="store_true",
                    help="sample the --workers fan-in drain with the "
                         "pipeline flight recorder (obs/flight.py) and "
                         "report the doctor's occupancy evidence (worker "
                         "busy fraction, queue-empty share).  This bench "
                         "has no engine drive loop, so there is no stage "
                         "verdict — the evidence quantifies the ingest "
                         "ceiling the manual ledger used to eyeball")
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent loopback drains in ONE process (each "
                         "stream gets its own broker child + wire client + "
                         "thread).  Tests whether the leader-parallel pool's "
                         "N-core scaling claim survives the GIL: the native "
                         "decode releases the GIL (ctypes.CDLL), so N "
                         "streams should aggregate close to the 1-stream "
                         "CPU rate x available cores, and the reported "
                         "gil_stall_* percentiles bound the serialized share")
    args = ap.parse_args(argv)
    if args.streams < 1:
        ap.error("--streams must be >= 1")
    if args.workers < 0:
        ap.error("--workers must be >= 0")

    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import (
        BrokerProcess,
        build_templates,
    )

    doc: "dict[str, object]" = {"metric": "ingest", "nproc": os.cpu_count()}

    # The socket-free pipeline (and its fused/chained referee) measure the
    # NATIVE decode path; without the shim there is nothing to referee —
    # note it and keep the drain/worker sections (python-chain) running.
    from kafka_topic_analyzer_tpu_torch.io.native import native_status

    native_ok, native_why = native_status()
    if not native_ok:
        doc["pipeline_skipped"] = f"native-{native_why}"
        print(
            f"bench_ingest: native shim unavailable ({native_why}); "
            "skipping the pipeline/referee sections", file=sys.stderr,
        )

    # --- 3: socket-free pipeline capacity --------------------------------
    templates = build_templates(
        args.records_per_batch, args.templates, args.vmin, args.vmax
    )
    windows = max(args.records // args.records_per_batch, 1)
    record_sets = _patched_record_sets(
        templates, windows, args.records_per_batch
    )
    rates = []
    for _ in range(max(args.repeat, 1) if native_ok else 0):
        n, dt = measure_pipeline(
            record_sets, windows * args.records_per_batch, args.batch_size,
            args.check_crcs,
        )
        rates.append(n / dt)
    # Best is the headline (capacity is a max: on a shared box interference
    # only subtracts), but the median and full run list ship alongside so a
    # lucky draw over a wide spread cannot read as the typical rate.
    if rates:
        doc["pipeline_msgs_per_sec"] = round(max(rates))
        doc["pipeline_msgs_per_sec_median"] = round(
            float(np.median(np.asarray(rates)))
        )
        doc["pipeline_runs"] = [round(r) for r in rates]
        print(
            f"bench_ingest: pipeline {n} records, best of {len(rates)}: "
            f"{max(rates):,.0f}/s, median {doc['pipeline_msgs_per_sec_median']:,}/s "
            "(socket-free)", file=sys.stderr,
        )

    # --- 3a: fused vs chained decode→pack referee ------------------------
    # One native pass from record-set bytes to packed rows vs decode→SoA columns→re-batch→pack.  Same buffers,
    # same acceptance window, same pack config (alive bitmap + HLL).
    if args.fused and native_ok:
        pcfg = _bench_pack_config(args.partitions, args.batch_size)
        chained_rates, fused_rates = [], []
        for _ in range(max(args.repeat, 1)):
            n, dt = measure_pipeline_chained(
                record_sets, windows * args.records_per_batch,
                args.batch_size, args.check_crcs, pcfg,
            )
            chained_rates.append(n / dt)
            n2, dt2 = measure_pipeline_fused(
                record_sets, windows * args.records_per_batch,
                args.batch_size, args.check_crcs, pcfg,
            )
            assert n2 == n, (n2, n)
            fused_rates.append(n2 / dt2)
        doc["pipeline_chained_pack_msgs_per_sec"] = round(max(chained_rates))
        doc["pipeline_fused_pack_msgs_per_sec"] = round(max(fused_rates))
        doc["fused_speedup"] = round(max(fused_rates) / max(chained_rates), 3)
        doc["pipeline_chained_pack_runs"] = [round(r) for r in chained_rates]
        doc["pipeline_fused_pack_runs"] = [round(r) for r in fused_rates]
        print(
            f"bench_ingest: decode+pack chained best {max(chained_rates):,.0f}/s, "
            f"fused best {max(fused_rates):,.0f}/s "
            f"({doc['fused_speedup']}x)", file=sys.stderr,
        )

    # --- 3b: socket-free pipeline, N concurrent threads ------------------
    # Referee for the parallel-ingest design claim: the client's fetch→decode→pack compute parallelizes across threads
    # because the native path releases the GIL.  Measured WITHOUT sockets,
    # so loopback-TCP kernel time (which inflates the --workers scan's sys
    # CPU on a shared box) cannot blur the picture.
    if args.pipeline_threads and native_ok:
        import threading as _threading
        import time as _time

        n_thr = args.pipeline_threads
        sets = [record_sets] + [
            _patched_record_sets(templates, windows, args.records_per_batch)
            for _ in range(n_thr - 1)
        ]  # private buffers per thread: no shared-cache flattery
        total = windows * args.records_per_batch
        out: "list" = [None] * n_thr
        barrier = _threading.Barrier(n_thr + 1)

        def _thr(i: int) -> None:
            barrier.wait(timeout=120)
            try:
                out[i] = measure_pipeline(
                    sets[i], total, args.batch_size, args.check_crcs
                )
            except BaseException as e:  # surface on the main thread
                out[i] = e

        threads = [
            _threading.Thread(target=_thr, args=(i,), daemon=True)
            for i in range(n_thr)
        ]
        for t in threads:
            t.start()
        barrier.wait(timeout=120)
        c0 = os.times()
        t0 = _time.perf_counter()
        for t in threads:
            t.join()
        wall = _time.perf_counter() - t0
        c1 = os.times()
        del sets
        failed = [o for o in out if isinstance(o, BaseException) or o is None]
        if failed:
            raise RuntimeError(
                f"{len(failed)} pipeline thread(s) failed: "
                f"{failed[0]!r} — the aggregate rate would be meaningless"
            )
        got = sum(o[0] for o in out)
        cpu = (c1.user - c0.user) + (c1.system - c0.system)
        doc["pipeline_threads"] = n_thr
        doc["pipeline_mt_msgs_per_sec"] = round(got / wall)
        doc["pipeline_mt_cpu_msgs_per_sec"] = (
            round(got / cpu) if cpu else None
        )
        print(
            f"bench_ingest: pipeline x{n_thr} threads {got} records "
            f"wall={wall:.2f}s cpu={cpu:.2f}s ({got / wall:,.0f}/s)",
            file=sys.stderr,
        )

        # Fused twin of the referee: does removing the SoA share (the
        # GIL-held numpy slice/concat in _chunk_to_batch + resplit) close
        # the 4+ thread droop?  Private buffers AND private sinks per
        # thread.
        if args.fused:
            pcfg = _bench_pack_config(args.partitions, args.batch_size)
            for fn, key in (
                (measure_pipeline_chained, "chained"),
                (measure_pipeline_fused, "fused"),
            ):
                sets = [record_sets] + [
                    _patched_record_sets(
                        templates, windows, args.records_per_batch
                    )
                    for _ in range(n_thr - 1)
                ]
                out = [None] * n_thr
                barrier = _threading.Barrier(n_thr + 1)

                def _thr_packed(i: int) -> None:
                    barrier.wait(timeout=120)
                    try:
                        out[i] = fn(
                            sets[i], total, args.batch_size,
                            args.check_crcs, pcfg,
                        )
                    except BaseException as e:
                        out[i] = e

                threads = [
                    _threading.Thread(
                        target=_thr_packed, args=(i,), daemon=True
                    )
                    for i in range(n_thr)
                ]
                for t in threads:
                    t.start()
                barrier.wait(timeout=120)
                c0 = os.times()
                t0 = _time.perf_counter()
                for t in threads:
                    t.join()
                wall = _time.perf_counter() - t0
                c1 = os.times()
                del sets
                failed = [
                    o for o in out
                    if isinstance(o, BaseException) or o is None
                ]
                if failed:
                    raise RuntimeError(
                        f"{len(failed)} {key} pack thread(s) failed: "
                        f"{failed[0]!r}"
                    )
                got = sum(o[0] for o in out)
                cpu = (c1.user - c0.user) + (c1.system - c0.system)
                doc[f"pipeline_mt_{key}_pack_msgs_per_sec"] = round(got / wall)
                doc[f"pipeline_mt_{key}_pack_cpu_msgs_per_sec"] = (
                    round(got / cpu) if cpu else None
                )
                print(
                    f"bench_ingest: decode+pack {key} x{n_thr} threads "
                    f"{got} records wall={wall:.2f}s cpu={cpu:.2f}s "
                    f"({got / wall:,.0f}/s)", file=sys.stderr,
                )

    # --- 1+2: loopback TCP drain + client-CPU rate -----------------------
    del record_sets, templates  # ~6 GB at default size; the drain phase
    #                             must not run (or swap) under dead RSS
    if not args.skip_drain:
        from contextlib import ExitStack

        n_streams = args.streams
        pwindows = max(args.records // (n_streams * args.partitions *
                                        args.records_per_batch), 1)
        with ExitStack() as stack:
            ports = [
                stack.enter_context(BrokerProcess(
                    topic=f"bench-ingest-{i}", partitions=args.partitions,
                    windows=pwindows, R=args.records_per_batch,
                    n_templates=args.templates, vmin=args.vmin,
                    vmax=args.vmax, compression=kc.COMPRESSION_NONE,
                    tombstone_every=0, brokers=1,
                ))
                for i in range(n_streams)
            ]
            results: "list" = [None] * n_streams
            barrier = threading.Barrier(n_streams + 1)
            threads = [
                threading.Thread(
                    target=_drain_stream,
                    args=(ports[i], f"bench-ingest-{i}", args.batch_size,
                          barrier, results, i),
                    daemon=True,
                )
                for i in range(n_streams)
            ]
            for t in threads:
                t.start()
            barrier.wait(timeout=120)  # all clients connected; start clock
            sampler = _StallSampler()
            sampler.start()
            c0 = os.times()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            c1 = os.times()
            doc.update(sampler.finish())
        if any(r is None for r in results):
            raise RuntimeError("a drain stream died; see stderr")
        got = sum(r[0] for r in results)
        cpu = (c1.user - c0.user) + (c1.system - c0.system)
        # Aggregate rate over the CONCURRENT window (all streams started
        # together; wall is until the last finishes).
        doc["drain_msgs_per_sec"] = round(got / wall)
        doc["drain_cpu_msgs_per_sec"] = round(got / cpu) if cpu else None
        doc["drain_user_cpu_s"] = round(c1.user - c0.user, 2)
        doc["drain_sys_cpu_s"] = round(c1.system - c0.system, 2)
        if n_streams > 1:
            doc["streams"] = n_streams
            doc["stream_msgs_per_sec"] = [
                round(r[0] / r[1]) for r in results
            ]
        print(
            f"bench_ingest: drain {got} records x{n_streams} streams "
            f"wall={wall:.2f}s cpu={cpu:.2f}s", file=sys.stderr,
        )

    # --- 4: single-scan parallel ingest (--workers N) --------------------
    # The in-scan analog of --streams: ONE topic, ONE scan, N
    # partition-sharded worker streams merged through the deterministic
    # fan-in (parallel/ingest.py) — exactly what `--ingest-workers N` runs
    # inside the engine, minus the backend (so this measures the ingest
    # ceiling, not device dispatch).  Broker nodes match the worker count
    # so leaders spread like a real multi-broker cluster.  Runs even under
    # --skip-drain (that flag skips the independent-streams drain; this is
    # its own measurement).
    if args.workers:
        import time as _time

        from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
        from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
        from kafka_topic_analyzer_tpu_torch.parallel.ingest import (
            ParallelIngest,
            shard_partitions,
        )
        from kafka_topic_analyzer_tpu_torch.results import IngestStats

        wwindows = max(
            args.records // (args.partitions * args.records_per_batch), 1
        )
        runs = []
        for _ in range(max(args.repeat, 1)):
            if args.flight_record:
                # The doctor's worker busy/stall evidence reads the
                # process-global CUMULATIVE counters; without a reset,
                # repeat N's evidence would blend repeats 1..N-1 (worker
                # labels recur across runs).  Per-run isolation — the
                # per_worker accounting below deltas against `before`
                # either way, so it is reset-agnostic.
                default_registry().reset()
            with BrokerProcess(
                topic="bench-ingest-w", partitions=args.partitions,
                windows=wwindows, R=args.records_per_batch,
                n_templates=args.templates, vmin=args.vmin, vmax=args.vmax,
                compression=kc.COMPRESSION_NONE, tombstone_every=0,
                brokers=min(args.workers, args.partitions),
            ) as port:
                src = KafkaWireSource(f"127.0.0.1:{port}", "bench-ingest-w")
                groups = shard_partitions(src.partitions(), args.workers)
                before = IngestStats.from_telemetry(
                    default_registry().snapshot()
                )
                recorder = None
                if args.flight_record:
                    from kafka_topic_analyzer_tpu_torch.obs import (
                        flight as obs_flight,
                    )

                    recorder = obs_flight.FlightRecorder(interval_s=0.05)
                    obs_flight.set_active(recorder)
                    recorder.start()
                sampler = _StallSampler()
                sampler.start()
                c0 = os.times()
                t0 = _time.perf_counter()
                pool = ParallelIngest(src, args.batch_size, groups, depth=2)
                wids = [str(w.wid) for w in pool.workers]
                got = 0
                try:
                    for batch, _staged in pool:
                        got += len(batch)
                    wall = _time.perf_counter() - t0
                    c1 = os.times()
                finally:
                    pool.close()
                    src.close()
                    # A failing drain must not leak a live sampler as the
                    # process-wide active recorder (same rule as
                    # bench_e2e); the stopped series stays readable.
                    if recorder is not None:
                        from kafka_topic_analyzer_tpu_torch.obs import (
                            flight as obs_flight,
                        )

                        recorder.stop()
                        obs_flight.set_active(None)
                stalls = sampler.finish()
                flight_evidence = None
                if recorder is not None:
                    from kafka_topic_analyzer_tpu_torch.obs import doctor

                    d = doctor.diagnose(
                        default_registry().snapshot(),
                        flight=recorder.series(),
                    )
                    flight_evidence = {
                        k: round(v, 4) for k, v in d.evidence.items()
                    }
            after = IngestStats.from_telemetry(default_registry().snapshot())
            runs.append({
                "flight": flight_evidence,
                "got": got, "wall": wall,
                "user": c1.user - c0.user, "sys": c1.system - c0.system,
                # Delta vs the pre-run snapshot, restricted to THIS pool's
                # workers: the registry is process-global and cumulative,
                # and stale worker labels from earlier runs must not ride
                # along at delta 0.
                "per_worker": {
                    w: int(after.workers.get(w, 0) - before.workers.get(w, 0))
                    for w in wids
                },
                "stalls": stalls,
            })
        # Best-of, like the pipeline measurement: capacity is a max — on a
        # shared box interference only subtracts.  The full run list ships
        # alongside so a lucky draw cannot read as the typical rate.
        best = max(runs, key=lambda r: r["got"] / r["wall"])
        got, wall = best["got"], best["wall"]
        cpu = best["user"] + best["sys"]
        doc["workers"] = min(args.workers, args.partitions)
        doc["scan_msgs_per_sec"] = round(got / wall)
        doc["scan_runs"] = [round(r["got"] / r["wall"]) for r in runs]
        doc["scan_cpu_msgs_per_sec"] = round(got / cpu) if cpu else None
        doc["scan_user_cpu_s"] = round(best["user"], 2)
        doc["scan_sys_cpu_s"] = round(best["sys"], 2)
        doc["scan_worker_records"] = best["per_worker"]
        doc["scan_worker_msgs_per_sec"] = {
            w: round(n / wall) for w, n in best["per_worker"].items()
        }
        doc.update({f"scan_{k}": v for k, v in best["stalls"].items()})
        if best.get("flight") is not None:
            doc["scan_flight_evidence"] = best["flight"]
            per = ", ".join(
                f"{k.replace('_', '-')} {v * 100:.0f}%"
                for k, v in sorted(best["flight"].items())
            )
            print(f"bench_ingest: flight evidence: {per}", file=sys.stderr)
        print(
            f"bench_ingest: single scan x{args.workers} workers drained "
            f"{got} records, best of {len(runs)}: {got / wall:,.0f}/s "
            f"(wall={wall:.2f}s cpu={cpu:.2f}s)", file=sys.stderr,
        )

    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
