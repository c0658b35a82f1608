#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # all phases, one card

Phases, in order; any failure exits non-zero:

- build: compiles every CUDA kernel of the port and its native ingest
  shim from the sources in this checkout (one ``nvcc`` per kernel and one
  ``g++``, all started together), prints each build's time, the
  compiler's register report, the host's CPU count and the shim's
  ``native_status()``;
- kernel: ``counters_merge`` on CUDA against its plain PyTorch version at
  P in {1, 16, 300, 32767}, with 2^32 carries, values at I64_MAX and
  zeros, and its global sums (``overall_size``/``overall_count``) started
  near I64_MAX so they wrap, exact equality.  Then ``counters_update``
  against its plain version, sums included, at B = 2^18 with lengths up
  to 2^24 - 1, at P in {1, 16, 300, 877, 4096, 32767} (its shared-memory
  and its global-atomic paths), in three record orders: random partitions
  with a 10% invalid tail, the scan's round-robin order, and runs of one
  partition (what a Kafka fetch delivers); exact equality.  Then each
  kernel and each yardstick at the scan's shape (P = 16, B = 2^18) gets
  three times: back to back (CUDA events around calls issued one after
  the other; where the host is slower than the device, this is the
  host's rate), on the device (the same with the host ahead of the device
  behind a spin kernel), and on the host (us per call, no synchronize).
  The yardsticks, which the port never calls: the plain versions, one
  ``torch.add``, the chain the fused merge replaces (``torch.add`` and the
  five launches of the v5 step's global sums), one ``index_add_`` of a
  prebuilt ``[B, 7]`` contribution tensor, and the two ways to get the
  current stream's handle;
- identity: the port's CLI at partitions=4, messages=200000, keys=50000
  with the 2^32-slot alive bitmap: the synthetic source in wire v5 and
  wire v4, each on ``cuda`` and on ``cpu``, and v5 with
  ``--alive-compaction off`` on ``cuda``, each with ``--native on`` and
  ``--native off``; then a segment-file dump of the same spec written by
  the port's ``make_segments``, scanned fused (``--native on``) and
  chained (``--native off``), in v5 and v4, on ``cuda`` and ``cpu``.
  All reports must be byte-identical apart from the two timing lines, and
  each ``cuda`` run must launch its wire format's kernel and not the
  other;
- scan: the full-size synthetic scan (partitions=16, messages=1000000,
  keys=3000000: 16M records, 512 MiB alive bitmap, per-partition HLL and
  quantiles) on ``cuda`` with ``--native on``, through the CLI's own
  setup, engine and backend, once in wire v5 and once in wire v4; then
  the same spec dumped to ``.ktaseg`` files (480 MB of columns, under
  ``build/``, deleted at the end) and scanned the same way with
  ``--source segfile`` (the fused path).  Both kernels' launch counters
  are zeroed just before each scan and read just after: the wire
  format's kernel must have launched once per dispatch of the backend
  and the other kernel never.  The alive-key count of each scan must
  equal a numpy replay of the spec's records, last writer wins per
  bitmap slot, in the scan's record order: the synthetic source
  interleaves the partitions, the segment files come one partition after
  the other, and keys of different partitions whose 32-bit hashes collide
  make the two counts differ (by 2 at this size).  All other report lines
  must be byte-identical across the four scans, timing lines aside.
  Each scan prints a ``breakdown`` line of its per-dispatch host and
  device costs;
- kafka: the port's Kafka wire source against the port's template broker
  (``tools/bench_e2e.BrokerProcess``, a child process serving base-offset
  patched template batches over loopback TCP).  Identity: a topic of 4
  partitions x 50 windows of 1,000 records (200,000 records, values
  100-300 B, one record in ten a tombstone, 16 templates), scanned
  through ``cli.run`` (``--source kafka`` is the default) in wire v5, v4
  and compaction off, on ``cuda`` and ``cpu``, fused (``--native on``)
  and chained (``--native off``), at batch 65,536 (four rows); the same
  topic from an lz4 and a zstd broker (fused, so every frame takes the
  decoded-batch fallback, counted by reason on the sink); one scan with
  ``--dump-segments`` and the segment-file scan of that dump.  Every
  report must be byte-identical (timing lines aside), each ``cuda`` run
  must launch its format's kernel and not the other, the fused
  uncompressed runs must count no fallback and the compressed ones one
  per record.  Scan: 16 partitions x 250 windows of 4,000 records (16M
  records, 64 templates: 256,000 keys), on ``cuda`` with ``--native on``,
  batch 2^18 and the 2^32-slot bitmap, in v5 and in v4: the format's
  kernel must launch once per dispatch (62) and the other never; every
  exact metric (per-partition counters, byte sums, size and time
  extremes, totals, alive keys) must equal numpy's values from the
  decoded templates; the two reports must be byte-identical.  Each scan
  prints a ``breakdown kafka`` line: the worker's host ms per row (fetch
  wait, fused decode→pack, the stage's pair table), device copy and fold
  ms (CUDA events), the busy share;
- oracle: on the Kafka identity topic from each of the three brokers,
  the numpy exact oracle (``--backend cpu``) and the card (``--backend
  gpu``) with ``-c --distinct-keys --quantiles
  --distinct-keys-per-partition --extremes-table``: every exact line
  equal; each HLL estimate printed beside the oracle's exact count and
  each size quantile beside the exact one, within DESIGN.md §7's
  budgets; an oracle scan in a child process must leave CUDA
  uninitialised and the torch backend unimported;
- doctor: the 16M-record Kafka v5 and v4 scans and the segment-file v5
  scan again through the CLI's telemetry session with ``--stats
  --flight-record --events-jsonl F --trace-json F``: each BOTTLENECK
  verdict, its stage shares and its throttle-wait, fetch and decode
  evidence are printed; each report must equal the scan phase's (and,
  from Kafka, the template expectations), the trace's stage totals must
  agree with ``--stats`` within 5% and cover 90-100% of the host wall
  around ``cli.run``, each scan must book 62 ``kta_scan_batches_total``
  and launch its format's kernel 62 times, and its events must open and
  close the scan;
- telemetry cost: the 16M-record Kafka v5 scan with the doctor's flags
  and without them, in turns (on, off, on, off), records/s of each, each
  report held against the scan phase's;
- profiler: the 16M-record segment-file v5 and v4 scans with
  ``--profile-dir``: the ``torch.profiler`` trace's launches and device
  time of each kernel (its ``__global__`` name), and the share of the wall
  that all device kernels and copies take beside the ``breakdown`` busy
  share of the same scan; the format's kernel must appear 62 times, unless
  the trace holds no CUDA activity at all, which is printed as a finding;
- snapshot: the 16M-record segment-file v5 and v4 scans and the Kafka v5
  scan with snapshots under ``build/`` every 2 s, each killed half-way
  (its ingest stream raises after 31 of its 62 rows), then resumed by a fresh
  source and backend: the snapshot's ``records_seen`` must lie strictly
  inside the topic, the resumed scan must launch the format's kernel
  fewer than 62 times and the other never, and its report must equal
  the uninterrupted scan's.  The segment-file v5 run also prints the
  snapshot's own cost (the state's device→host copy, the 512 MiB bitmap
  among it, and the ``.npz`` write).  Then the segment-file v5 scan at
  ``--ingest-workers auto``, killed and resumed the same way (each of its
  n streams raises after 31 // n rows of its own): every line
  but the alive keys equals the uninterrupted report, and the alive keys
  equal a numpy last-writer-wins replay of the interrupted fan-in's order
  up to the snapshot and the resumed fan-in's after it;
- workers: the CLI's segment-file v5 and v4 scans at ``--ingest-workers
  1, 2, 4, auto``, and its Kafka v5 and v4 scans at ``1, 4, auto``
  against a template topic of the same records led by 4 brokers (one
  ``BrokerProcess`` child), each with ``--stats --flight-record``: every
  report line but the alive keys must equal the 1-worker scan phase's;
  the alive keys must equal the numpy replay in the fan-in's order
  (segment files: each worker's partitions one after the other, cut into
  rows of 2^18, rows merged round-robin) or, on the template topic, whose
  count no order changes, the 1-worker scan's and numpy's; the format's
  kernel must launch 62 to 62 + N - 1 times (each worker's last row is
  partial).  Each prints records/s, the doctor's verdict and stage
  shares, each worker's busy fraction from ``kta_ingest_worker_*``, the
  device busy share (the ``breakdown`` copy + fold per launch over the
  wall) and, for Kafka, the broker child's CPU seconds per record and
  its share of one core.

Every CLI run passes ``--quiet``; the torch backend on the host is
``--device cpu``.  Telemetry files and traces go under ``build/`` and are
deleted at the end.

Prints the card's name and power limit (``nvidia-smi``), a ``kernels``
JSON line (each kernel's back-to-back ``ms``, ``device_ms`` and
``host_us`` beside its plain version, its library call and its bound, and
for ``counters_merge`` the chain's ``chain_ms``; ``launches`` counts the
16M-record Kafka scan of the kernel's format, the slice's main path, and
``launches_by_path`` every full-size scan, the resumed and the N-worker
scans among them), and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: non-tensor-core fp32 rate as the rate of a CUDA-core integer add.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SIMT_OPS_PER_S = 67e12

FULL_PARTITIONS = 16
FULL_MESSAGES = 1_000_000
FULL_SPEC = f"partitions={FULL_PARTITIONS},messages={FULL_MESSAGES},keys=3000000"
IDENTITY_SPEC = "partitions=4,messages=200000,keys=50000"
ALIVE_BITS = 32
SKETCH_FLAGS = [
    "-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
    "--pallas", "--alive-bitmap-bits", str(ALIVE_BITS),
]
#: Segment dumps are written here (``build/`` is ignored by git) and
#: deleted at the end.
DUMP_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_segments"
#: Template-broker topics (`tools/bench_e2e.BrokerProcess` keywords): the
#: identity size, and the full-width scan from ``BASELINE.json`` config 2
#: (16 partitions) with config 1's ~200 B values, cut to 16M records.
KAFKA_IDENTITY = dict(topic="smoke-kafka", partitions=4, windows=50, R=1000,
                      n_templates=16, vmin=100, vmax=300, tombstone_every=10)
KAFKA_FULL = dict(topic="scan", partitions=16, windows=250, R=4000,
                  n_templates=64, vmin=100, vmax=300, tombstone_every=10)
KAFKA_IDENTITY_BATCH = 1 << 16
#: Telemetry sinks and profiler traces of the doctor, telemetry-cost and
#: profiler phases (under ``build/``, deleted at the end).
TELEMETRY_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_telemetry"
#: The flags of the doctor phase: the CLI's whole telemetry surface.
DOCTOR_FLAGS = ["--stats", "--flight-record"]
#: The oracle phase's sketch flags (the reference's oracle drive).
ORACLE_FLAGS = ["-c", "--alive-bitmap-bits", str(ALIVE_BITS), "--distinct-keys",
                "--quantiles", "--distinct-keys-per-partition", "--extremes-table"]
#: DESIGN.md §7's sketch budgets: HLL relative error within 4 sigma of
#: 1.04 / sqrt(2^p) against the oracle's exact count; DDSketch quantiles
#: within 2 alpha of the exact ones (plus one byte of the report's
#: rounding).
HLL_SIGMAS = 4.0
#: Busy share of each full-size scan from its ``breakdown`` line (CUDA
#: events), keyed by the scan's label.
BUSY_SHARE: dict = {}
#: Device ms per dispatch (the slot's copy plus the fold, CUDA events) of
#: each full-size scan's ``breakdown`` line, keyed by the scan's label.
DEVICE_MS: dict = {}
#: Records per row of every full-size scan (the CLI's ``--batch-size``).
SCAN_BATCH = 1 << 18
#: Snapshots of the snapshot phases (under ``build/``, deleted at the end).
SNAPSHOT_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_snapshots"
#: Seconds between the periodic snapshots of an interrupted scan.
SNAPSHOT_EVERY_S = 2.0
#: Rows an interrupted one-stream scan folds before it dies (of 62); each
#: of n streams dies after INTERRUPT_AFTER // n of its own.
INTERRUPT_AFTER = 31
#: The parallel-ingest sweeps' ``--ingest-workers`` values.
SEGFILE_WORKERS = ("1", "2", "4", "auto")
#: The superbatch phase's K, in-flight bound and ingest-worker counts, and
#: the row after which its killed scan dies (8 superbatches of 4 folded,
#: 2 rows pending for the failure path to fold).
SUPERBATCH = ["--superbatch", "4", "--dispatch-depth", "2"]
SUPERBATCH_WORKERS = ("1", "7")
SUPERBATCH_KILL_AFTER = 34
#: Where the remote phase's segment cache lives (deleted at the end).
CACHE_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_cache"
KAFKA_WORKERS = ("1", "4", "auto")
#: Advertised brokers of the parallel-ingest Kafka topic (partition p led
#: by broker p % 4, all served by one child process).
KAFKA_BROKERS = 4


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Back-to-back time of ``fn()`` in ms: CUDA events around ``iters``
    calls issued one after the other.  Where the host takes longer to
    enqueue a call than the device takes to run it, this is the host's
    enqueue rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fns: dict, calls: dict, reps: int = 7) -> dict:
    """Host cost of one call of each of ``fns`` (label → fn) in
    microseconds: the host clock around ``calls[label]`` calls with no
    synchronize, over the calls.  The functions take turns, ``reps`` times,
    so that a drift of the shared host's speed falls on all of them; the
    median of each function's runs."""
    import torch

    for fn in fns.values():
        for _ in range(10):
            fn()
    runs = {label: [] for label in fns}
    for _ in range(reps):
        for label, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls[label]):
                fn()
            runs[label].append((time.perf_counter() - t0) * 1e6 / calls[label])
    torch.cuda.synchronize()
    return {label: statistics.median(r) for label, r in runs.items()}


def device_ms(fn, iters: int) -> "tuple[float, int, int]":
    """Device time of one call of ``fn()`` in ms, with the host ahead of
    the device: a spin kernel (``torch.cuda._sleep``) is enqueued first, so
    the host enqueues the start event, the ``iters`` calls and the end event
    before the device reaches them; the events then time the kernels and
    the gaps between them, with no host cost in it.  The spin starts at
    four times the host's time for the calls (at 2 GHz).  Where the start
    event has already passed when the host has enqueued everything, the
    spin was too short or the launch queue was full: the spin is raised
    fourfold and the calls halved, and said so.  Returns (ms, spin cycles,
    calls)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    cycles = int(4 * (time.perf_counter() - t0) * 2e9) + 1_000_000
    torch.cuda.synchronize()
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the spin had not ended
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters, cycles, iters
        print(f"time: the spin of {cycles} cycles ended before the host had "
              f"enqueued {iters} calls; raising it fourfold, halving the calls")
        cycles *= 4
        iters = max(2, iters // 2)
    fail("device_ms: the host never got ahead of the device")


def three_times(cases, b2b_iters: int) -> dict:
    """Back-to-back ms, device ms and host us per call for each case
    ``(label, fn, launches per call)``; one printed line each.  The device
    and host runs make at most about 400 launches, well inside the
    device's queue of pending launches."""
    out = {}
    for label, fn, launches in cases:
        out[label] = t = {"ms": cuda_ms(fn, b2b_iters)}
        t["device_ms"], t["spin"], t["calls"] = device_ms(
            fn, max(4, 400 // launches)
        )
    hosts = host_us(
        {label: fn for label, fn, _ in cases},
        {label: max(10, 400 // launches) for label, _, launches in cases},
    )
    for label, t in out.items():
        t["host_us"] = hosts[label]
        print(f"time: {label}: back-to-back {t['ms']:.6f} ms, device "
              f"{t['device_ms']:.6f} ms ({t['calls']} calls behind a spin of "
              f"{t['spin']} cycles), host {t['host_us']:.3f} us/call")
    return out


def bound(nbytes: int, ops: int) -> "tuple[float, str]":
    """The least time the card could take (ms) and what sets it."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_SIMT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def merge_tables(p: int, rng):
    """Counter tables with the cases the TPU kernel's carry logic had to
    get right: 2^32 carries, values at I64_MAX (the add wraps), zeros."""
    import numpy as np

    i64_max = np.iinfo(np.int64).max
    a = rng.integers(-(1 << 62), 1 << 62, size=(p, 7), dtype=np.int64)
    d = rng.integers(0, 1 << 40, size=(p, 7), dtype=np.int64)
    a[:, 0], d[:, 0] = 0xFFFFFFFF, rng.integers(1, 1 << 33, size=p)
    a[:, 1], d[:, 1] = i64_max - 3, 3
    a[:, 2], d[:, 2] = i64_max, 1
    a[:, 3], d[:, 3] = 0, 0
    return a, d


def scalars(torch):
    """A pair of global-sum scalars on the card, started near I64_MAX so
    the sums wrap."""
    i64_max = (1 << 63) - 1
    return [torch.tensor(i64_max - 12345, dtype=torch.int64, device="cuda")
            for _ in range(2)]


def phase_kernel(torch, np, cm) -> dict:
    """``counters_merge`` against its plain version, global sums included,
    then its times at the scan's shape."""
    rng = np.random.default_rng(20261016)
    worst = 0
    for p in (1, 16, 300, 32767):
        a, d = merge_tables(p, rng)
        acc = torch.from_numpy(a).cuda()
        delta = torch.from_numpy(d).cuda()
        want_sums, got_sums = scalars(torch), scalars(torch)
        want = cm.counters_merge_plain(acc, delta, *want_sums)
        got = cm.counters_merge(acc.clone(), delta, *got_sums)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        sums = [(int(w), int(g)) for w, g in zip(want_sums, got_sums)]
        print(f"kernel: counters_merge P={p}: max_abs_err={err}, sums "
              f"(plain, kernel) {sums}")
        if not torch.equal(got, want):
            fail(f"counters_merge disagrees with its plain version at P={p}")
        if any(w != g for w, g in sums):
            fail(f"counters_merge's global sums disagree at P={p}: {sums}")
        worst = max(worst, err)

    p = 16  # the scan phase's shape
    a, d = merge_tables(p, rng)
    acc = torch.from_numpy(a).cuda()
    delta = torch.from_numpy(d).cuda()
    out = torch.empty_like(acc)
    size, count = scalars(torch)
    label = "counters_merge+sums"

    def chain():
        # The PyTorch calls the fused launch replaces: the add and the
        # v5 step's five launches of global sums.
        torch.add(acc, delta, out=out)
        size.add_(torch.sum(delta[:, 5] + delta[:, 6]))
        count.add_(torch.sum(delta[:, 0]))

    raw = torch._C._cuda_getCurrentRawStream
    cases = [
        (label, lambda: cm.counters_merge(acc, delta, overall_size=size,
                                          overall_count=count), 1),
        (f"{label} plain",
         lambda: cm.counters_merge_plain(acc, delta, size, count), 6),
        ("torch.add", lambda: torch.add(acc, delta, out=out), 1),
        ("chain: torch.add + 5 sum launches", chain, 6),
        ("stream handle: torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream, 1),
        ("stream handle: torch._C._cuda_getCurrentRawStream(0)",
         lambda: raw(0), 1),
    ]
    t = three_times([(f"{c[0]} P={p}",) + c[1:] for c in cases], 2000)
    kernel, plain = t[f"{label} P={p}"], t[f"{label} plain P={p}"]
    library = t[f"torch.add P={p}"]
    chain_t = t[f"chain: torch.add + 5 sum launches P={p}"]
    # Two tables read, one written, two scalars read and written.  One add
    # per cell, and the sums' three adds per row.
    nbytes = 3 * 8 * 7 * p + 2 * 2 * 8
    ops = 7 * p + 3 * p
    bound_ms, bound_by = bound(nbytes, ops)
    row = {
        "name": "counters_merge",
        "route": "cuda",
        "source": "kafka_topic_analyzer_tpu_torch/csrc/counters_merge.cu",
        "replaces": "kafka_topic_analyzer_tpu/ops/pallas_counters.py:216",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel["ms"],
        "plain_ms": plain["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library["ms"],
        "device_ms": kernel["device_ms"],
        "host_us": kernel["host_us"],
        "chain_ms": chain_t["ms"],
    }
    print(
        f"kernel: {label} P={p}: {kernel['ms']:.6f} ms, plain "
        f"{plain['ms']:.6f} ms, torch.add {library['ms']:.6f} ms, chain "
        f"{chain_t['ms']:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} B); host "
        f"{kernel['host_us']:.3f} us/call against torch.add's "
        f"{library['host_us']:.3f} ({kernel['host_us'] / library['host_us']:.3f}x)"
    )
    return row


def update_inputs(torch, np, p: int, b: int, rng, order: str = "random"):
    """The wire-v4 update's inputs on the card: int32 partition, key and
    value lengths (key lengths over the whole u16 range, value lengths up
    to the reference's 2^24 - 1 cap, some at it), bool flags.  ``order``:
    ``random`` partitions with a valid prefix of 90% of the records (an
    invalid tail); ``round-robin``, the scan's own record order, and
    ``runs``, runs of one partition as a Kafka fetch delivers them, both
    with a full batch."""
    if order == "random":
        partition = rng.integers(0, p, size=b, dtype=np.int32)
        valid = np.arange(b) < (b * 9) // 10
    else:
        partition = (
            np.arange(b) % p if order == "round-robin" else np.arange(b) * p // b
        ).astype(np.int32)
        valid = np.ones(b, dtype=bool)
    value_len = rng.integers(0, 1 << 24, size=b, dtype=np.int32)
    value_len[:64] = (1 << 24) - 1
    cols = [
        partition,
        rng.integers(0, 1 << 16, size=b, dtype=np.int32),
        value_len,
        rng.random(b) < 0.1,
        rng.random(b) < 0.15,
        valid,
    ]
    per = rng.integers(-(1 << 62), 1 << 62, size=(p, 7), dtype=np.int64)
    return torch.from_numpy(per).cuda(), [torch.from_numpy(c).cuda() for c in cols]


ORDERS = ("random", "round-robin", "runs")


def phase_update_kernel(torch, np, cu) -> dict:
    """``counters_update`` against its plain version, global sums included,
    in every record order, then its times at the scan's shape."""
    rng = np.random.default_rng(20261017)
    b = 1 << 18
    worst = 0
    for p in (1, 16, 300, 877, 4096, 32767):
        for order in ORDERS:
            per, cols = update_inputs(torch, np, p, b, rng, order)
            want_sums, got_sums = scalars(torch), scalars(torch)
            want = cu.counters_update_plain(per, *cols, p, *want_sums)
            got = cu.counters_update(per.clone(), *cols, p, *got_sums)
            torch.cuda.synchronize()
            err = int((got - want).abs().max().item())
            sums = [(int(w), int(g)) for w, g in zip(want_sums, got_sums)]
            print(f"kernel: counters_update P={p} B={b} {order}: "
                  f"max_abs_err={err}, sums (plain, kernel) {sums}")
            if not torch.equal(got, want):
                fail(f"counters_update disagrees with its plain version at "
                     f"P={p} in {order} order")
            if any(w != g for w, g in sums):
                fail(f"counters_update's global sums disagree at P={p} in "
                     f"{order} order: {sums}")
            worst = max(worst, err)

    p = 16  # the scan phase's shape and record order
    size, count = scalars(torch)
    label = "counters_update+sums"
    inputs = {order: update_inputs(torch, np, p, b, rng, order)
              for order in ("round-robin", "runs", "random")}
    per, cols = inputs["round-robin"]
    partition, key_len, value_len, key_null, value_null, valid = cols
    # The library yardstick: one index_add_ of the prebuilt contributions
    # (what the plain version computes before its add), never called by
    # the port.
    kn, vn = valid & ~key_null, valid & ~value_null
    contrib = torch.stack(
        [valid, valid & value_null, vn, valid & key_null, kn,
         torch.zeros_like(valid), torch.zeros_like(valid)], dim=1,
    ).to(torch.int64)
    contrib[:, 5] = torch.where(kn, key_len, 0)
    contrib[:, 6] = torch.where(vn, value_len, 0)
    idx = torch.where(valid, partition.to(torch.int64), p)
    acc = torch.zeros((p + 1, 7), dtype=torch.int64, device=per.device)

    def kernel_on(order):
        # Explicit arguments, as the step passes them.
        per, (c0, c1, c2, c3, c4, c5) = inputs[order]
        return lambda: cu.counters_update(
            per, c0, c1, c2, c3, c4, c5, p,
            overall_size=size, overall_count=count,
        )

    t = three_times([
        (f"{label} P={p} B={b} round-robin", kernel_on("round-robin"), 1),
        (f"{label} P={p} B={b} runs", kernel_on("runs"), 1),
        (f"{label} P={p} B={b} random", kernel_on("random"), 1),
        (f"{label} plain P={p} B={b} round-robin",
         lambda: cu.counters_update_plain(per, *cols, p, size, count), 25),
        (f"index_add_ of a prebuilt [B, 7] P={p} B={b}",
         lambda: acc.index_add_(0, idx, contrib), 1),
    ], 500)
    times = {order: t[f"{label} P={p} B={b} {order}"]
             for order in ("round-robin", "runs", "random")}
    plain = t[f"{label} plain P={p} B={b} round-robin"]
    library = t[f"index_add_ of a prebuilt [B, 7] P={p} B={b}"]
    # Each column read once (three int32, three bool), the table and the
    # two scalars read and written once; seven integer adds per record, and
    # three more for the sums.
    nbytes = b * (3 * 4 + 3 * 1) + 2 * 8 * 7 * p + 2 * 2 * 8
    ops = 7 * b + 3 * b
    bound_ms, bound_by = bound(nbytes, ops)
    kernel = times["round-robin"]
    row = {
        "name": "counters_update",
        "route": "cuda",
        "source": "kafka_topic_analyzer_tpu_torch/csrc/counters_update.cu",
        "replaces": "kafka_topic_analyzer_tpu/ops/pallas_counters.py:52",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel["ms"],
        "plain_ms": plain["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library["ms"],
        "device_ms": kernel["device_ms"],
        "host_us": kernel["host_us"],
    }
    print(
        f"kernel: {label} P={p} B={b}: {kernel['ms']:.6f} ms (runs of one "
        f"partition {times['runs']['ms']:.6f} ms, random order "
        f"{times['random']['ms']:.6f} ms), plain {plain['ms']:.6f} ms, "
        f"index_add_ {library['ms']:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} "
        f"B, {ops} adds); device {kernel['device_ms']:.6f} ms = "
        f"{bound_ms / kernel['device_ms']:.4f} of the bound"
    )
    return row


def run_cli(cli, argv):
    """The port's CLI on ``argv`` (``cli.run``, what ``main`` runs, with
    ``--quiet``): (stdout, the scan's result); fails on a non-zero
    exit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, result = cli.run(cli.build_parser().parse_args(argv + ["--quiet"]))
    if rc != 0:
        fail(f"CLI {' '.join(argv)} exited {rc}")
    return buf.getvalue(), result


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def zero(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def identity_run(cli, kernels, phase: str, label: str, argv, device: str,
                 kernel) -> "tuple[str, object]":
    """One identity run of the port's CLI with the torch backend on
    ``device`` (``cuda``, or ``cpu``: the same code on the host): (the
    report without its timing lines, the scan's result); fails when a cuda
    run did not launch exactly its format's kernel."""
    zero(kernels)
    t0 = time.perf_counter()
    out, result = run_cli(cli, argv + ["--backend", "gpu", "--device", device])
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"{phase}: {label} on {device}: {secs:.3f} s, launches {launches}, "
          f"fused {result.fused}, fallbacks {result.fallbacks}")
    for name, n in launches.items():
        if (name == kernel) != (n > 0):
            fail(f"{phase}: {label} on {device} launched {name} {n} times")
    return drop_timing(out), result


def spec_of(text: str):
    from kafka_topic_analyzer_tpu_torch.cli import parse_kv_pairs
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSpec

    return SyntheticSpec.from_kv(parse_kv_pairs(text))


def write_dump(topic: str, spec_text: str) -> str:
    """A ``.ktaseg`` dump of ``spec_text`` for ``topic``, written by the
    port's ``make_segments`` with the native shim; returns its
    directory."""
    from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

    out = DUMP_ROOT / f"{topic}-{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    paths = make_segments(str(out), topic, spec_of(spec_text), use_native=True)
    nbytes = sum(os.path.getsize(p) for p in paths)
    print(f"dump: {spec_text}: {len(paths)} files, {nbytes} B in "
          f"{time.perf_counter() - t0:.3f} s")
    return str(out)


def phase_identity(cli, kernels) -> None:
    """CLI runs of one topic, synthetic and from a segment dump, fused
    and chained, native on and off; every report must equal the first
    (timing lines aside) and every gpu run must launch its wire format's
    kernel and not the other."""
    synthetic = ["-t", "smoke", "--source", "synthetic", "--synthetic",
                 IDENTITY_SPEC, *SKETCH_FLAGS]
    dump = write_dump("smoke", IDENTITY_SPEC)
    segments = ["-t", "smoke", "--source", "segfile", "--segment-dir", dump,
                *SKETCH_FLAGS]
    v4 = ["--wire-format", "v4"]
    runs = []
    for native in ("on", "off"):
        nat = ["--native", native]
        runs += [
            (f"synthetic v5 native {native}", synthetic + nat, "cuda", "counters_merge"),
            (f"synthetic v5 native {native}", synthetic + nat, "cpu", None),
            (f"synthetic v4 native {native}", synthetic + v4 + nat, "cuda",
             "counters_update"),
            (f"synthetic v4 native {native}", synthetic + v4 + nat, "cpu", None),
            (f"synthetic v5 compaction off native {native}",
             synthetic + ["--alive-compaction", "off"] + nat, "cuda", "counters_merge"),
        ]
    for native, path in (("on", "fused"), ("off", "chained")):
        nat = ["--native", native]
        runs += [
            (f"segfile v5 {path}", segments + nat, "cuda", "counters_merge"),
            (f"segfile v5 {path}", segments + nat, "cpu", None),
            (f"segfile v4 {path}", segments + v4 + nat, "cuda", "counters_update"),
            (f"segfile v4 {path}", segments + v4 + nat, "cpu", None),
        ]
    first = None
    try:
        for label, argv, device, kernel in runs:
            out, _ = identity_run(cli, kernels, "identity", label, argv, device, kernel)
            if first is None:
                first = out
            elif out != first:
                fail(f"identity: the {label} report on {device} differs from "
                     f"the synthetic v5 cuda report:\n{first}\n{out}")
    finally:
        shutil.rmtree(dump, ignore_errors=True)
    print(f"identity: {len(runs)} reports byte-identical (synthetic and segfile, "
          "fused and chained, native on and off, v5, v4 and compaction off, "
          "cuda and cpu; timing lines aside)")


def host_alive_keys(np, spec_text: str, partition_order: bool) -> int:
    """Alive keys of the spec's records replayed last-writer-wins per
    2^32-slot bitmap slot (the key's fnv32) with numpy, in the synthetic
    source's interleaved order or one partition after the other."""
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource

    src = SyntheticSource(spec_of(spec_text))
    start_at = {p: 0 for p in src.partitions()} if partition_order else None
    slots, alive = [], []
    for b in src.batches(1 << 20, start_at=start_at):
        keyed = ~b.key_null
        slots.append(b.key_hash32[keyed])
        alive.append(~b.value_null[keyed])
    _, last = np.unique(np.concatenate(slots)[::-1], return_index=True)
    return int(np.count_nonzero(np.concatenate(alive)[::-1][last]))


def drop_alive_keys(report: str) -> str:
    return "".join(line for line in report.splitlines(keepends=True)
                   if not line.startswith("Alive keys:"))


def phase_scan(torch, np, cli, kernels, label, argv, kernel,
               per_partition=FULL_MESSAGES, kind="synthetic"):
    """One full-size scan on the card of ``per_partition`` records in each
    partition; returns (launches of ``kernel``, the report without its
    timing lines, the scan's result)."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.report import render_report

    args = cli.build_parser().parse_args(
        ["-t", "scan", *argv, *SKETCH_FLAGS, "--native", "on", "--device", "cuda"]
    )
    source, config, use_native = cli.setup(args)
    backend = TorchBackend(config, device=args.device, use_native=use_native)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(kernels)
    t0 = time.perf_counter()
    result = run_scan(args.topic, source, backend, args.batch_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    m = result.metrics
    records = source.total_records()
    words = backend.state.alive.words
    print(f"scan {label}: {records} records in {wall:.3f} s = "
          f"{records / wall:.1f} records/s; {backend.dispatches} dispatches "
          f"(fused rows: {result.fused}), kernel launches {launches}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; pinned "
          f"staging ring {backend.ring_nbytes} B per ingest stream")
    report = render_report(
        args.topic, m, result.start_offsets, result.end_offsets,
        result.duration_secs, show_alive_keys=True,
    )
    sys.stdout.write(report)
    want = len(m.partitions) * per_partition
    if m.overall_count != want or records != want or result.records != want:
        fail(f"scan {label}: overall_count {m.overall_count}, folded "
             f"{result.records}, expected {want}")
    if any(m.total(p) != per_partition for p in m.partitions):
        fail(f"scan {label}: a partition total is not {per_partition}")
    if words.device.type != "cuda" or words.numel() != 1 << (ALIVE_BITS - 5):
        fail(f"scan {label}: alive bitmap is {words.numel()} words on "
             f"{words.device}")
    n = launches[kernel]
    if not (n > 0 and n == backend.dispatches):
        fail(f"scan {label}: {n} {kernel} launches for {backend.dispatches} "
             "dispatches")
    if any(v for name, v in launches.items() if name != kernel):
        fail(f"scan {label}: launched a kernel of the other wire format: "
             f"{launches}")
    hll = m.distinct_keys_hll_per_partition
    if not (m.alive_keys and all(math.isfinite(h) and h > 0 for h in hll)):
        fail(f"scan {label}: alive keys or HLL estimates missing")
    if int(np.sum(m.per_partition[:, 2])) < m.alive_keys:
        fail(f"scan {label}: more alive keys than alive records")
    breakdown(torch, source, config, wall, backend.dispatches, label, kind, records)
    if hasattr(source, "close"):
        source.close()
    return n, drop_timing(report), result


def breakdown(torch, source, config, wall: float, dispatches: int,
              label: str, kind: str, records: int) -> None:
    """Per-dispatch cost of each stage of the scan, over the scan's first
    rows: host stages on the host clock (mean of 4), the host→device copy
    and the device fold with CUDA events (on a second backend, so the
    scan's state is untouched), after one row or batch of warm-up.  The
    synthetic scan's host stages are
    generation and packing (``prepare``: pack, pair table, copy start);
    the fused segment-file scan's is one: reading the mapped columns and
    packing them into a row (the pages are in the page cache, written by
    this run), timed on freshly mapped files and on files already mapped,
    and under compaction the stage's pair table after it.  The fused Kafka
    scan's are the wait for each fetch response (`kafka_timings`), the
    fused decode→pack of its record sets into rows, the rest of the
    worker's loop (response parsing, the send-ahead's header scan,
    bookkeeping), and under compaction the stage's pair table."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.engine import PartitionIndex
    from kafka_topic_analyzer_tpu_torch.packing import FusedPackSink

    backend = TorchBackend(config, device="cuda", use_native=True)
    b = config.batch_size
    if kind == "kafka":
        dense_of = PartitionIndex(source.partitions()).dense_of
        host, row = kafka_timings(source, config, dense_of)
    elif kind == "segfile":
        from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource

        dense_of = PartitionIndex(source.partitions()).dense_of
        times = {}
        # The scan's own source has its files mapped already; a fresh
        # source maps them anew, so its reads fault every page in (from
        # the page cache), as the scan's first pass did.
        for mapping, src in (("fresh mapping", SegmentFileSource(source.store, source.topic)),
                             ("mapped", source)):
            rows = src.batches(b, sink=FusedPackSink(config, b, dense_of))
            next(rows)
            t0 = time.perf_counter()
            for _ in range(4):
                row = next(rows)
            times[mapping] = (time.perf_counter() - t0) * 1e3 / 4
            rows.close()
        host = "host read+pack " + ", ".join(
            f"{ms:.3f} ms ({mapping})" for mapping, ms in times.items())
    if kind in ("kafka", "segfile"):
        if config.compact_alive:
            # What the stage callback adds on the worker: the row's pairs
            # merged into the slot's pair table.
            from kafka_topic_analyzer_tpu_torch.packing import pack_pair_table

            t0 = time.perf_counter()
            for _ in range(4):
                pack_pair_table([row.pairs], config, backend._pair_cap, use_native=True)
            host += (f", pair table {(time.perf_counter() - t0) * 1e3 / 4:.3f} ms "
                     f"({len(row.pairs[0])} pairs)")
        staged_rows = source.batches(b, sink=backend.make_fused_sink(dense_of))
        staged = next(staged_rows).staged
        staged_rows.close()
    else:
        batches = source.batches(b)
        backend.prepare(next(batches))
        synth_s = prepare_s = 0.0
        for _ in range(4):
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            staged = backend.prepare(batch)
            synth_s += t1 - t0
            prepare_s += time.perf_counter() - t1
        host = (f"host synth {synth_s * 1e3 / 4:.3f} ms, host pack "
                f"{prepare_s * 1e3 / 4:.3f} ms")
        if config.compact_alive:
            # The pack's two halves on the same batch: the row, and the
            # dedupe + pair table.
            from kafka_topic_analyzer_tpu_torch.packing import (
                batch_alive_pairs,
                pack_batch,
                pack_pair_table,
            )

            t0 = time.perf_counter()
            for _ in range(4):
                pack_batch(batch, config, use_native=True)
            t1 = time.perf_counter()
            for _ in range(4):
                pack_pair_table([batch_alive_pairs(batch, config, True)], config,
                                backend._pair_cap, use_native=True)
            host += (f" (row {(t1 - t0) * 1e3 / 4:.3f} ms, dedupe + pair table "
                     f"{(time.perf_counter() - t1) * 1e3 / 4:.3f} ms)")
    torch.cuda.synchronize()
    slot = torch.empty(backend._nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty_like(slot, device="cuda")
    copy_ms = cuda_ms(lambda: dev.copy_(slot, non_blocking=True), 20, 2)
    fold_ms = cuda_ms(lambda: backend.update(staged), 20, 2)
    per_dispatch_ms = wall * 1e3 / dispatches
    DEVICE_MS[label] = copy_ms + fold_ms
    BUSY_SHARE[label] = (copy_ms + fold_ms) / per_dispatch_ms
    print(
        f"breakdown {label}: per dispatch of {b} records: wall "
        f"{per_dispatch_ms:.3f} ms; {host}; device copy {copy_ms:.3f} ms "
        f"({slot.numel()} B), device fold {fold_ms:.3f} ms; device busy "
        f"share ~{BUSY_SHARE[label]:.4f}; {records / wall:.1f} records/s"
    )


def kafka_timings(source, config, dense_of) -> "tuple[str, object]":
    """The fused Kafka scan's worker, row by row, on a fresh stream of the
    scan's source (one leader, so the worker reads, decodes and packs in
    turn): the host ms per row spent waiting for fetch responses
    (``BrokerConnection.read_response``), in the fused decode→pack of
    their record sets (``FusedPackSink.append_record_set``) and in the
    rest of the loop, over 4 rows after one of warm-up.  Returns the text
    and the last row."""
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import BrokerConnection
    from kafka_topic_analyzer_tpu_torch.packing import FusedPackSink

    spent = {"wait": 0.0, "pack": 0.0}
    read = BrokerConnection.read_response

    def timed_read(self, corr):
        t0 = time.perf_counter()
        try:
            return read(self, corr)
        finally:
            spent["wait"] += time.perf_counter() - t0

    class TimedSink(FusedPackSink):
        def append_record_set(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return super().append_record_set(*args, **kw)
            finally:
                spent["pack"] += time.perf_counter() - t0

    b = config.batch_size
    BrokerConnection.read_response = timed_read
    try:
        rows = source.batches(b, sink=TimedSink(config, b, dense_of))
        next(rows)
        spent.update(wait=0.0, pack=0.0)
        t0 = time.perf_counter()
        for _ in range(4):
            row = next(rows)
        total = (time.perf_counter() - t0) * 1e3 / 4
        rows.close()
    finally:
        BrokerConnection.read_response = read
    wait, pack = spent["wait"] * 1e3 / 4, spent["pack"] * 1e3 / 4
    return (f"host worker {total:.3f} ms per row: fetch wait {wait:.3f} ms, "
            f"decode→pack {pack:.3f} ms, rest {total - wait - pack:.3f} ms"), row


def template_expectations(np, spec: dict) -> dict:
    """What a scan of a `tools.bench_e2e` template topic must report,
    computed with numpy from the templates' records (decoded by the
    codec's Python decoder, not the native one the scan runs): each
    partition's counters, time and size extremes, and the alive keys of
    a last-writer-wins replay of one partition's records over the 2^32
    slots of the keys' fnv32.  Every partition holds the same records
    (window ``w`` is template ``w % n_templates``), so each key's last
    write is the same in every partition and the count does not depend
    on the order in which fetches of different partitions arrive."""
    from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
    from kafka_topic_analyzer_tpu_torch.ops.fnv import fnv1a32_ref_batch
    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import build_templates

    templates = build_templates(spec["R"], spec["n_templates"], spec["vmin"],
                                spec["vmax"], tombstone_every=spec["tombstone_every"])
    cols = []
    for t in templates:
        recs = [r for _, r in kc.decode_record_batches(t)]
        keys = [k for _, k, _ in recs]
        lengths = np.array([len(k) for k in keys])
        padded = np.zeros((len(keys), lengths.max()), dtype=np.uint8)
        for i, k in enumerate(keys):
            padded[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
        cols.append(dict(
            ts_s=np.array([ts for ts, _, _ in recs]) // 1000,
            key_len=lengths,
            value_len=np.array([len(v or b"") for _, _, v in recs]),
            tombstone=np.array([v is None for _, _, v in recs]),
            slot=fnv1a32_ref_batch(padded, lengths),
        ))
    window = [cols[w % len(cols)] for w in range(spec["windows"])]
    cat = {k: np.concatenate([c[k] for c in window]) for k in window[0]}
    alive = ~cat["tombstone"]
    size = (cat["key_len"] + cat["value_len"])[alive]
    _, last = np.unique(cat["slot"][::-1], return_index=True)
    return dict(
        total=len(alive), tombstones=int(cat["tombstone"].sum()),
        alive=int(alive.sum()), key_null=0, key_non_null=len(alive),
        key_size_sum=int(cat["key_len"].sum()),
        value_size_sum=int(cat["value_len"].sum()),
        earliest=int(cat["ts_s"].min()), latest=int(cat["ts_s"].max()),
        smallest=int(size.min()), largest=int(size.max()),
        alive_keys=int(np.count_nonzero(alive[::-1][last])),
    )


def check_template_scan(np, label: str, m, want: dict) -> None:
    """Every exact line of a template-topic scan against numpy's values."""
    from kafka_topic_analyzer_tpu_torch.results import COUNTER_CHANNELS

    def avg(total, alive):
        return total // alive if total > 0 and alive > 0 else 0

    got = {}
    for i, name in enumerate(COUNTER_CHANNELS):
        col = {int(v) for v in m.per_partition[:, i]}
        got[name] = col.pop() if len(col) == 1 else col
    ext = m.per_partition_extremes
    for i, name in enumerate(("earliest", "latest", "smallest", "largest")):
        col = {int(v) for v in ext[:, i]}
        got[name] = col.pop() if len(col) == 1 else col
    got["alive_keys"] = m.alive_keys
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    p = len(m.partitions)
    for name, value, expect in (
        ("overall_count", m.overall_count, p * want["total"]),
        ("earliest message", m.earliest_ts_s, want["earliest"]),
        ("latest message", m.latest_ts_s, want["latest"]),
        ("smallest message", m.smallest_message, want["smallest"]),
        ("largest message", m.largest_message, want["largest"]),
        ("key size avg", m.key_size_avg(m.partitions[0]),
         avg(want["key_size_sum"], want["alive"])),
        ("value size avg", m.value_size_avg(m.partitions[0]),
         avg(want["value_size_sum"], want["alive"])),
        ("message size avg", m.message_size_avg(m.partitions[0]),
         avg(want["key_size_sum"] + want["value_size_sum"], want["alive"])),
    ):
        if value != expect:
            bad[name] = (value, expect)
    if bad:
        fail(f"scan {label}: (got, numpy) differ: {bad}")
    print(f"scan {label}: every exact metric equals numpy's from the templates "
          f"({want})")


def phase_kafka_identity(np, cli, kernels) -> None:
    """The identity topic served by three template brokers (uncompressed,
    lz4, zstd): every report must be byte-identical across cuda and cpu,
    v5, v4 and compaction off, fused and chained, the compressed topics,
    and the segment-file scan of a ``--dump-segments`` dump."""
    from kafka_topic_analyzer_tpu_torch.io import compression, kafka_codec as kc
    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import BrokerProcess

    spec = KAFKA_IDENTITY
    n = spec["partitions"] * spec["windows"] * spec["R"]
    want = template_expectations(np, spec)
    zstd = "libzstd" if compression._load_libzstd() is not None else \
        "zstd_py (pure Python)"
    dump = DUMP_ROOT / f"kafka-{os.getpid()}"
    shutil.rmtree(dump, ignore_errors=True)
    first = None
    count = 0

    def same(label, out):
        nonlocal first, count
        count += 1
        if first is None:
            first = out
        elif out != first:
            fail(f"kafka identity: the {label} report differs from the first:\n"
                 f"{first}\n{out}")

    with contextlib.ExitStack() as stack:
        ports = {name: stack.enter_context(BrokerProcess(**spec, compression=codec))
                 for name, codec in (("none", kc.COMPRESSION_NONE),
                                     ("lz4", kc.COMPRESSION_LZ4),
                                     ("zstd", kc.COMPRESSION_ZSTD))}
        stack.callback(shutil.rmtree, dump, True)

        def base(name):
            return ["-t", spec["topic"], "-b", f"127.0.0.1:{ports[name]}", *SKETCH_FLAGS,
                    "--batch-size", str(KAFKA_IDENTITY_BATCH)]

        def run(label, argv, device, kernel):
            return identity_run(cli, kernels, "kafka identity", label, argv, device,
                                kernel)

        for fmt, flags, kernel in (("v5", [], "counters_merge"),
                                   ("v4", ["--wire-format", "v4"], "counters_update"),
                                   ("v5 compaction off", ["--alive-compaction", "off"],
                                    "counters_merge")):
            for native_flag, path in (("on", "fused"), ("off", "chained")):
                for device in ("cuda", "cpu"):
                    label = f"{fmt} {path}"
                    out, result = run(label, base("none") + flags + ["--native", native_flag],
                                      device, kernel if device == "cuda" else None)
                    if result.fused != (path == "fused") or result.fallbacks:
                        fail(f"kafka identity: {label} on {device}: fused "
                             f"{result.fused}, fallbacks {result.fallbacks}")
                    if result.records != n:
                        fail(f"kafka identity: {label}: {result.records} records, not {n}")
                    same(f"{label} on {device}", out)
        for name in ("lz4", "zstd"):
            out, result = run(f"v5 fused {name}", base(name) + ["--native", "on"], "cuda",
                              "counters_merge")
            if result.fallbacks != {"compressed": n}:
                fail(f"kafka identity: {name}: fallbacks {result.fallbacks}, expected "
                     f"{{'compressed': {n}}}")
            print(f"kafka identity: {name} topic: fallbacks {result.fallbacks} "
                  f"(decoder: {'native shim' if name == 'lz4' else zstd})")
            same(f"v5 fused {name}", out)
        out, result = run("v5 with --dump-segments",
                          base("none") + ["--native", "on", "--dump-segments", str(dump)],
                          "cuda", "counters_merge")
        same("v5 with --dump-segments", out)
        for native_flag in ("on", "off"):
            label = f"segfile of the dump, native {native_flag}"
            out, result = run(label, ["-t", spec["topic"], "--source", "segfile",
                                      "--segment-dir", str(dump), *SKETCH_FLAGS,
                                      "--batch-size", str(KAFKA_IDENTITY_BATCH),
                                      "--native", native_flag], "cuda", "counters_merge")
            same(label, out)
        check_template_scan(np, "kafka identity", result.metrics, want)
        phase_oracle(cli, kernels, ports, spec["topic"])
    print(f"kafka identity: {count} reports byte-identical (cuda and cpu; v5, v4 and "
          f"compaction off; fused and chained; uncompressed, lz4 and zstd via {zstd}; "
          "the segment-file scan of a --dump-segments dump; timing lines aside)")


def sketch_free(report: str) -> str:
    """The report without its sketch lines (HLL or exact distinct keys,
    size quantiles) and timing lines: the lines the oracle and the card
    must print alike."""
    return "".join(
        line for line in drop_timing(report).splitlines(keepends=True)
        if "distinct keys" not in line.lower() and "quantiles:" not in line
    )


def check_sketches(label: str, card, oracle, config) -> None:
    """Each HLL estimate of the card beside the oracle's exact count, and
    each size quantile beside the exact one; fails outside DESIGN.md §7's
    budgets."""
    sigma = 1.04 / math.sqrt(1 << config.hll_p)
    pairs = [("all", card.distinct_keys_hll, oracle.distinct_keys_exact)]
    pairs += [(f"partition {p}", est, exact) for p, est, exact in zip(
        card.partitions, card.distinct_keys_hll_per_partition,
        oracle.distinct_keys_exact_per_partition)]
    for name, est, exact in pairs:
        err = abs(est - exact) / exact
        print(f"oracle {label}: distinct keys {name}: HLL {est:.1f}, exact {exact}, "
              f"relative error {err:.6f} (budget {HLL_SIGMAS * sigma:.6f})")
        if err > HLL_SIGMAS * sigma:
            fail(f"oracle {label}: HLL estimate {est} of {name} outside "
                 f"{HLL_SIGMAS} sigma of the exact {exact}")
    alpha = config.quantile_alpha
    for p, got, want in zip(card.quantiles.probs, card.quantiles.values,
                            oracle.quantiles.values):
        print(f"oracle {label}: size quantile p{int(p * 100)}: DDSketch {got:.3f} B, "
              f"exact {want:.3f} B")
        if abs(got - want) > 2 * alpha * want + 1:
            fail(f"oracle {label}: quantile p{p} {got} outside 2 alpha of {want}")


def phase_oracle(cli, kernels, ports: dict, topic: str) -> None:
    """The numpy exact oracle (``--backend cpu``) against the card
    (``--backend gpu``) on the Kafka identity topic from each of the three
    template brokers: every exact line equal, the sketches within their
    budgets; then an oracle scan in a child process, which must leave CUDA
    uninitialised."""
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig

    for name, port in ports.items():
        argv = ["-t", topic, "-b", f"127.0.0.1:{port}", *ORACLE_FLAGS,
                "--batch-size", str(KAFKA_IDENTITY_BATCH)]
        zero(kernels)
        t0 = time.perf_counter()
        oracle_out, oracle = run_cli(cli, argv + ["--backend", "cpu"])
        oracle_s = time.perf_counter() - t0
        if any(fn.launches for fn in kernels.values()):
            fail(f"oracle {name}: the oracle launched a kernel")
        card_out, card = identity_run(cli, kernels, "oracle", f"{name} topic", argv
                                      + ["--native", "on"], "cuda", "counters_merge")
        print(f"oracle {name}: oracle scan {oracle_s:.3f} s, "
              f"{oracle.records} records")
        if sketch_free(oracle_out) != sketch_free(card_out):
            fail(f"oracle {name}: the exact lines differ:\n{oracle_out}\n{card_out}")
        if "Per-partition extremes:" not in card_out or "Alive keys:" not in card_out:
            fail(f"oracle {name}: the report lacks its extremes table or alive keys")
        check_sketches(name, card.metrics, oracle.metrics, AnalyzerConfig())
    code = (
        "import contextlib, io, sys, torch\n"
        "from kafka_topic_analyzer_tpu_torch import cli\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = cli.main({['-t', topic, '-b', '127.0.0.1:%d' % ports['none'], *ORACLE_FLAGS, '--backend', 'cpu', '--quiet']!r})\n"
        "print(rc, torch.cuda.is_initialized(),\n"
        "      'kafka_topic_analyzer_tpu_torch.backends.gpu' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=300)
    print(f"oracle: child process oracle scan: rc, torch.cuda.is_initialized(), "
          f"torch backend imported: {proc.stdout.strip()}")
    if proc.returncode != 0 or proc.stdout.split() != ["0", "False", "False"]:
        fail(f"oracle: the oracle's child process touched CUDA or failed: "
             f"{proc.stdout} {proc.stderr[-2000:]}")
    print(f"oracle: {len(ports)} topics: the oracle's exact lines equal the card's, "
          "the sketches within DESIGN.md §7's budgets, and CUDA never initialised")


def session_run(cli, kernels, argv, tag: str, telemetry: bool, profile_dir=None):
    """One scan as ``cli.main`` runs it, inside the CLI's telemetry
    session, with ``--stats --flight-record --events-jsonl F --trace-json
    F`` when ``telemetry`` and ``--profile-dir`` when given, from a reset
    registry and zeroed launch counters.  Returns a dict: the result, the
    wall (host clock around ``cli.run``, whose finalize waits for the
    device), records/s, the ``--stats`` text, the doctor's diagnosis (read
    inside the session, as ``--stats`` reads it), the trace and events
    paths and the launches."""
    from kafka_topic_analyzer_tpu_torch.obs import telemetry_session
    from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

    TELEMETRY_ROOT.mkdir(parents=True, exist_ok=True)
    trace = TELEMETRY_ROOT / f"{tag}.trace.json"
    events = TELEMETRY_ROOT / f"{tag}.events.jsonl"
    extra = ["--quiet"]
    if telemetry:
        extra += [*DOCTOR_FLAGS, "--events-jsonl", str(events), "--trace-json", str(trace)]
    if profile_dir is not None:
        extra += ["--profile-dir", str(profile_dir)]
    args = cli.build_parser().parse_args(argv + extra)
    default_registry().reset()
    zero(kernels)
    out, err = io.StringIO(), io.StringIO()
    with telemetry_session(metrics_port=args.metrics_port, events_jsonl=args.events_jsonl,
                           trace_json=args.trace_json, flight_record=args.flight_record):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc, result = cli.run(args)
        wall = time.perf_counter() - t0
        diagnosis = diagnose_scan(result) if telemetry and rc == 0 else None
    if rc != 0:
        fail(f"{tag}: CLI exited {rc}: {err.getvalue()[-2000:]}")
    return dict(result=result, wall=wall, rate=result.records / wall,
                stats=err.getvalue(), stdout=out.getvalue(), diagnosis=diagnosis,
                trace=trace, events=events,
                launches={name: fn.launches for name, fn in kernels.items()})


def stage_seconds(snapshot: dict) -> dict:
    return {s["labels"]["stage"]: s["value"]
            for s in snapshot["kta_stage_seconds_total"]["samples"] if s["value"]}


def metric_total(snapshot: dict, name: str) -> float:
    return sum(s.get("value", 0.0) for s in snapshot[name]["samples"])


def rendered(result) -> str:
    """``result`` rendered as the scan phase renders its report (the
    alive keys shown), timing lines aside."""
    from kafka_topic_analyzer_tpu_torch.report import render_report

    return drop_timing(render_report(
        "scan", result.metrics, result.start_offsets, result.end_offsets,
        result.duration_secs, show_alive_keys=True,
    ))


def check_same_scan(np, phase: str, result, want_report: str, want=None) -> None:
    """Fails unless a scan run with telemetry sinks on gives the report of
    the scan phase's run of the same topic and format, and, for a
    template topic (``want``), its expectations."""
    if rendered(result) != want_report:
        fail(f"{phase}: the report differs from the scan phase's (timing lines "
             f"aside):\n{want_report}\n{rendered(result)}")
    if want is not None:
        check_template_scan(np, phase, result.metrics, want)


def phase_doctor(np, cli, kernels, label: str, argv, kernel: str, want_report: str,
                 want=None) -> dict:
    """A full-size scan with the CLI's telemetry on: prints the scan
    doctor's BOTTLENECK verdict, its stage shares and its throttle-wait,
    fetch and decode evidence; fails unless its report equals the scan
    phase's ``want_report`` (and the template's expectations ``want``),
    the scan booked 62 batches, its format's kernel launched once per
    batch, the trace's stage totals agree with ``--stats`` within 5% (one
    clock writes both) and cover at least 90% of the host wall around
    ``cli.run`` (the rest is set-up: backend, source, watermarks) without
    passing it, and the events open and close the scan."""
    run = session_run(cli, kernels, argv, f"doctor-{label.replace(' ', '-')}", True)
    check_same_scan(np, f"doctor {label}", run["result"], want_report, want)
    snap = run["result"].telemetry
    d = run["diagnosis"]
    for line in run["stats"].splitlines():
        if line.startswith(("BOTTLENECK", "  occupancy", "  evidence", "  windows",
                            "  dispatch:", "scan stages", "  ingest:", "  finalize:")):
            print(f"doctor {label}: {line}")
    ev = d.evidence
    print(f"doctor {label}: verdict {d.verdict}; stage shares "
          + ", ".join(f"{s} {v:.4f}" for s, v in d.stages.items())
          + "; evidence "
          + ", ".join(f"{k} {ev[k]:.4f}" if k in ev else f"{k} n/a"
                      for k in ("throttle_wait", "fetch", "decode"))
          + f"; {run['rate']:.1f} records/s")
    batches = metric_total(snap, "kta_scan_batches_total")
    if batches != 62:
        fail(f"doctor {label}: kta_scan_batches_total {batches}, not 62")
    if run["launches"][kernel] != 62:
        fail(f"doctor {label}: {kernel} launched {run['launches'][kernel]} times, not 62")
    booked = stage_seconds(snap)
    traced: dict = {}
    for e in json.loads(run["trace"].read_text())["traceEvents"]:
        if e.get("cat") == "stage":
            traced[e["name"]] = traced.get(e["name"], 0.0) + e["dur"] / 1e6
    for stage, secs in booked.items():
        got = traced.get(stage, 0.0)
        print(f"doctor {label}: stage {stage}: --stats {secs:.6f} s, trace {got:.6f} s")
        if abs(got - secs) > 0.05 * secs:
            fail(f"doctor {label}: the trace's {stage} total {got} is not within 5% "
                 f"of --stats' {secs}")
    traced_total = sum(traced.values())
    print(f"doctor {label}: the trace's stages {traced_total:.6f} s of the "
          f"{run['wall']:.6f} s host wall around cli.run "
          f"({traced_total / run['wall']:.4f})")
    if not 0.9 * run["wall"] <= traced_total <= run["wall"]:
        fail(f"doctor {label}: the trace's stages {traced_total} s are not within "
             f"90-100% of the {run['wall']} s host wall")
    kinds = [json.loads(line)["type"] for line in run["events"].read_text().splitlines()]
    if not kinds or kinds[0] != "scan_start" or kinds[-1] != "scan_end":
        fail(f"doctor {label}: events {kinds[:3]}...{kinds[-3:]}")
    return {"verdict": d.verdict, "rate": run["rate"]}


def phase_telemetry_cost(np, cli, kernels, argv, want_report: str, want) -> None:
    """The full-size Kafka v5 scan with the doctor's telemetry and
    without, in turns (on, off, on, off): the records/s of each run, and
    each run's report held against the scan phase's."""
    rates = {True: [], False: []}
    for i, on in enumerate((True, False, True, False)):
        run = session_run(cli, kernels, argv, f"cost-{i}", on)
        check_same_scan(np, f"telemetry cost run {i + 1}", run["result"], want_report,
                        want)
        rates[on].append(run["rate"])
        print(f"telemetry cost: run {i + 1}, telemetry {'on' if on else 'off'}: "
              f"{run['result'].records} records in {run['wall']:.3f} s = "
              f"{run['rate']:.1f} records/s")
    on, off = statistics.mean(rates[True]), statistics.mean(rates[False])
    print(f"telemetry cost: mean on {on:.1f} records/s, off {off:.1f} records/s, "
          f"on/off {on / off:.4f}")


def phase_profiler(cli, kernels, label: str, argv, kernel: str) -> None:
    """A full-size scan under ``--profile-dir``: counts each kernel's
    launches (its ``__global__`` name) in the ``torch.profiler`` Chrome
    trace and sums their device time, and sets the device time of all
    kernels and copies against the wall, beside the ``breakdown`` busy
    share of the same scan in this call.  Fails unless the format's kernel
    appears 62 times, except when the trace holds no CUDA activity at all,
    which is printed as a finding."""
    from kafka_topic_analyzer_tpu_torch.utils.profiling import TRACE_FILE, device_events

    directory = TELEMETRY_ROOT / f"profile-{label.replace(' ', '-')}"
    shutil.rmtree(directory, ignore_errors=True)
    run = session_run(cli, kernels, argv, f"profile-{label.replace(' ', '-')}", False,
                      profile_dir=directory)
    path = directory / TRACE_FILE
    events = device_events(str(path))
    for line in run["stats"].splitlines():
        if line.startswith("profile:"):
            print(f"profile {label}: {line}")
    wall_ms = run["wall"] * 1e3
    if not events:
        print(f"profile {label}: FINDING: the trace ({path.stat().st_size} B) holds no "
              f"CUDA activity: torch.profiler could not trace the device here; "
              f"{kernel} launched {run['launches'][kernel]} times by its counter")
        return
    by_name: dict = {}
    for e in events:
        n, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    counts = {}
    for name in ("counters_merge", "counters_update"):
        hits = [(n, ms) for k, (n, ms) in by_name.items() if f"{name}_kernel" in k]
        n = sum(h[0] for h in hits)
        ms = sum(h[1] for h in hits)
        counts[name] = n
        print(f"profile {label}: {name}_kernel ran {n} times, {ms:.6f} ms of device "
              f"time in all" + (f" ({ms / n:.6f} ms per launch)" if n else ""))
    device_ms = sum(e["dur"] for e in events) / 1e3
    cats = {}
    for e in events:
        cats[e["cat"]] = cats.get(e["cat"], 0.0) + e["dur"] / 1e3
    print(f"profile {label}: all device kernels and copies {device_ms:.3f} ms "
          f"({', '.join(f'{c} {ms:.3f} ms' for c, ms in sorted(cats.items()))}) = "
          f"{device_ms / wall_ms:.4f} of the {run['wall']:.3f} s wall under the profiler; "
          f"breakdown busy share ~{BUSY_SHARE.get(label, float('nan')):.4f} (CUDA events, "
          f"this call); {run['rate']:.1f} records/s")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, ms) in top:
        print(f"profile {label}: top device time: {ms:.3f} ms in {n} x {name[:100]}")
    if counts[kernel] != 62:
        fail(f"profile {label}: {kernel}_kernel appears {counts[kernel]} times in the "
             "trace, not 62")
    other = "counters_update" if kernel == "counters_merge" else "counters_merge"
    if counts[other]:
        fail(f"profile {label}: {other}_kernel appears {counts[other]} times")
    shutil.rmtree(directory, ignore_errors=True)


class Interrupt(Exception):
    """A scan's source dying half-way (`Interrupting`)."""


class Interrupting:
    """``inner`` whose every first (not resumed) stream raises `Interrupt`
    after ``limit`` items: a crash mid-scan, in each ingest worker."""

    def __init__(self, inner, limit: int):
        self.inner, self.limit = inner, limit

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batches(self, batch_size, partitions=None, start_at=None, sink=None):
        extra = {"sink": sink} if sink is not None else {}
        for i, item in enumerate(self.inner.batches(batch_size, partitions, start_at,
                                                    **extra)):
            if start_at is None and i >= self.limit:
                raise Interrupt()
            yield item


class Replay:
    """The records of a synthetic spec, per partition (each key's fnv32
    slot, whether it is keyed, whether its value is alive), for numpy
    last-writer-wins replays of the alive-key count in any fan-in order."""

    def __init__(self, np, spec_text: str):
        from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource

        self.np = np
        src = SyntheticSource(spec_of(spec_text))
        self.parts = {}
        for p in src.partitions():
            cols = [(b.key_hash32, ~b.key_null, ~b.value_null)
                    for b in src.batches(1 << 20, partitions=[p])]
            self.parts[p] = tuple(np.concatenate(c) for c in zip(*cols))

    def fanin(self, groups, batch: int, start=None):
        """The records in the order a fan-in of ``groups`` folds them:
        each group's partitions one after the other (from ``start[p]``),
        cut into rows of ``batch`` records, the groups' rows merged
        round-robin (an exhausted group drops out)."""
        np = self.np
        streams = []
        for g in groups:
            cat = tuple(np.concatenate(c) for c in zip(*(
                tuple(a[(start or {}).get(p, 0):] for a in self.parts[p]) for p in g)))
            streams.append([tuple(a[i:i + batch] for a in cat)
                            for i in range(0, len(cat[0]), batch)])
        order = [s[i] for i in range(max(map(len, streams))) for s in streams
                 if i < len(s)]
        return tuple(np.concatenate(c) for c in zip(*order))

    def alive_keys(self, slot, keyed, alive) -> int:
        np = self.np
        _, last = np.unique(slot[keyed][::-1], return_index=True)
        return int(np.count_nonzero(alive[keyed][::-1][last]))


def fanin_groups(source, workers: int):
    """The partition groups of a ``workers``-stream fan-in of ``source``,
    as the engine forms them."""
    from kafka_topic_analyzer_tpu_torch.parallel.ingest import shard_partitions

    return shard_partitions(source.partitions(), workers,
                            weights=source.partition_record_counts())


def snapshot_scan(torch, np, cli, kernels, label: str, argv, kernel: str,
                  want_report: str, total: int, workers: str = "1", cost=False,
                  replay=None, superbatch: str = "1", limit=None) -> int:
    """A full-size scan on the card with snapshots, killed mid-stream
    (each of n ingest streams dies after `INTERRUPT_AFTER` // n rows of
    its own), then resumed
    by a fresh source and backend: the snapshot's ``records_seen`` must
    lie strictly inside the topic, the resumed scan must launch the
    format's kernel (and not the other) fewer than 62 times and fold the
    rest, and its report must be ``want_report``.  Under several workers
    the alive-key line is held instead to ``replay``, a numpy replay of
    the interrupted fan-in's order up to the snapshot and the resumed
    fan-in's after it.  With ``cost``, prints the snapshot's own cost:
    the state's device→host copy and the ``.npz`` write.  With
    ``superbatch`` K the interrupted scan folds K rows per dispatch and
    dies after ``limit`` rows (the resumed one runs at K = 1): its
    failure path folds the pending rows, so the snapshot holds exactly
    ``limit`` rows.  Returns the resumed scan's launches of ``kernel``."""
    from kafka_topic_analyzer_tpu_torch import checkpoint
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

    directory = SNAPSHOT_ROOT / label.replace(" ", "-")
    shutil.rmtree(directory, ignore_errors=True)
    args = cli.build_parser().parse_args(
        ["-t", "scan", *argv, *SKETCH_FLAGS, "--native", "on", "--device", "cuda",
         "--ingest-workers", workers])
    n = cli.resolve_ingest_workers(args, FULL_PARTITIONS)
    killed = cli.build_parser().parse_args(
        ["-t", "scan", *argv, *SKETCH_FLAGS, "--native", "on", "--device", "cuda",
         "--ingest-workers", workers, "--superbatch", superbatch])

    def fresh(flags=args):
        source, config, use_native = cli.setup(flags)
        return source, TorchBackend(config, device="cuda", use_native=use_native,
                                    dispatch=cli.resolve_dispatch(flags))

    source, backend = fresh(killed)
    default_registry().reset()
    t0 = time.perf_counter()
    try:
        # Each of n streams dies half-way through its share of the rows.
        run_scan(args.topic, Interrupting(source, limit or max(1, INTERRUPT_AFTER // n)),
                 backend,
                 args.batch_size, snapshot_dir=str(directory),
                 snapshot_every_s=SNAPSHOT_EVERY_S, ingest_workers=n)
    except Interrupt:
        pass
    else:
        fail(f"snapshot {label}: the interrupted scan ran to its end")
    wall = time.perf_counter() - t0
    telemetry = default_registry().snapshot()
    saved = metric_total(telemetry, "kta_snapshots_saved_total")
    stage = stage_seconds(telemetry).get("snapshot", 0.0)
    info = checkpoint.snapshot_info(str(directory))
    seen = info["records_seen"]
    nbytes = os.path.getsize(directory / checkpoint.SNAPSHOT_NAME)
    if limit is not None and seen != limit * args.batch_size:
        fail(f"snapshot {label}: records_seen {seen}, not the {limit} rows observed "
             f"(the pending superbatch tail was not folded)")
    print(f"snapshot {label}: {n} worker(s), K={backend.superbatch_k}, killed after "
          f"{seen} of {total} records "
          f"in {wall:.3f} s; {saved:.0f} snapshots (every {SNAPSHOT_EVERY_S} s and "
          f"the failure's) in {stage:.3f} s, {stage / max(saved, 1):.3f} s each; "
          f"file {nbytes} B")
    if not 0 < seen < total:
        fail(f"snapshot {label}: records_seen {seen} is not inside (0, {total})")
    if cost:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = backend.get_state()
        t1 = time.perf_counter()
        checkpoint.save_snapshot(str(directory / "cost"), args.topic, backend.config,
                                 leaves, info["next_offsets"], seen, backend.init_now_s)
        t2 = time.perf_counter()
        words = leaves["alive.words"].nbytes
        print(f"snapshot cost {label}: state device→host copy {t1 - t0:.6f} s "
              f"({sum(a.nbytes for a in leaves.values())} B, the alive bitmap "
              f"{words} B, {words / (t1 - t0) / 1e9:.3f} GB/s into pageable memory), "
              f".npz write {t2 - t1:.6f} s "
              f"({os.path.getsize(directory / 'cost' / checkpoint.SNAPSHOT_NAME)} B)")
    if hasattr(source, "close"):
        source.close()
    source, backend = fresh()
    groups = fanin_groups(source, n) if replay is not None else None
    zero(kernels)
    t0 = time.perf_counter()
    result = run_scan(args.topic, source, backend, args.batch_size,
                      snapshot_dir=str(directory), snapshot_every_s=3600.0,
                      resume=True, ingest_workers=n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    if hasattr(source, "close"):
        source.close()
    got = rendered(result)
    print(f"snapshot {label}: resumed, {result.records} records in {wall:.3f} s, "
          f"kernel launches {launches}")
    if result.records + seen != total:
        fail(f"snapshot {label}: resumed {result.records} records after {seen}")
    if not 0 < launches[kernel] < 62 or any(
            v for name, v in launches.items() if name != kernel):
        fail(f"snapshot {label}: resumed scan launched {launches}")
    if replay is None:
        if got != want_report:
            fail(f"snapshot {label}: the resumed report differs from the "
                 f"uninterrupted one:\n{want_report}\n{got}")
        print(f"snapshot {label}: the resumed report equals the uninterrupted "
              "scan's (timing lines aside)")
    else:
        full = replay.fanin(groups, args.batch_size)
        rest = replay.fanin(groups, args.batch_size,
                            start={int(p): o for p, o in info["next_offsets"].items()})
        expect = replay.alive_keys(*(np.concatenate((a[:seen], b))
                                     for a, b in zip(full, rest)))
        alive = result.metrics.alive_keys
        if drop_alive_keys(got) != drop_alive_keys(want_report) or alive != expect:
            fail(f"snapshot {label}: alive keys {alive} (replay {expect}), or another "
                 f"line differs:\n{want_report}\n{got}")
        print(f"snapshot {label}: the resumed report equals the uninterrupted scan's "
              f"but for the alive keys, {alive}, which equal the numpy replay of the "
              f"interrupted and the resumed fan-in orders (uninterrupted "
              f"{replay.alive_keys(*full)})")
    shutil.rmtree(directory, ignore_errors=True)
    return launches[kernel]


def broker_cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of process ``pid`` (all its threads)."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def workers_sweep(np, cli, kernels, label: str, argv, kernel: str, specs,
                  want_report: str, device_ms: float, alive_of=None, want=None,
                  broker_pid=None) -> dict:
    """The CLI's scan of one topic at each ``--ingest-workers`` of
    ``specs``, with the doctor's telemetry on (`session_run`): every
    report line but the alive keys must equal ``want_report`` (the scan
    phase's 1-worker report); the alive keys must equal ``alive_of(n)``
    (a numpy replay in the n-worker fan-in's order), or, where it is None
    (a template topic, whose count no order changes), ``want_report``'s
    and the template's expectations ``want``.  The format's kernel must
    launch 62 to 62 + n - 1 times (each worker's last row is partial), the
    other never.  Prints records/s, the doctor's verdict and stage shares,
    each worker's busy fraction ((active - stalled) / active seconds of
    ``kta_ingest_worker_*``), the device busy share (``device_ms`` per
    launch over the wall: an upper bound, as in §5) and, with
    ``broker_pid``, the broker child's CPU seconds per record and its
    share of one core.  Returns launches and records/s by worker count."""
    out = {}
    for spec in specs:
        cpu0 = broker_cpu_seconds(broker_pid) if broker_pid else None
        run = session_run(cli, kernels, argv + ["--ingest-workers", spec],
                          f"workers-{label.replace(' ', '-')}-{spec}", True)
        result, d = run["result"], run["diagnosis"]
        n = result.ingest_workers
        got = rendered(result)
        if drop_alive_keys(got) != drop_alive_keys(want_report):
            fail(f"workers {label} {spec}: the report differs from the 1-worker "
                 f"scan's beyond the alive keys:\n{want_report}\n{got}")
        alive = result.metrics.alive_keys
        if alive_of is not None:
            expect = alive_of(n)
            if alive != expect:
                fail(f"workers {label} {spec}: {alive} alive keys, the fan-in "
                     f"replay {expect}")
        else:
            check_template_scan(np, f"workers {label} {spec}", result.metrics, want)
        launches = run["launches"]
        if not 62 <= launches[kernel] <= 62 + n - 1 or any(
                v for name, v in launches.items() if name != kernel):
            fail(f"workers {label} {spec}: {n} workers launched {launches}")
        tel = result.telemetry
        active = {s["labels"]["worker"]: s["value"] for s in
                  tel["kta_ingest_worker_active_seconds_total"]["samples"]}
        stall = {s["labels"]["worker"]: s["value"] for s in
                 tel["kta_ingest_worker_stall_seconds_total"]["samples"]}
        busy = {w: (a - stall.get(w, 0.0)) / a for w, a in sorted(active.items()) if a}
        share = device_ms * launches[kernel] / 1e3 / run["wall"]
        line = (f"workers {label} {spec} ({n}): {result.records} records in "
                f"{run['wall']:.3f} s = {run['rate']:.1f} records/s; verdict "
                f"{d.verdict}; stage shares "
                + ", ".join(f"{k} {v:.4f}" for k, v in d.stages.items())
                + "; worker busy " + ", ".join(f"w{w} {b:.4f}" for w, b in busy.items())
                + "; evidence " + ", ".join(
                    f"{k} {d.evidence[k]:.4f}" for k in
                    ("throttle_wait", "fetch", "decode", "worker_busy")
                    if k in d.evidence)
                + f"; device busy share ~{share:.4f}; launches {launches[kernel]}; "
                f"alive keys {alive}"
                + ("" if alive_of is None else f" (fan-in replay {alive_of(n)})"))
        if broker_pid:
            cpu = broker_cpu_seconds(broker_pid) - cpu0
            line += (f"; broker child {cpu:.3f} CPU s = "
                     f"{cpu / result.records * 1e9:.3f} ns per record, "
                     f"{cpu / run['wall']:.4f} of one core")
        print(line)
        out[n] = {"launches": launches[kernel], "rate": run["rate"],
                  "verdict": d.verdict, "alive": alive,
                  "dispatch": d.stages.get("dispatch", 0.0)}
    return out

#: The per-partition table's integer columns and the ``--json`` row keys
#: they print.
TABLE_KEYS = {"< OS": "start_offset", "> OS": "end_offset", "Total": "total",
              "Alive": "alive", "Tmb": "tombstones", "K Null": "key_null",
              "K !Null": "key_non_null", "K-Bytes": "key_size_sum",
              "V-Bytes": "value_size_sum", "A K-Sz": "key_size_avg",
              "A V-Sz": "value_size_avg", "A M-Sz": "message_size_avg"}


def check_json_doc(label: str, doc: dict, report: str, result) -> None:
    """Holds a ``--json`` document against the report printed for the
    same scan: every integer of the per-partition table, the alive keys
    and the overall count, then the whole metrics part against the
    result's own `to_dict`; ``superbatch_k`` must be 4 and the ``flight``
    and ``wire`` blocks present."""
    from kafka_topic_analyzer_tpu_torch.report import TABLE_HEADER

    rows = [line for line in report.splitlines()
            if line.startswith("|") and line.split("|")[1].strip().isdigit()]
    if len(rows) != len(doc["partitions"]):
        fail(f"json {label}: {len(doc['partitions'])} partitions, the report {len(rows)}")
    checked = 0
    for line in rows:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        got = doc["partitions"][cells[0]]
        for name, cell in zip(TABLE_HEADER, cells):
            if name in TABLE_KEYS:
                if int(cell) != got[TABLE_KEYS[name]]:
                    fail(f"json {label}: partition {cells[0]} {name} {cell} in the "
                         f"report, {got[TABLE_KEYS[name]]} in the document")
                checked += 1
    if f"Alive keys: {doc['alive_keys']}\n" not in report:
        fail(f"json {label}: alive keys {doc['alive_keys']} not in the report")
    want = json.loads(json.dumps(result.metrics.to_dict(result.start_offsets,
                                                        result.end_offsets)))
    for key, value in want.items():
        if doc[key] != value:
            fail(f"json {label}: {key} differs from the scan's metrics")
    if doc["overall"]["count"] != result.records or \
            f"Topic Size: {doc['overall']['size_bytes']} bytes\n" not in report:
        fail(f"json {label}: overall count {doc['overall']['count']} or size "
             f"{doc['overall']['size_bytes']} differs from the report")
    if doc["superbatch_k"] != 4 or "flight" not in doc or "wire" not in doc:
        fail(f"json {label}: superbatch_k {doc['superbatch_k']}, keys {sorted(doc)}")
    print(f"json {label}: {checked} table integers, the alive keys and the overall "
          f"count equal the report's; superbatch_k 4; flight verdict "
          f"{doc['flight']['verdict']}; wire {doc['wire']['bytes_total']} B "
          f"({doc['wire']['bytes_per_record']} B/record)")


def superbatch_runs(np, cli, kernels, label: str, argv, kernel: str, specs,
                    want_report: str, k1: dict, alive_of=None, want=None,
                    json_doc: bool = False) -> dict:
    """The CLI's scan of one topic at ``--superbatch 4 --dispatch-depth 2``
    and each ``--ingest-workers`` of ``specs``, with the doctor's
    telemetry on: the report must equal ``want_report`` (the K = 1,
    1-worker scan's; at n workers every line but the alive keys, which
    must equal ``alive_of(n)``, or for a template topic ``want``), the
    format's kernel must launch once per row (62 at one worker) and the
    other never.  Each K = 4 run is followed by a K = 1 run of the same
    flags (held to the same report), so the two are timed in turns on one
    card; prints records/s and the doctor's dispatch share of both,
    beside the workers phase's K = 1 run (``k1``, earlier in the call).
    With
    ``json_doc`` the first run also prints ``--json``, which
    `check_json_doc` holds against its report.  Returns launches and
    records/s by worker count."""
    out = {}
    for i, spec in enumerate(specs):
        flags = argv + SUPERBATCH + ["--ingest-workers", spec]
        if json_doc and i == 0:
            flags = flags + ["--json"]
        run = session_run(cli, kernels, flags,
                          f"superbatch-{label.replace(' ', '-')}-{spec}", True)
        result, d = run["result"], run["diagnosis"]
        n = result.ingest_workers
        got = rendered(result)
        if result.superbatch_k != 4:
            fail(f"superbatch {label} {spec}: K = {result.superbatch_k}")
        if n == 1 and want is None:
            if got != want_report:
                fail(f"superbatch {label} {spec}: the report differs from the K = 1 "
                     f"scan's:\n{want_report}\n{got}")
        else:
            if drop_alive_keys(got) != drop_alive_keys(want_report):
                fail(f"superbatch {label} {spec}: the report differs from the K = 1 "
                     f"scan's beyond the alive keys:\n{want_report}\n{got}")
            if alive_of is not None and result.metrics.alive_keys != alive_of(n):
                fail(f"superbatch {label} {spec}: {result.metrics.alive_keys} alive "
                     f"keys, the fan-in replay {alive_of(n)}")
            if want is not None:
                check_template_scan(np, f"superbatch {label} {spec}", result.metrics, want)
        launches = run["launches"]
        if not 62 <= launches[kernel] <= 62 + n - 1 or (n == 1 and launches[kernel] != 62) \
                or any(v for name, v in launches.items() if name != kernel):
            fail(f"superbatch {label} {spec}: {n} workers launched {launches}")
        dispatches = metric_total(result.telemetry, "kta_stager_slots_total")
        adjacent = session_run(cli, kernels, argv + ["--ingest-workers", spec],
                               f"superbatch-k1-{label.replace(' ', '-')}-{spec}", True)
        if rendered(adjacent["result"]) != got or adjacent["result"].superbatch_k != 1:
            fail(f"superbatch {label} {spec}: the adjacent K = 1 run's report differs")
        d1 = adjacent["diagnosis"]
        base = k1.get(n, {})
        print(f"superbatch {label} {spec} ({n}): K=4 depth 2, {result.records} records in "
              f"{run['wall']:.3f} s = {run['rate']:.1f} records/s (adjacent K=1 "
              f"{adjacent['rate']:.1f}, workers phase K=1 "
              f"{base.get('rate', float('nan')):.1f}); {dispatches:.0f} superbatch "
              f"dispatches, launches {launches[kernel]}; verdict {d.verdict} (adjacent K=1 "
              f"{d1.verdict}); dispatch share {d.stages.get('dispatch', 0.0):.4f} "
              f"(adjacent K=1 {d1.stages.get('dispatch', 0.0):.4f}, workers phase K=1 "
              f"{base.get('dispatch', float('nan')):.4f}); throttle wait "
              f"{d.evidence.get('throttle_wait', 0.0):.4f}; stage shares "
              + ", ".join(f"{k} {v:.4f}" for k, v in d.stages.items())
              + "; adjacent K=1 stage shares "
              + ", ".join(f"{k} {v:.4f}" for k, v in d1.stages.items()))
        if json_doc and i == 0:
            check_json_doc(f"{label} {spec}", json.loads(run["stdout"].splitlines()[-1]),
                           want_report if n == 1 else got, result)
        out[n] = {"launches": launches[kernel], "rate": run["rate"],
                  "dispatch": d.stages.get("dispatch", 0.0),
                  "k1_rate": adjacent["rate"]}
    return out


class ObjectStoreChild:
    """The port's ``tools/objstore_serve`` serving ``root`` from a child
    process on loopback; ``url`` is the store's ``--segment-dir``."""

    def __init__(self, root: str):
        self.root = root

    def __enter__(self) -> str:
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "kafka_topic_analyzer_tpu_torch.tools.objstore_serve",
             "--root", self.root, "--port", "0"],
            stdout=subprocess.PIPE, text=True,
            cwd=str(Path(__file__).resolve().parent))
        line = self._proc.stdout.readline()
        if not line.startswith("objstore_serve: http://"):
            self._proc.kill()
            fail(f"remote: the object-store child announced {line!r}")
        return line.split()[1]

    def __exit__(self, *exc) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()


def remote_digest(telemetry: dict) -> str:
    t = lambda name: metric_total(telemetry, name) if name in telemetry else 0.0  # noqa: E731
    return (f"{t('kta_segstore_gets_total'):.0f} GETs, "
            f"{t('kta_segstore_bytes_fetched_total'):.0f} B fetched, "
            f"{t('kta_segstore_retries_total'):.0f} retries, fetch wait "
            f"{t('kta_fetch_sched_wait_seconds_total'):.3f} s, cache "
            f"{t('kta_segstore_cache_hits_total'):.0f} hits / "
            f"{t('kta_segstore_cache_misses_total'):.0f} misses, verify-latched "
            f"{t('kta_segstore_cache_verify_latched_total'):.0f}, verify "
            f"{t('kta_segstore_cache_verify_seconds_total'):.3f} s")


def remote_run(np, cli, kernels, label: str, argv, kernel: str, want_report: str,
               alive_of, tag: str) -> dict:
    """One CLI scan from the object store with the doctor's telemetry on:
    the report must equal the local segment-file scan's (at n workers all
    but the alive keys, which must equal the fan-in replay), the format's
    kernel must launch 62 times at one worker (62 to 62 + n - 1 at n) and
    the other never.  Prints records/s and the remote tier's digest."""
    run = session_run(cli, kernels, argv, tag, True)
    result = run["result"]
    n = result.ingest_workers
    got = rendered(result)
    if drop_alive_keys(got) != drop_alive_keys(want_report) or (
            n == 1 and got != want_report) or result.metrics.alive_keys != alive_of(n):
        fail(f"remote {label}: the report differs from the local scan's "
             f"(alive keys {result.metrics.alive_keys}, replay {alive_of(n)}):"
             f"\n{want_report}\n{got}")
    launches = run["launches"]
    if not 62 <= launches[kernel] <= 62 + n - 1 or (n == 1 and launches[kernel] != 62) \
            or any(v for name, v in launches.items() if name != kernel):
        fail(f"remote {label}: {n} workers launched {launches}")
    if result.degraded_partitions:
        fail(f"remote {label}: degraded {result.degraded_partitions}")
    print(f"remote {label} ({n}): {result.records} records in {run['wall']:.3f} s = "
          f"{run['rate']:.1f} records/s; launches {launches[kernel]}; verdict "
          f"{run['diagnosis'].verdict}; {remote_digest(result.telemetry)}")
    return {"launches": launches[kernel], "rate": run["rate"],
            "telemetry": result.telemetry}


def phase_remote(np, cli, kernels, dump: str, reports: dict, alive_of) -> dict:
    """The segment-file scans again, from the port's object-store server
    in a child process (``http://127.0.0.1:PORT/segments``): v5 and v4
    at 1 and 7 ingest workers, then v5 at 7 workers cold and warm through
    ``--segment-cache``, then v5 at 7 workers from an in-process server
    that answers the first GET of one chunk with a 503.  Every report
    equals the local scan's.  Returns launches by path."""
    from kafka_topic_analyzer_tpu_torch.io import fetchsched
    from kafka_topic_analyzer_tpu_torch.tools.objstore_serve import ObjectStoreHttpServer

    out = {}
    v4 = ["--wire-format", "v4"]
    shutil.rmtree(CACHE_ROOT, ignore_errors=True)
    with ObjectStoreChild(dump) as url:
        print(f"remote: serving {dump} at {url} from a child process")
        base = ["-t", "scan", "--source", "segfile", "--segment-dir", url, *SKETCH_FLAGS,
                "--native", "on", "--backend", "gpu"]
        for label, fmt, kernel in (("segfile v5", [], "counters_merge"),
                                   ("segfile v4", v4, "counters_update")):
            for spec in SUPERBATCH_WORKERS:
                row = remote_run(np, cli, kernels, f"{label} {spec}",
                                 base + fmt + ["--ingest-workers", spec], kernel,
                                 reports[label], alive_of,
                                 f"remote-{label.replace(' ', '-')}-{spec}")
                out[f"remote {label} {spec} workers"] = (kernel, row["launches"])
        for temp in ("cold", "warm"):
            row = remote_run(np, cli, kernels, f"segfile v5 7 cache {temp}",
                             base + ["--ingest-workers", "7", "--segment-cache",
                                     str(CACHE_ROOT)], "counters_merge",
                             reports["segfile v5"], alive_of, f"remote-cache-{temp}")
            out[f"remote segfile v5 7 workers, cache {temp}"] = (
                "counters_merge", row["launches"])
            tel = row["telemetry"]
            hits = metric_total(tel, "kta_segstore_cache_hits_total")
            if temp == "warm" and not hits:
                fail("remote: the warm cache scan served no chunk from the cache")
    shutil.rmtree(CACHE_ROOT, ignore_errors=True)
    served = []

    def first_get_503(key, rng, index):
        if rng is None and key == "scan-3.ktaseg" and not served:
            served.append(key)
            return ("status", 503)
        return None

    with ObjectStoreHttpServer(dump, fault_hook=first_get_503) as store:
        row = remote_run(np, cli, kernels, "segfile v5 7 one 503",
                         ["-t", "scan", "--source", "segfile", "--segment-dir", store.url,
                          *SKETCH_FLAGS, "--native", "on", "--backend", "gpu",
                          "--ingest-workers", "7"],
                         "counters_merge", reports["segfile v5"], alive_of, "remote-503")
        if not served or not metric_total(row["telemetry"], "kta_segstore_retries_total"):
            fail(f"remote: the scripted 503 was not served and retried ({served})")
        out["remote segfile v5 7 workers, one 503"] = ("counters_merge", row["launches"])
    print(f"remote: every report equals the local segment-file scan's; fetch "
          f"scheduler width {fetchsched.get_scheduler().concurrency}")
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"cannot import torch/numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from kafka_topic_analyzer_tpu_torch import _build, cli
        from kafka_topic_analyzer_tpu_torch.io import native
        from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
        from kafka_topic_analyzer_tpu_torch.ops import counters_merge as cm
        from kafka_topic_analyzer_tpu_torch.ops import counters_update as cu
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__} python {sys.version.split()[0]}; device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"host os.cpu_count() {os.cpu_count()}")

    def timed(build, *args):
        t = time.perf_counter()
        log = build(*args)
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    jobs = {name: (_build.build, name) for name in _build.KERNEL_SOURCES}
    jobs["native ingest shim (g++)"] = (_build.build_native,)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, *job) for name, job in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(built)} libraries, "
          "started together")
    for name, (log, secs) in built.items():
        print(f"build: {name}: {secs:.3f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")
    native.load_library()
    print(f"build: native_status() {native.native_status()}, "
          f"{_build.native_library_path()}")

    kernels = {"counters_merge": cm.counters_merge,
               "counters_update": cu.counters_update}
    merge_row = phase_kernel(torch, np, cm)
    update_row = phase_update_kernel(torch, np, cu)
    phase_identity(cli, kernels)
    synthetic = ["--source", "synthetic", "--synthetic", FULL_SPEC]
    v4 = ["--wire-format", "v4"]
    launches = {"counters_merge": {}, "counters_update": {}}
    reports, alive, verdicts, rates = {}, {}, {}, {}
    for label, argv, kernel in (("v5", synthetic, "counters_merge"),
                                ("v4", synthetic + v4, "counters_update")):
        launches[kernel]["synthetic"], reports[label], result = phase_scan(
            torch, np, cli, kernels, label, argv, kernel)
        alive[label] = result.metrics.alive_keys
    dump = write_dump("scan", FULL_SPEC)
    try:
        segments = ["--source", "segfile", "--segment-dir", dump]
        for label, argv, kernel in (("segfile v5", segments, "counters_merge"),
                                    ("segfile v4", segments + v4, "counters_update")):
            launches[kernel]["segfile"], reports[label], result = phase_scan(
                torch, np, cli, kernels, label, argv, kernel, kind="segfile")
            alive[label] = result.metrics.alive_keys
        cli_segments = ["-t", "scan", *segments, *SKETCH_FLAGS, "--native", "on",
                        "--backend", "gpu"]
        verdicts["segfile v5"] = phase_doctor(np, cli, kernels, "segfile v5",
                                              cli_segments, "counters_merge",
                                              reports["segfile v5"])
        for label, argv, kernel in (("segfile v5", cli_segments, "counters_merge"),
                                    ("segfile v4", cli_segments + v4, "counters_update")):
            phase_profiler(cli, kernels, label, argv, kernel)
        total = FULL_PARTITIONS * FULL_MESSAGES
        t0 = time.perf_counter()
        replay = Replay(np, FULL_SPEC)
        print(f"workers: the spec's records per partition for the fan-in replays in "
              f"{time.perf_counter() - t0:.3f} s")
        for label, argv, kernel, cost in (
                ("segfile v5", segments, "counters_merge", True),
                ("segfile v4", segments + v4, "counters_update", False)):
            launches[kernel]["segfile resumed"] = snapshot_scan(
                torch, np, cli, kernels, label, argv, kernel, reports[label], total,
                cost=cost)
        launches["counters_merge"]["segfile resumed, auto workers"] = snapshot_scan(
            torch, np, cli, kernels, "segfile v5 auto workers", segments,
            "counters_merge", reports["segfile v5"], total, workers="auto",
            replay=replay)
        catalog = SegmentFileSource(dump, topic="scan")
        replayed = {}

        def alive_of(n: int) -> int:
            if n not in replayed:
                replayed[n] = replay.alive_keys(
                    *replay.fanin(fanin_groups(catalog, n), SCAN_BATCH))
            return replayed[n]

        sweeps = {}
        for label, argv, kernel in (("segfile v5", cli_segments, "counters_merge"),
                                    ("segfile v4", cli_segments + v4, "counters_update")):
            sweeps[label] = workers_sweep(np, cli, kernels, label, argv, kernel,
                                          SEGFILE_WORKERS, reports[label],
                                          DEVICE_MS[label], alive_of=alive_of)
            for n, row in sweeps[label].items():
                launches[kernel][f"segfile {n} workers"] = row["launches"]
                rates[f"{label} {n} workers"] = row["rate"]
        for label, argv, kernel in (("segfile v5", cli_segments, "counters_merge"),
                                    ("segfile v4", cli_segments + v4, "counters_update")):
            sweep = superbatch_runs(np, cli, kernels, label, argv, kernel,
                                    SUPERBATCH_WORKERS, reports[label], sweeps[label],
                                    alive_of=alive_of, json_doc=label == "segfile v5")
            for n, row in sweep.items():
                launches[kernel][f"segfile superbatch K=4, {n} workers"] = row["launches"]
                rates[f"{label} superbatch K=4 {n} workers"] = row["rate"]
        launches["counters_merge"]["segfile K=4 killed, resumed at K=1"] = snapshot_scan(
            torch, np, cli, kernels, "segfile v5 superbatch", segments, "counters_merge",
            reports["segfile v5"], total, superbatch="4", limit=SUPERBATCH_KILL_AFTER)
        for path, (kernel, n) in phase_remote(np, cli, kernels, dump, reports,
                                              alive_of).items():
            launches[kernel][path] = n
    finally:
        shutil.rmtree(dump, ignore_errors=True)
        shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
        shutil.rmtree(SNAPSHOT_ROOT, ignore_errors=True)
        shutil.rmtree(CACHE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    want = {order: host_alive_keys(np, FULL_SPEC, order == "partition")
            for order in ("interleaved", "partition")}
    print(f"scan: numpy last-writer-wins replay of the {FULL_SPEC} records: "
          f"{want['interleaved']} alive keys interleaved, {want['partition']} "
          f"one partition after the other ({time.perf_counter() - t0:.3f} s)")
    for label, report in reports.items():
        order = "partition" if label.startswith("segfile") else "interleaved"
        if alive[label] != want[order]:
            fail(f"scan {label}: {alive[label]} alive keys, the {order} replay "
                 f"{want[order]}")
        if drop_alive_keys(report) != drop_alive_keys(reports["v5"]):
            fail(f"scan: the {label} report differs from the synthetic v5 "
                 "report beyond the alive keys (timing lines aside)")
    print("scan: alive keys equal the replay in each scan's order; every other "
          "report line byte-identical across synthetic and segfile, v5 and v4 "
          "(timing lines aside)")
    phase_kafka_identity(np, cli, kernels)
    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import BrokerProcess

    want = template_expectations(np, KAFKA_FULL)
    kafka = {}
    with BrokerProcess(**KAFKA_FULL, compression=0) as port:
        bootstrap = ["-b", f"127.0.0.1:{port}"]
        for label, argv, kernel in (("kafka v5", bootstrap, "counters_merge"),
                                    ("kafka v4", bootstrap + v4, "counters_update")):
            launches[kernel]["kafka"], kafka[label], result = phase_scan(
                torch, np, cli, kernels, label, argv, kernel,
                per_partition=KAFKA_FULL["windows"] * KAFKA_FULL["R"], kind="kafka")
            if not result.fused or result.fallbacks:
                fail(f"scan {label}: fused {result.fused}, fallbacks {result.fallbacks}")
            check_template_scan(np, label, result.metrics, want)
        cli_kafka = ["-t", "scan", *bootstrap, *SKETCH_FLAGS, "--native", "on",
                     "--backend", "gpu"]
        try:
            for label, argv, kernel in (("kafka v5", cli_kafka, "counters_merge"),
                                        ("kafka v4", cli_kafka + v4, "counters_update")):
                verdicts[label] = phase_doctor(np, cli, kernels, label, argv, kernel,
                                               kafka[label], want)
            phase_telemetry_cost(np, cli, kernels, cli_kafka, kafka["kafka v5"], want)
            launches["counters_merge"]["kafka resumed"] = snapshot_scan(
                torch, np, cli, kernels, "kafka v5", bootstrap, "counters_merge",
                kafka["kafka v5"], KAFKA_FULL["partitions"] * KAFKA_FULL["windows"]
                * KAFKA_FULL["R"])
        finally:
            shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
            shutil.rmtree(SNAPSHOT_ROOT, ignore_errors=True)
    broker = BrokerProcess(**KAFKA_FULL, compression=0, brokers=KAFKA_BROKERS)
    with broker as port:
        cli_kafka = ["-t", "scan", "-b", f"127.0.0.1:{port}", *SKETCH_FLAGS,
                     "--native", "on", "--backend", "gpu"]
        try:
            for label, fmt, kernel in (("kafka v5", [], "counters_merge"),
                                       ("kafka v4", v4, "counters_update")):
                sweep = workers_sweep(np, cli, kernels, label, cli_kafka + fmt, kernel,
                                      KAFKA_WORKERS, kafka[label], DEVICE_MS[label],
                                      want=want, broker_pid=broker._proc.pid)
                for n, row in sweep.items():
                    launches[kernel][f"kafka {KAFKA_BROKERS} brokers, {n} workers"] = \
                        row["launches"]
                    rates[f"{label} {n} workers"] = row["rate"]
                    verdicts[f"{label} {n} workers"] = {"verdict": row["verdict"]}
                if label == "kafka v5":
                    k4 = superbatch_runs(np, cli, kernels, label, cli_kafka, kernel, ("7",),
                                         kafka[label], sweep, want=want)
                    for n, row in k4.items():
                        launches[kernel][f"kafka {KAFKA_BROKERS} brokers, superbatch K=4, "
                                         f"{n} workers"] = row["launches"]
                        rates[f"{label} superbatch K=4 {n} workers"] = row["rate"]
        finally:
            shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
    print(f"workers: every N-worker report equals its 1-worker scan's but for the "
          f"alive keys, which equal the fan-in replay (segment files) or the "
          f"1-worker scan's (Kafka templates, whose count no order changes); "
          f"records/s {json.dumps(rates)}")
    print("doctor: " + "; ".join(f"{label} {v['verdict']}" for label, v in verdicts.items()))
    if kafka["kafka v4"] != kafka["kafka v5"]:
        fail("scan: the kafka v4 report differs from the kafka v5 report "
             "(timing lines aside)")
    print("scan: the kafka v5 and v4 reports are byte-identical (timing lines aside)")
    for row in (merge_row, update_row):
        row["launches"] = launches[row["name"]]["kafka"]
        row["launches_by_path"] = launches[row["name"]]
    print(json.dumps({"kernels": [merge_row, update_row]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
